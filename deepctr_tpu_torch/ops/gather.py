"""Multi-table embedding row gather: ``rows[b, f] = tables[f][int(X[b, cols[f]])]``.

The port's counterpart of ``deepctr_tpu/ops/pallas_gather.py``
(``gather_rows``, forward), and of the numerics of both TPU lookup forms
in ``deepctr_tpu/inputs.py`` (one-hot matmuls for small tables, packed
rows with a lane select for big ones): the tables here are logical
``[V, W]`` float32 and the rows come back exact.

``gather_rows`` runs the ``deepctr_tpu_torch::gather_rows`` op
(``ops/library.py``), which launches the CUDA kernel in
``csrc/gather_rows.cu`` for CUDA tensors, or raises, and takes the plain
version ``gather_rows_ref`` only because its tensors lie on the CPU; so
the eager forward, a captured graph and a ``torch.export`` artifact run
the one kernel.  Under autograd, with a table that needs
a gradient, it runs as :class:`GatherRows`, whose backward is
``ops/scatter_add.py:scatter_add_rows`` (the kernel ``csrc/
scatter_add_rows.cu`` on CUDA tensors) into a dense ``[V, W]`` gradient per
table.  The training engine does not go through it: it gathers without a
graph and hands the rows' cotangent to ``scatter_add_rows`` itself, so that
one launch serves dense and touched-rows targets alike.

With ``bases`` the gather runs in its shard-local mode, for tables
row-sharded over a device mesh (``parallel/embedding.py``): field f's table
holds the logical rows ``[bases[f], bases[f] + V_f)``, an id reads its row
there and an id outside that block gives a row of zeros.
"""

import ctypes

import torch

from . import _build
from ._args import DeviceArgs, device_array
from .scatter_add import scatter_add_rows

# the kernel indexes output floats with 32-bit unsigned integers
_MAX_OUTPUT_ELEMENTS = 2 ** 31 - 1


def gather_rows_ref(X, tables, cols, bases=None):
    """Plain PyTorch version: ``index_select`` per field, NaN rows for ids
    outside ``[0, V)``.  X [B, D] float32, tables [V_f, W], cols [F] ->
    [B, F, W].  With ``bases`` [F] (the shard-local mode) field f reads
    id - bases[f] and gives zero rows outside ``[0, V_f)``."""
    rows = []
    fill = float("nan") if bases is None else 0.0
    for f, (table, col) in enumerate(zip(tables, cols)):
        # truncation toward zero, as the JAX package's astype(int32)
        ids = X[:, col].to(torch.int32).to(torch.int64)
        if bases is not None:
            ids = ids - bases[f]
        valid = (ids >= 0) & (ids < table.shape[0])
        picked = table.index_select(0, torch.where(valid, ids, 0))
        rows.append(torch.where(valid[:, None], picked, fill))
    return torch.stack(rows, dim=1)


# the kernel's per-field argument arrays, ``[table addresses | id columns |
# vocab sizes]`` (then ``| row bases]`` in the shard-local mode) as int64
# on the device, by their content: an entry is
# never replaced, so a captured graph that read one keeps reading it, and
# a forward copies nothing to the device but its batch.  One small array
# for each set of tables and columns the process gathers from.
_TABLE_ARGS = DeviceArgs(every_key=True)


def kernel_args(tables, cols, device, bases=None):
    """The kernel's argument array for ``tables`` read at ``cols`` (with
    row ``bases``, 0 without), from the cache (built on first use, which
    raises during a CUDA graph capture), and whether the kernel moves
    their rows in 16-byte units (:func:`vector_rows`)."""
    ptrs = [t.data_ptr() for t in tables]
    vocabs = [t.shape[0] for t in tables]
    bases = [] if bases is None else list(bases)
    key = (torch.device(device), tuple(ptrs), tuple(vocabs), tuple(cols),
           tuple(bases))
    meta = _TABLE_ARGS.get(key, lambda: device_array(
        ptrs + list(cols) + vocabs + bases, torch.int64, device))
    return meta, vector_rows(tables)


def _check(X, tables, cols, bases=None):
    if len(tables) == 0 or len(tables) != len(cols):
        raise ValueError("gather_rows needs one id column per table, got "
                         "%d tables and %d columns" % (len(tables), len(cols)))
    if bases is not None and len(bases) != len(tables):
        raise ValueError("gather_rows needs one row base per table, got %d "
                         "for %d tables" % (len(bases), len(tables)))
    devices = {X.device} | {t.device for t in tables}
    if len(devices) != 1:
        raise ValueError("X and the tables must be on one device, got %s"
                         % sorted(map(str, devices)))
    if X.dim() != 2 or X.dtype != torch.float32:
        raise ValueError("X must be a 2-D float32 matrix, got %s %s"
                         % (X.dtype, tuple(X.shape)))
    width = tables[0].shape[1] if tables[0].dim() == 2 else None
    for t in tables:
        if t.dim() != 2 or t.dtype != torch.float32 or t.shape[1] != width:
            raise ValueError("tables must be 2-D float32 of one width, got "
                             "%s" % [(t.dtype, tuple(t.shape))
                                     for t in tables])
    for c in cols:
        if not 0 <= c < X.shape[1]:
            raise ValueError("id column %r outside X's %d columns"
                             % (c, X.shape[1]))


def vector_rows(tables):
    """Whether the kernel moves the rows of ``tables`` in 16-byte units:
    their width is a multiple of 4 floats and every table starts on a
    16-byte boundary (a contiguous table then has every row aligned)."""
    return (tables[0].shape[1] % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in tables))


_KERNEL = _build.Fn("gather_rows", "gather_rows_f32", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p])


class GatherRows(torch.autograd.Function):
    """``gather_rows`` with a gradient for the tables: the forward is the
    ``deepctr_tpu_torch::gather_rows`` op, the backward adds each ``(b,
    f)`` cotangent into a zero ``[V_f, W]`` gradient of its table with
    :func:`scatter_add_rows` (one launch for every table).  X gets no
    gradient: it carries ids."""

    @staticmethod
    def forward(ctx, X, cols, *tables):
        ctx.save_for_backward(X)
        ctx.cols = list(cols)
        ctx.shapes = [t.shape for t in tables]
        return torch.ops.deepctr_tpu_torch.gather_rows(X, list(tables),
                                                       ctx.cols)

    @staticmethod
    def backward(ctx, grad):
        (X,) = ctx.saved_tensors
        grads = [torch.zeros(s, dtype=torch.float32, device=grad.device)
                 for s in ctx.shapes]
        ids = X[:, ctx.cols].to(torch.int32).to(torch.int64)
        scatter_add_rows(grad, grads, ids)
        return (None, None) + tuple(
            g if need else None
            for g, need in zip(grads, ctx.needs_input_grad[2:]))


def gather_rows(X, tables, cols, bases=None):
    """Rows of every table in one launch: X [B, D] float32 (ids as floats
    at columns ``cols``), tables ``F`` x [V_f, W] float32 -> [B, F, W];
    with ``bases`` the shard-local mode (see the module's docstring).

    Runs the ``deepctr_tpu_torch::gather_rows`` op (``ops/library.py``):
    on CUDA tensors it launches the kernel (building it at first use) or
    raises, on CPU tensors it is the plain version.  With autograd on and a
    table that needs a gradient, the call runs as :class:`GatherRows`; the
    shard-local mode then raises (its gradient is the lookup exchange's,
    ``parallel/embedding.py``)."""
    _check(X, tables, cols, bases)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tables)
    if grad and bases is not None:
        raise ValueError("the shard-local gather takes no table gradient: "
                         "parallel.embedding's lookups carry it")
    if grad:
        return GatherRows.apply(X, list(cols), *tables)
    return torch.ops.deepctr_tpu_torch.gather_rows(
        X, list(tables), list(cols),
        None if bases is None else [int(b) for b in bases])


def launch(X, tables, cols, bases=None):
    """The kernel on CUDA tensors (the op's CUDA implementation): checks
    what the kernel takes, launches it and counts the launch."""
    if X.device.type != "cuda":
        raise ValueError("no gather kernel for device %s" % X.device)
    if X.stride(1) != 1 or any(not t.is_contiguous() for t in tables):
        raise ValueError("gather_rows needs row-major X and contiguous "
                         "tables")
    n_rows, n_fields, width = X.shape[0], len(tables), tables[0].shape[1]
    if n_rows * n_fields * width > _MAX_OUTPUT_ELEMENTS:
        raise ValueError("gather_rows output of %d x %d x %d floats is "
                         "over the kernel's 2**31 limit: split the batch"
                         % (n_rows, n_fields, width))
    out = torch.empty((n_rows, n_fields, width), dtype=torch.float32,
                      device=X.device)
    if n_rows == 0:
        return out
    meta, vector = kernel_args(tables, cols, X.device, bases)
    _KERNEL.launch(X.device, X.data_ptr(), n_rows, X.stride(0),
                   meta.data_ptr(), n_fields, width, int(vector),
                   int(bases is not None), out.data_ptr(),
                   count="gather_rows")
    return out
