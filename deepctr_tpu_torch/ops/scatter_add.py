"""Multi-table scatter-add: ``target_f[rows[b, f]] += grad[b, f]``.

The backward of :func:`~deepctr_tpu_torch.ops.gather.gather_rows`, the
port's counterpart of ``deepctr_tpu/ops/pallas_gather.py:_gather_bwd``
(and ``_gather_packed_bwd``) and of the slice transpose of the JAX
package's active-rows train step (``deepctr_tpu/models/basemodel.py:
733-741``).  One call covers every field of one gather launch; a field's
target is a table's dense ``[V, W]`` gradient indexed by id, or the
``[n_unique, W]`` gradient of the rows a batch touched, indexed by slot.

Each target row sums its contributions in increasing ``b * F + f``, from
the value the target holds: the order of ``index_add_`` on the CPU, which
the plain version ``scatter_add_rows_ref`` uses.  ``scatter_add_rows``
launches the CUDA kernel in ``csrc/scatter_add_rows.cu`` for CUDA tensors,
or raises; it takes the plain version only because its tensors lie on the
CPU.  The kernel equals the plain version bit for bit.
"""

import ctypes

import torch

from . import _build
from ._args import device_array

# kernel launches since import (or since a caller reset it to 0); counts
# only launches of the CUDA kernel, never the plain version
SCATTER_ADD_LAUNCHES = 0


def _groups(targets):
    """Fields grouped by the target they add into: ``[(target, [f, ...])]``
    in order of first use."""
    groups = {}
    for f, t in enumerate(targets):
        groups.setdefault(t.data_ptr(), (t, []))[1].append(f)
    return list(groups.values())


@torch.no_grad()
def scatter_add_rows_ref(grad, targets, rows):
    """Plain PyTorch version: one ``index_add_`` per distinct target, its
    fields' contributions listed in ``(b, f)`` order.  Rows outside
    ``[0, R)`` add nothing.  Adds in place; returns ``targets``."""
    width = grad.shape[2]
    for target, fields in _groups(targets):
        idx = rows[:, fields].reshape(-1)
        src = grad[:, fields].reshape(-1, width)
        valid = (idx >= 0) & (idx < target.shape[0])
        target.index_add_(0, idx[valid], src[valid])
    return targets


def _check(grad, targets, rows):
    if grad.dim() != 3 or grad.dtype != torch.float32:
        raise ValueError("grad must be [B, F, W] float32, got %s %s"
                         % (grad.dtype, tuple(grad.shape)))
    n_rows, n_fields, width = grad.shape
    if len(targets) != n_fields:
        raise ValueError("scatter_add_rows needs one target per field, got "
                         "%d targets for %d fields" % (len(targets), n_fields))
    if tuple(rows.shape) != (n_rows, n_fields) or rows.dtype != torch.int64:
        raise ValueError("rows must be int64 [%d, %d], got %s %s"
                         % (n_rows, n_fields, rows.dtype, tuple(rows.shape)))
    devices = {grad.device, rows.device} | {t.device for t in targets}
    if len(devices) != 1:
        raise ValueError("grad, rows and the targets must be on one device, "
                         "got %s" % sorted(map(str, devices)))
    for t in targets:
        if t.dim() != 2 or t.dtype != torch.float32 or t.shape[1] != width:
            raise ValueError("targets must be 2-D float32 of width %d, got "
                             "%s" % (width, [(t.dtype, tuple(t.shape))
                                             for t in targets]))


def _kernel():
    fn = _build.load("scatter_add_rows").scatter_add_rows_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_args(targets, device):
    """The per-field argument array, ``[target pointers | target row
    counts | target bases]`` as int64 on ``device``.  The kernel reads the
    first two; a target's base is where its rows start when the distinct
    targets are laid end to end."""
    bases, base = {}, 0
    for t in targets:
        if t.data_ptr() not in bases:
            bases[t.data_ptr()] = base
            base += t.shape[0]
    ptrs = [t.data_ptr() for t in targets]
    return device_array(ptrs + [t.shape[0] for t in targets]
                        + [bases[p] for p in ptrs], torch.int64, device)


def sort_contributions(targets, rows, meta):
    """The kernel's sorted view of the contributions: ``(keys, order,
    ends)``.  A contribution's key is its target's base plus its row; a
    row out of range gets a key of its own past every target.  A stable
    library sort keeps each run in ``(b, f)`` order; ``ends[k]`` is the
    end of the run that holds position ``k``.  ``meta`` is
    :func:`kernel_args` of the same targets."""
    n_fields = rows.shape[1]
    total = sum(t.shape[0] for t, _ in _groups(targets))
    field_rows = meta[n_fields:2 * n_fields]
    field_base = meta[2 * n_fields:]
    valid = (rows >= 0) & (rows < field_rows)
    flat = torch.arange(rows.numel(), device=rows.device).view(-1, n_fields)
    keys = torch.where(valid, rows + field_base, total + flat).view(-1)
    keys, order = torch.sort(keys, stable=True)
    ends = torch.searchsorted(keys, keys, right=True)
    return keys, order, ends


def scatter_add_rows(grad, targets, rows):
    """``targets[f][rows[b, f]] += grad[b, f]`` for every ``(b, f)``, in
    one launch: grad ``[B, F, W]`` float32, ``targets`` F tensors
    ``[R_f, W]`` float32 (one tensor may serve several fields), rows
    ``[B, F]`` int64.  Adds in place and returns ``targets``.

    On CUDA tensors this launches the kernel (building it at first use)
    or raises."""
    _check(grad, targets, rows)
    if grad.device.type == "cpu":
        return scatter_add_rows_ref(grad, targets, rows)
    if grad.device.type != "cuda":
        raise ValueError("no scatter-add kernel for device %s" % grad.device)
    if any(not t.is_contiguous() for t in targets):
        raise ValueError("scatter_add_rows needs contiguous targets")
    if grad.numel() == 0:
        return targets
    grad = grad.contiguous()
    rows = rows.contiguous()
    meta = kernel_args(targets, grad.device)
    launch(grad, rows, sort_contributions(targets, rows, meta), meta)
    return targets


def launch(grad, rows, sorted_view, meta):
    """The kernel alone, on contiguous CUDA ``grad`` and ``rows``, with
    the ``(keys, order, ends)`` of :func:`sort_contributions` and the
    :func:`kernel_args` of the same targets."""
    global SCATTER_ADD_LAUNCHES
    keys, order, ends = sorted_view
    fn = _kernel()
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        rc = fn(grad.data_ptr(), rows.data_ptr(), keys.data_ptr(),
                order.data_ptr(), ends.data_ptr(), meta.data_ptr(),
                rows.numel(), grad.shape[1], grad.shape[2], stream)
    if rc != 0:
        raise RuntimeError("scatter_add_rows kernel launch failed with CUDA "
                           "error %d" % rc)
    SCATTER_ADD_LAUNCHES += 1
