"""Multi-table scatter-add: ``target_f[rows[b, f]] += grad[b, f]``.

The backward of :func:`~deepctr_tpu_torch.ops.gather.gather_rows`, the
port's counterpart of ``deepctr_tpu/ops/pallas_gather.py:_gather_bwd``
(and ``_gather_packed_bwd``) and of the slice transpose of the JAX
package's active-rows train step (``deepctr_tpu/models/basemodel.py:
733-741``).  One call covers every field of one gather launch; a field's
target is a table's dense ``[V, W]`` gradient indexed by id, or the
``[n_unique, W]`` gradient of the rows a batch touched, indexed by slot.

``scatter_add_rows`` launches the CUDA kernels in
``csrc/scatter_add_rows.cu`` for CUDA tensors, or raises; it takes the
plain version ``scatter_add_rows_ref`` (``index_add_``) only because its
tensors lie on the CPU.  The kernels sort the contributions by target row
with a stable radix sort of their own (no library sort) and sum each row's
run in two levels: chunks of at most ``2 * CHUNK - 1`` contributions
(``CHUNK`` = 64) in ``(b, f)`` order, the first from the value the target
holds, then the chunk sums in order.  So a row with at most ``CHUNK``
contributions sums exactly as ``index_add_`` does on the CPU, bit for bit;
a longer run is not that order, and is held to the sum of its terms'
magnitudes.  ``scatter_add_rows_chunked_ref`` is the plain version of the
kernels' order (bit-equal to them everywhere), ``sort_keys_ref`` of their
sort; both, like ``sort_contributions``, are plain versions for checks and
never run on the kernels' path.  A repeat gives the same bits: no float
atomics.
"""

import ctypes

import torch

from . import _build
from ._args import device_array

# the two-level sum's chunk length (csrc/scatter_add_rows.cu:kChunk)
CHUNK = 64


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


_LL, _P = ctypes.c_longlong, ctypes.c_void_p
_KERNEL = _build.Fn("scatter_add_rows", "scatter_add_rows_f32", [
    _P, _P, _P, _LL, ctypes.c_int, ctypes.c_int, _LL, _P, _LL, ctypes.c_int,
    _P])
_WORKSPACE = _build.Fn("scatter_add_rows", "scatter_add_rows_workspace",
                       [_LL, ctypes.c_int], _LL)
_SORTED = _build.Fn("scatter_add_rows", "scatter_add_rows_sorted",
                    [_P, _LL, ctypes.c_int, _LL, _P, _P, _P])


def kernel_args(targets, device, cache=None):
    """The per-field argument array, ``[target pointers | target row
    counts | target bases]`` as int64 on ``device``.  A target's base is
    where its rows start when the distinct targets are laid end to end.
    With ``cache`` (a :class:`~._args.DeviceArgs` the caller keeps) the
    array is uploaded only when the targets' pointers or row counts
    change."""
    ptrs = [t.data_ptr() for t in targets]
    counts = [t.shape[0] for t in targets]

    def values():
        bases, base = {}, 0
        for p, n in zip(ptrs, counts):
            if p not in bases:
                bases[p] = base
                base += n
        return ptrs + counts + [bases[p] for p in ptrs]
    if cache is None:
        return device_array(values(), torch.int64, device)
    return cache.get((torch.device(device), tuple(ptrs), tuple(counts)),
                     lambda: device_array(values(), torch.int64, device))


def total_rows(targets):
    """The rows of the distinct targets together: the key of a row out of
    range, past every target's."""
    return sum(t.shape[0] for t, _ in _groups(targets))


def _keys(targets, rows, meta, bad):
    n_fields = rows.shape[1]
    field_rows = meta[n_fields:2 * n_fields]
    field_base = meta[2 * n_fields:]
    valid = (rows >= 0) & (rows < field_rows)
    return torch.where(valid, rows + field_base, bad).view(-1)


def sort_contributions(targets, rows, meta):
    """Plain version of a stable sort of the contributions by target row:
    ``(keys, order, ends)``.  A contribution's key is its target's base
    plus its row; a row out of range gets a key of its own past every
    target.  A stable library sort keeps each run in ``(b, f)`` order;
    ``ends[k]`` is the end of the run that holds position ``k``.  ``meta``
    is :func:`kernel_args` of the same targets."""
    n_fields = rows.shape[1]
    flat = torch.arange(rows.numel(), device=rows.device).view(-1, n_fields)
    keys = _keys(targets, rows, meta, total_rows(targets) + flat)
    keys, order = torch.sort(keys, stable=True)
    ends = torch.searchsorted(keys, keys, right=True)
    return keys, order, ends


def sort_keys_ref(targets, rows, meta):
    """Plain version of the kernels' sort: ``(keys, order)``, the keys in
    ascending order and the flat index ``b * F + f`` of each, stable.  Every
    row out of range has the one key :func:`total_rows`, after every
    target's; the permutation is :func:`sort_contributions`'."""
    keys = _keys(targets, rows, meta, total_rows(targets))
    return torch.sort(keys, stable=True)


def chunk_heads_ref(keys, bad):
    """For each position of the sorted ``keys``, the position of the head
    of its chunk, and whether that head starts its run (its chunk is the
    run's first), as the kernels cut runs: the first chunk from the run's
    start ``s`` to the first multiple of CHUNK at least ``s + CHUNK``, the
    others CHUNK positions each.  Positions of the key ``bad`` get -1."""
    n = keys.numel()
    pos = torch.arange(n, device=keys.device)
    starts = torch.ones(n, dtype=torch.bool, device=keys.device)
    starts[1:] = keys[1:] != keys[:-1]
    run_start = torch.cummax(torch.where(starts, pos, 0), 0).values
    second = (run_start + 2 * CHUNK - 1) // CHUNK * CHUNK
    heads = torch.where(pos < second, run_start, pos // CHUNK * CHUNK)
    heads = torch.where(keys == bad, -1, heads)
    return heads, heads == run_start


@torch.no_grad()
def scatter_add_rows_chunked_ref(grad, targets, rows):
    """Plain version of the kernels' order of sums (equal to them bit for
    bit): the contributions sorted by :func:`sort_keys_ref`, each run's
    chunks (:func:`chunk_heads_ref`) summed in ``(b, f)`` order, the
    first from the target's value, then each run's chunk sums in order.
    Adds in place; returns ``targets``."""
    width = grad.shape[2]
    meta = kernel_args(targets, grad.device)
    bad = total_rows(targets)
    keys, order = sort_keys_ref(targets, rows, meta)
    n = keys.numel()
    heads, first = chunk_heads_ref(keys, bad)
    g = grad.reshape(-1, width)[order]
    # one row of the whole targets laid end to end, by key
    stacked = torch.cat([t for t, _ in _groups(targets)])
    ok = heads >= 0
    pos = torch.arange(n, device=keys.device)
    acc = torch.zeros(n, width, dtype=grad.dtype, device=grad.device)
    off = pos - heads
    for o in range(2 * CHUNK - 1):
        sel = ok & (off == o)
        if not bool(sel.any()):
            break
        h = heads[sel]
        if o == 0:
            acc[h] = torch.where(first[sel][:, None],
                                 stacked[keys[sel]] + g[sel], g[sel])
        else:
            acc[h] = acc[h] + g[sel]
    # level 2: each run's chunk sums in order; a run of one chunk is its
    # first chunk's sum
    run_starts = ok & first & (off == 0)
    s = pos[run_starts]
    total = acc[s]
    q = (s + 2 * CHUNK - 1) // CHUNK * CHUNK
    while True:
        more = q < n
        more[more.clone()] = keys[q[more]] == keys[s[more]]
        if not bool(more.any()):
            break
        total[more] = total[more] + acc[q[more]]
        q = q + CHUNK
    result = stacked.clone()
    result[keys[s]] = total
    base = 0
    for t, _ in _groups(targets):
        t.copy_(result[base:base + t.shape[0]])
        base += t.shape[0]
    return targets


def scatter_add_rows(grad, targets, rows, args=None):
    """``targets[f][rows[b, f]] += grad[b, f]`` for every ``(b, f)``, in
    one call: grad ``[B, F, W]`` float32, ``targets`` F tensors
    ``[R_f, W]`` float32 (one tensor may serve several fields), rows
    ``[B, F]`` int64.  Adds in place and returns ``targets``.

    On CUDA tensors this launches the kernels (building them at first
    use) or raises.  ``args`` is a :class:`~._args.DeviceArgs` that the
    caller keeps so that the per-field argument array is not copied to the
    device on every call (a captured train step needs it so)."""
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
    meta = kernel_args(targets, grad.device, args)
    total = total_rows(targets)
    launch(grad, rows, meta, total, workspace(rows.numel(), grad.shape[2],
                                              grad.device))
    return targets


def workspace(n, width, device):
    """The kernels' scratch for n contributions of ``width`` floats: the
    sort's keys, order and histograms and the chunk sums."""
    return torch.empty(_WORKSPACE(n, width), dtype=torch.uint8,
                       device=device)


def launch(grad, rows, meta, total, ws, part=0):
    """The kernels on contiguous CUDA ``grad`` and ``rows``, with the
    :func:`kernel_args` of the targets, their :func:`total_rows` and a
    :func:`workspace`.  ``part``: 0 the whole call, 1 the sort alone, 2 the
    sums alone on the sort a part-1 call left in ``ws``."""
    _KERNEL.launch(grad.device, grad.data_ptr(), rows.data_ptr(),
                   meta.data_ptr(), rows.numel(), grad.shape[1],
                   grad.shape[2], total, ws.data_ptr(), ws.numel(), part,
                   count="scatter_add_rows")


def kernel_sorted(ws, n, width, total):
    """The keys and order (int32) that the last sort left in ``ws``."""
    keys = torch.empty(n, dtype=torch.int32, device=ws.device)
    order = torch.empty(n, dtype=torch.int32, device=ws.device)
    _SORTED.launch(ws.device, ws.data_ptr(), n, width, total,
                   keys.data_ptr(), order.data_ptr())
    return keys, order
