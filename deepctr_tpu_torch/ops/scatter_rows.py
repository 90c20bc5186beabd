"""Write-back of L-row groups into a table, the row scatter of the scatter
micro-benchmark (``tools/scatter_micro.py``).

The port's counterpart of ``tools/scatter_issue_micro.py:static_scatter``
(the static-trip-count A/B variant of the TPU's row-DMA scatter) and of the
dynamic-count scatter it is compared with (``scatter_rows``, which takes
the place of both ``deepctr_tpu/ops/pallas_update.py:scatter_rows`` and
``arena_scatter_rows``)::

    table[starts[j] + r] = vals[j * L + r]        r < L

for every slot j (static), or for the slots j < n_valid (dynamic, the
count read from device memory).  Later slots win where two name the same
rows in the plain versions; in the kernel the value left there is one of
theirs.  The static variant writes padding slots to a sacrificial dump
row that the caller puts past its tables.

Every function works in place on the table and returns it.  On CUDA
tensors each launches the kernel in ``csrc/static_scatter.cu`` or raises;
the plain versions (``static_scatter_ref``, ``scatter_rows_ref``) run only
because the tensors lie on the CPU.
Starts are not checked on the card (that would cost a device-to-host
copy): the plain versions raise on a start whose rows leave the table, the
kernel skips that slot.
"""

import ctypes

import torch

from . import _build

UNROLLS = (1, 2, 4, 8)


def _check(table, vals, starts, L):
    """(G, n, L) of a table [R, W], vals [(G,) n*L, W] and starts [(G,)
    n]; raises on anything else."""
    if table.dim() != 2 or vals.dim() not in (2, 3) or (
            starts.dim() != vals.dim() - 1):
        raise ValueError("table must be [R, W], vals [n*L, W] or [G, n*L, "
                         "W] and starts [n] or [G, n], got %s, %s and %s"
                         % (tuple(table.shape), tuple(vals.shape),
                            tuple(starts.shape)))
    vals3 = vals.reshape(-1, *vals.shape[-2:])
    G, n = vals3.shape[0], starts.shape[-1]
    if L is None:
        L = vals3.shape[1] // n if n else 0
    if (n == 0 or L <= 0 or vals3.shape[1] != n * L
            or vals.shape[-1] != table.shape[1]
            or starts.reshape(-1, n).shape[0] != G):
        raise ValueError("vals %s, starts %s and table %s do not make n "
                         "slots of L rows" % (tuple(vals.shape),
                                              tuple(starts.shape),
                                              tuple(table.shape)))
    if vals.dtype != table.dtype or starts.dtype not in (torch.int32,
                                                         torch.int64):
        raise ValueError("vals must have the table's dtype and starts be "
                         "integers, got %s, %s and %s"
                         % (vals.dtype, table.dtype, starts.dtype))
    devices = {t.device for t in (table, vals, starts)}
    if len(devices) != 1:
        raise ValueError("the tensors must be on one device, got %s"
                         % sorted(map(str, devices)))
    return G, n, L


@torch.no_grad()
def _scatter_ref(table, vals, starts, counts, L):
    """The copies of the slots j < counts[g] of every group, in order
    (group by group), later slots winning."""
    G, n = starts.reshape(-1, starts.shape[-1]).shape
    starts2 = starts.reshape(G, n).to(torch.int64)
    counts = torch.as_tensor(counts, device=table.device).reshape(-1)
    valid = (torch.arange(n, device=table.device)[None, :]
             < counts.to(torch.int64)[:, None])
    slot = torch.arange(G * n, device=table.device).reshape(G, n)[valid]
    dst = starts2[valid]
    if bool(((dst < 0) | (dst + L > table.shape[0])).any()):
        raise ValueError("a slot's rows lie outside the table")
    rows = torch.arange(L, device=table.device)
    dst_rows = (dst[:, None] + rows).reshape(-1)
    src_rows = (slot[:, None] * L + rows).reshape(-1)
    uniq, inv = torch.unique(dst_rows, return_inverse=True)
    last = torch.full((uniq.numel(),), -1, dtype=torch.int64,
                      device=table.device)
    last.scatter_reduce_(0, inv, torch.arange(dst_rows.numel(),
                                              device=table.device), "amax")
    table[uniq] = vals.reshape(-1, table.shape[1])[src_rows[last]]
    return table


def static_scatter_ref(table, vals, starts):
    """Plain version of :func:`static_scatter`: every slot's rows, in slot
    order."""
    G, n, L = _check(table, vals, starts, None)
    return _scatter_ref(table, vals, starts, [n] * G, L)


def scatter_rows_ref(table, vals, starts, n_valid, L=1):
    """Plain version of :func:`scatter_rows`."""
    _check(table, vals, starts, L)
    return _scatter_ref(table, vals, starts, n_valid, L)


_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_KERNEL = _build.Fn("static_scatter", "static_scatter",
                    [_I, _I, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P])


def _launch(table, vals, starts, n_valid, G, n, L, unroll, count):
    if table.device.type != "cuda":
        raise ValueError("no static_scatter kernel for device %s"
                         % table.device)
    if unroll not in UNROLLS:
        raise ValueError("unroll must be one of %s, got %r" % (UNROLLS,
                                                               unroll))
    if starts.dtype != torch.int32 or not all(
            t.is_contiguous() for t in (table, vals, starts)):
        raise ValueError("the kernel takes contiguous tensors and int32 "
                         "starts, got %s starts" % starts.dtype)
    if n_valid is not None and (n_valid.dtype != torch.int32
                                or n_valid.numel() != G
                                or n_valid.device != table.device):
        raise ValueError("n_valid must be %d int32 count(s) on %s, got %s "
                         "%s on %s" % (G, table.device, n_valid.dtype,
                                       tuple(n_valid.shape),
                                       n_valid.device))
    _KERNEL.launch(table.device, int(n_valid is not None), unroll,
                   vals.data_ptr(), table.data_ptr(), starts.data_ptr(),
                   None if n_valid is None else n_valid.data_ptr(), G, n, L,
                   table.shape[1] * table.element_size(), table.shape[0],
                   count=count)


def static_scatter(table, vals, starts, unroll=1):
    """Copy ``vals[j*L : j*L + L]`` to ``table[starts[j] : starts[j] + L]``
    for every slot j, in place; returns ``table``.

    table [R, W] (any row width and dtype), vals [n*L, W] in its dtype,
    starts [n] int32 row indices; or vals [G, n*L, W] and starts [G, n]
    for G groups of slots into one arena, in one launch.  L is
    ``vals.shape[-2] // n``.  ``unroll`` (1, 2, 4 or 8) is how many slots
    a lane has in flight at once.  On CUDA tensors this launches the
    kernel (building it at first use) or raises."""
    G, n, L = _check(table, vals, starts, None)
    if table.device.type == "cpu":
        return _scatter_ref(table, vals, starts, [n] * G, L)
    _launch(table, vals, starts, None, G, n, L, unroll, "static_scatter")
    return table


def scatter_rows(table, vals, starts, n_valid, L=1):
    """The dynamic variant: the slots j < ``n_valid`` of vals [n*L, W] and
    starts [n], or of each of G groups (vals [G, n*L, W], starts [G, n],
    n_valid [G]) in one launch, in place; returns ``table``.  ``n_valid``
    is int32 on the table's device, read by the kernel."""
    G, n, L = _check(table, vals, starts, L)
    if table.device.type == "cpu":
        return _scatter_ref(table, vals, starts, n_valid, L)
    _launch(table, vals, starts, n_valid.reshape(-1), G, n, L, 1,
            "scatter_rows")
    return table
