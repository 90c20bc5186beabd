"""Fused optimizer step on the touched rows of every sparse table.

The port's counterpart of ``deepctr_tpu/ops/pallas_update.py``:
``fused_row_update`` (sgd, adagrad) and the ``scatter_rows`` family that
writes back the adagrad and adam rows the JAX package computes in XLA,
with the rmsprop step of ``deepctr_tpu/models/basemodel.py:1222-1258``.
Per table ``t`` and listed row ``r = rows[t][j]`` that lies in the table
(``0 <= r < V_t``)::

    g' = g[j] + 2 * l2 * w[rows[j]]            lazy L2
    sgd      w -= lr * g'
    adagrad  acc += g'^2;  w -= lr * g' / (sqrt(acc) + 1e-10)
    rmsprop  v = 0.99 v + 0.01 g'^2;  w -= lr * g' / (sqrt(v) + 1e-8)
    adam     m = 0.9 m + 0.1 g';  v = 0.999 v + 0.001 g'^2;
             w -= lr * (m / bc1) / (sqrt(v / bc2) + 1e-8)

Adam's bias corrections ``(bc1, bc2) = (1 - b1^t, 1 - b2^t)`` come in one
of two modes (``config.set_adam_t``).  Per table: one step count, its
pair a float32 [2] tensor on the device.  Per row (``"rowwise"``, as
``torch.optim.SparseAdam``): the table's state carries a third tensor,
``t`` int32 [V]; a step reads ``t[r]``, adds 1, writes it back and takes
the row's pair from a float32 [T, 2] table of the pairs of every count
(``bias_correction_table``: row ``t`` holds ``adam_bias_corrections(t)``),
so an untouched row keeps its count and the corrections stay the JAX
package's float32 ``pow`` bit for bit.  That adds 8 bytes of ``t`` a
touched row to the traffic (and the few KB of the pair table, which stays
in L2).

Tables and state are updated in place; rows that are not touched keep
their bits.  A table's row list has a fixed capacity, its unused slots
padded with row ids past the table, which are dropped (the JAX package's
out-of-bounds dedup padding, ``basemodel.py:892-901``), and adam's
``(1 - b1^t, 1 - b2^t)`` lie on the device: what a launch needs depends
on no count the host would read back, so a train step captured in a CUDA
graph replays it as it is.  ``row_update`` launches the CUDA kernel in
``csrc/row_update.cu`` for CUDA tensors (up to ``CAPACITY`` tables a
launch, their arguments passed by value: ``launch_plan``,
``kernel_args``), or raises; it takes the plain version ``row_update_ref``
only because its tensors lie on the CPU.  The two round the same
operations in the same order, so they agree bit for bit.
"""

import ctypes
import struct

import numpy as np
import torch

from . import _build

# torch-form hyperparameters, as deepctr_tpu/models/basemodel.py:52-56
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAGRAD_EPS = 1e-10
RMS_DECAY, RMS_EPS = 0.99, 1e-8

# optimizer -> (kernel mode, number of state tensors a table carries)
MODES = {"sgd": (0, 0), "adagrad": (1, 1), "rmsprop": (2, 1), "adam": (3, 2)}


def adam_bias_corrections(t):
    """``(1 - b1^t, 1 - b2^t)`` in float32, as the JAX package computes
    them from a float32 step count (``basemodel.py:1242-1250``).  The
    training engine uploads them for an epoch's steps at once; a step
    reads its pair on the device."""
    tf = np.float32(t)
    one = np.float32(1.0)
    return (float(one - np.float32(ADAM_B1) ** tf),
            float(one - np.float32(ADAM_B2) ** tf))


# the pairs of every count 0 .. len - 1, grown on demand
_BIAS_TABLE = np.zeros((0, 2), np.float32)


def bias_correction_table(n):
    """float32 [n, 2]: row ``t`` is ``adam_bias_corrections(t)`` (row 0
    is (0, 0) and never read).  Computed one count at a time: numpy's
    float32 power over an array rounds some counts otherwise than its
    scalar power, which is the one that equals XLA's."""
    global _BIAS_TABLE
    have = _BIAS_TABLE.shape[0]
    if have < n:
        more = np.array([adam_bias_corrections(t) for t in range(have, n)],
                        np.float32).reshape(-1, 2)
        _BIAS_TABLE = np.concatenate([_BIAS_TABLE, more])
    return _BIAS_TABLE[:n]


def _eps(optimizer):
    return {"adagrad": ADAGRAD_EPS, "rmsprop": RMS_EPS,
            "adam": ADAM_EPS}.get(optimizer, 0.0)


@torch.no_grad()
def row_update_ref(optimizer, tables, states, grads, rows, l2s, lr,
                   bias=None):
    """Plain PyTorch version, one table at a time: drop the padding rows,
    gather the touched ones, the update math in the JAX package's order,
    ``index_copy_`` back.  Arguments as :func:`row_update`."""
    eps = _eps(optimizer)
    for t, (w, st, g, r, l2) in enumerate(zip(tables, states, grads, rows,
                                              l2s)):
        keep = (r >= 0) & (r < w.shape[0])
        r = r[keep]
        g = g[keep]
        w_rows = w.index_select(0, r)
        gp = g + (2.0 * l2)[None, :] * w_rows
        if optimizer == "sgd":
            step = lr * gp
        elif optimizer in ("adagrad", "rmsprop"):
            acc = st[0]
            if optimizer == "adagrad":
                a = acc.index_select(0, r) + gp * gp
            else:
                a = (RMS_DECAY * acc.index_select(0, r)
                     + (1 - RMS_DECAY) * (gp * gp))
            acc.index_copy_(0, r, a)
            step = lr * gp / (torch.sqrt(a) + eps)
        elif optimizer == "adam":
            m_state, v_state = st[:2]
            m = ADAM_B1 * m_state.index_select(0, r) + (1 - ADAM_B1) * gp
            v = (ADAM_B2 * v_state.index_select(0, r)
                 + (1 - ADAM_B2) * (gp * gp))
            m_state.index_copy_(0, r, m)
            v_state.index_copy_(0, r, v)
            # divide by device tensors: CUDA divides by a host scalar as a
            # multiply by its reciprocal, which rounds otherwise
            if len(st) == 3:       # rowwise: each row's own count
                count = st[2].index_select(0, r) + 1
                st[2].index_copy_(0, r, count)
                bc = bias[t].index_select(0, count.long())    # [n, 2]
                m_hat = m / bc[:, :1]
                v_hat = v / bc[:, 1:]
            else:
                bc = bias[t]
                m_hat = m / bc[0]
                v_hat = v / bc[1]
            step = lr * m_hat / (torch.sqrt(v_hat) + eps)
        else:
            raise ValueError("unknown optimizer %r" % optimizer)
        w.index_copy_(0, r, w_rows - step)
    return tables


def _check(optimizer, tables, states, grads, rows, l2s, bias):
    if optimizer not in MODES:
        raise ValueError("row_update supports %s, got %r"
                         % (sorted(MODES), optimizer))
    n_state = MODES[optimizer][1]
    lists = (tables, states, grads, rows, l2s)
    if len({len(a) for a in lists}) != 1 or not tables:
        raise ValueError("row_update needs one table, state tuple, gradient, "
                         "row list and l2 vector per table")
    if optimizer == "adam":
        if bias is None or len(bias) != len(tables):
            raise ValueError("adam needs one (1-b1^t, 1-b2^t) pair, or "
                             "table of pairs, per table")
        for b, st in zip(bias, states):
            want = "[2]" if len(st) == 2 else "[T, 2]"
            if (b.dim() != (1 if len(st) == 2 else 2)
                    or b.shape[-1] != 2 or b.dtype != torch.float32
                    or not b.is_contiguous()):
                raise ValueError("adam's (1-b1^t, 1-b2^t) must be a "
                                 "contiguous float32 %s tensor, got %s %s"
                                 % (want, b.dtype, tuple(b.shape)))
    devices = set()
    for w, st, g, r, l2 in zip(*lists):
        width = w.shape[1] if w.dim() == 2 else -1
        if optimizer == "adam" and len(st) == 3:
            count = st[2]
            if count.dtype != torch.int32 or tuple(count.shape) != (
                    w.shape[0],) or not count.is_contiguous():
                raise ValueError("adam's per-row step count must be a "
                                 "contiguous int32 [%d], got %s %s"
                                 % (w.shape[0], count.dtype,
                                    tuple(count.shape)))
            st = st[:2]
        if len(st) != n_state:
            raise ValueError("%s carries %d state tensors a table, got %d"
                             % (optimizer, n_state, len(st)))
        for a in (w,) + tuple(st):
            if a.dim() != 2 or a.dtype != torch.float32 or \
                    a.shape != w.shape:
                raise ValueError("table and state must be float32 [V, W] of "
                                 "one shape, got %s" % [
                                     (x.dtype, tuple(x.shape))
                                     for x in (w,) + tuple(st)])
        if g.dim() != 2 or g.dtype != torch.float32 or g.shape[1] != width:
            raise ValueError("gradient rows must be float32 [n, %d], got %s "
                             "%s" % (width, g.dtype, tuple(g.shape)))
        if r.dim() != 1 or r.dtype != torch.int64:
            raise ValueError("rows must be int64 [n], got %s %s"
                             % (r.dtype, tuple(r.shape)))
        if r.shape[0] != g.shape[0]:
            raise ValueError("%d row ids for %d gradient rows"
                             % (r.shape[0], g.shape[0]))
        if tuple(l2.shape) != (width,) or l2.dtype != torch.float32:
            raise ValueError("l2 must be float32 [%d], got %s %s"
                             % (width, l2.dtype, tuple(l2.shape)))
        devices |= {w.device, g.device, r.device, l2.device}
        devices |= {s.device for s in st}
    devices |= {b.device for b in bias or ()}
    if len(devices) != 1:
        raise ValueError("row_update's tensors must be on one device, got %s"
                         % sorted(map(str, devices)))


# the kernel's layout (csrc/row_update.cu: kMaxTables, kRunRows, Args),
# checked against the built library at first use
CAPACITY = 32     # tables one launch's argument struct holds
RUN_ROWS = 8      # touched rows a warp takes at a time
_INT_MAX = 2 ** 31 - 1
# how a table's rows move (csrc/row_update.cu: Route), each route a kernel
# instance: W=17 floats, any W as floats, W % 4 == 0 as 16-byte units
W17, SCALAR, VEC = range(3)


def route_of(width, aligned):
    """The route of a table of ``width`` floats: 16-byte units where W is
    a multiple of 4 and ``aligned`` (every array read in them starts on a
    16-byte boundary), else floats."""
    if width % 4 == 0 and aligned:
        return VEC
    return W17 if width == 17 else SCALAR


def launch_plan(caps, routes, capacity=CAPACITY):
    """The kernel's launches for tables of ``caps`` listed rows (touched or
    padding) on ``routes``: a list of ``(route, [(table, first_run, runs),
    ...])``, one entry a launch.  The tables of a route go together, in
    order, the routes in the order of their first tables, at most
    ``capacity`` tables a launch.  A table's rows go in runs of RUN_ROWS
    (the last one shorter), numbered from 0 in each launch; a table of no
    listed rows is left out.  No tables to update, no launch."""
    by_route = {}
    for t, (n, route) in enumerate(zip(caps, routes)):
        if n > 0:
            by_route.setdefault(route, []).append(t)
    plan = []
    for route, ts in by_route.items():
        for c in range(0, len(ts), capacity):
            planned, first = [], 0
            for t in ts[c:c + capacity]:
                runs = -(-caps[t] // RUN_ROWS)
                planned.append((t, first, runs))
                first += runs
            plan.append((route, planned))
    return plan


def _pointers(w, st, g, r, l2):
    """A table's (w, s1, s2, g, rows, l2) pointers, 0 for a state it does
    not carry, adam's per-row count (0 but in rowwise mode), and its
    route: 16-byte units need every array read in them (all but the row
    ids, the counts and adam's pairs) on a 16-byte boundary."""
    s1 = st[0].data_ptr() if st else 0
    s2 = st[1].data_ptr() if len(st) > 1 else 0
    ptrs = (w.data_ptr(), s1, s2, g.data_ptr(), r.data_ptr(), l2.data_ptr())
    aligned = (ptrs[0] | s1 | s2 | ptrs[3] | ptrs[5]) % 16 == 0
    count = st[2].data_ptr() if len(st) > 2 else 0
    return (ptrs, count), route_of(w.shape[1], aligned)


def table_routes(tables, states, grads, rows, l2s):
    """Each table's route (arguments as :func:`row_update`)."""
    return [_pointers(*a)[1] for a in zip(tables, states, grads, rows, l2s)]


class _Table(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p)
                 for name in ("w", "s1", "s2", "g", "rows", "l2", "bias",
                              "t")]
                + [("vocab", ctypes.c_longlong)]
                + [(name, ctypes.c_int) for name in ("capacity", "width")])


class _Args(ctypes.Structure):
    _fields_ = ([("first_run", ctypes.c_int * CAPACITY),
                 ("table", _Table * CAPACITY)]
                + [(name, ctypes.c_int) for name in ("n_tables", "n_runs",
                                                     "mode", "route")]
                + [(name, ctypes.c_float)
                   for name in ("lr", "eps", "d1", "c1", "d2", "c2")])


# the same fields packed straight into an _Args (a ctypes struct is a
# writable buffer): a table, the first runs, and n_tables .. c2
_TABLE = struct.Struct("<8Qq2i")
_FIRST = struct.Struct("<%di" % CAPACITY)
_HEAD = struct.Struct("<4i6f")


_KERNEL = _build.StructFn("row_update", "row_update_f32", {
    "row_update_args_bytes": ctypes.sizeof(_Args),
    "row_update_capacity": CAPACITY, "row_update_run_rows": RUN_ROWS})


def kernel_args(optimizer, tables, states, grads, rows, l2s, lr, bias=None):
    """The kernel's argument structs, one a launch of
    :func:`launch_plan`, in host memory: nothing is allocated on or copied
    to the device.  Arguments as :func:`row_update`, already checked."""
    mode, _ = MODES[optimizer]
    if optimizer == "adam":
        consts = (ADAM_B1, 1 - ADAM_B1, ADAM_B2, 1 - ADAM_B2)
    else:
        consts = (RMS_DECAY, 1 - RMS_DECAY, 0.0, 0.0)
    out = []
    caps = [r.shape[0] for r in rows]
    ptrs, routes = zip(*map(_pointers, tables, states, grads, rows, l2s))
    for route, planned in launch_plan(caps, routes):
        a = _Args()
        first = [_INT_MAX] * CAPACITY
        for i, (t, first_run, runs) in enumerate(planned):
            first[i] = first_run
            b = bias[t].data_ptr() if bias is not None else 0
            table_ptrs, count = ptrs[t]
            _TABLE.pack_into(a, _Args.table.offset + i * _TABLE.size,
                             *table_ptrs, b, count, tables[t].shape[0],
                             caps[t], tables[t].shape[1])
        _FIRST.pack_into(a, _Args.first_run.offset, *first)
        _HEAD.pack_into(a, _Args.n_tables.offset, len(planned),
                        first_run + runs, mode, route, lr, _eps(optimizer),
                        *consts)
        out.append(a)
    return out


def launch(args, device):
    """Launches the kernel once for each struct of ``args``
    (:func:`kernel_args`) on ``device``'s current stream."""
    _KERNEL.launch_all(device, args, "row_update")


def row_update(optimizer, tables, states, grads, rows, l2s, lr, bias=None):
    """One optimizer step on the rows ``rows[t]`` lists of every table, in
    the launches of :func:`launch_plan` (one for up to CAPACITY tables of
    one route).

    ``tables`` [V_t, W_t] float32 and ``states`` (a tuple per table: none
    for sgd, ``(acc,)`` for adagrad and rmsprop, ``(m, v)`` for adam, each
    shaped like its table, or ``(m, v, t)`` for adam's per-row count, ``t``
    int32 [V_t]) are updated in place.  ``rows`` [cap_t] int64
    are distinct row ids, a slot past the table (``>= V_t``) padding that
    is dropped; ``grads`` [cap_t, W_t] float32 the summed gradients of
    those rows; ``l2s`` [W_t] float32 the lazy L2 per column; ``bias`` for
    adam one float32 [2] tensor ``(1-b1^t, 1-b2^t)`` per table, or with a
    per-row count a float32 [T, 2] table of them by count
    (``bias_correction_table``; every count after the step, ``t[r] + 1``,
    must be below T), on the tables' device (one tensor may serve every
    table).

    On CUDA tensors this launches the kernel (building it at first use) or
    raises; on CPU tensors it runs ``row_update_ref``.  Returns
    ``tables``."""
    _check(optimizer, tables, states, grads, rows, l2s, bias)
    device = tables[0].device
    if device.type == "cpu":
        return row_update_ref(optimizer, tables, states, grads, rows, l2s,
                              lr, bias)
    if device.type != "cuda":
        raise ValueError("no row-update kernel for device %s" % device)
    arrays = list(tables) + [s for st in states for s in st] + list(grads)
    if any(not a.is_contiguous() for a in arrays + list(rows) + list(l2s)):
        raise ValueError("row_update needs contiguous tensors")
    launch(kernel_args(optimizer, tables, states, grads, rows, l2s, lr,
                       bias), device)
    return tables
