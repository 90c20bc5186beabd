"""Fused optimizer step on the touched rows of every sparse table.

The port's counterpart of ``deepctr_tpu/ops/pallas_update.py``:
``fused_row_update`` (sgd, adagrad) and the ``scatter_rows`` family that
writes back the adagrad and adam rows the JAX package computes in XLA,
with the rmsprop step of ``deepctr_tpu/models/basemodel.py:1222-1258``.
Per table ``t`` and touched row ``j < n_valid[t]``::

    g' = g[j] + 2 * l2 * w[rows[j]]            lazy L2
    sgd      w -= lr * g'
    adagrad  acc += g'^2;  w -= lr * g' / (sqrt(acc) + 1e-10)
    rmsprop  v = 0.99 v + 0.01 g'^2;  w -= lr * g' / (sqrt(v) + 1e-8)
    adam     m = 0.9 m + 0.1 g';  v = 0.999 v + 0.001 g'^2;
             w -= lr * (m / bc1) / (sqrt(v / bc2) + 1e-8)

Tables and state are updated in place; rows that are not touched keep
their bits.  ``row_update`` launches the CUDA kernel in
``csrc/row_update.cu`` (every table in one launch) for CUDA tensors, or
raises; it takes the plain version ``row_update_ref`` only because its
tensors lie on the CPU.  The two round the same operations in the same
order, so they agree bit for bit.
"""

import ctypes

import numpy as np
import torch

from . import _build
from ._args import device_array

# kernel launches since import (or since a caller reset it to 0); counts
# only launches of the CUDA kernel, never the plain version
ROW_UPDATE_LAUNCHES = 0

# torch-form hyperparameters, as deepctr_tpu/models/basemodel.py:52-56
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAGRAD_EPS = 1e-10
RMS_DECAY, RMS_EPS = 0.99, 1e-8

# optimizer -> (kernel mode, number of state tensors a table carries)
MODES = {"sgd": (0, 0), "adagrad": (1, 1), "rmsprop": (2, 1), "adam": (3, 2)}


def adam_bias_corrections(t):
    """``(1 - b1^t, 1 - b2^t)`` in float32, as the JAX package computes
    them from a float32 step count (``basemodel.py:1242-1250``)."""
    tf = np.float32(t)
    one = np.float32(1.0)
    return (float(one - np.float32(ADAM_B1) ** tf),
            float(one - np.float32(ADAM_B2) ** tf))


def _eps(optimizer):
    return {"adagrad": ADAGRAD_EPS, "rmsprop": RMS_EPS,
            "adam": ADAM_EPS}.get(optimizer, 0.0)


@torch.no_grad()
def row_update_ref(optimizer, tables, states, grads, rows, n_valid, l2s, lr,
                   bias=None):
    """Plain PyTorch version, one table at a time: gather the touched rows,
    the update math in the JAX package's order, ``index_copy_`` back.
    Arguments as :func:`row_update`."""
    eps = _eps(optimizer)
    for t, (w, st, g, r, nv, l2) in enumerate(zip(tables, states, grads,
                                                  rows, n_valid, l2s)):
        r = r[:nv]
        g = g[:nv]
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
            m_state, v_state = st
            m = ADAM_B1 * m_state.index_select(0, r) + (1 - ADAM_B1) * gp
            v = (ADAM_B2 * v_state.index_select(0, r)
                 + (1 - ADAM_B2) * (gp * gp))
            m_state.index_copy_(0, r, m)
            v_state.index_copy_(0, r, v)
            # divide by device tensors: CUDA divides by a host scalar as a
            # multiply by its reciprocal, which rounds otherwise
            bc = device_array(bias[t], torch.float32, w.device)
            m_hat = m / bc[0]
            v_hat = v / bc[1]
            step = lr * m_hat / (torch.sqrt(v_hat) + eps)
        else:
            raise ValueError("unknown optimizer %r" % optimizer)
        w.index_copy_(0, r, w_rows - step)
    return tables


def _check(optimizer, tables, states, grads, rows, n_valid, l2s, bias):
    if optimizer not in MODES:
        raise ValueError("row_update supports %s, got %r"
                         % (sorted(MODES), optimizer))
    n_state = MODES[optimizer][1]
    lists = (tables, states, grads, rows, n_valid, l2s)
    if len({len(a) for a in lists}) != 1 or not tables:
        raise ValueError("row_update needs one table, state tuple, gradient, "
                         "row list, n_valid and l2 vector per table")
    if optimizer == "adam" and (bias is None or len(bias) != len(tables)):
        raise ValueError("adam needs one (1-b1^t, 1-b2^t) pair per table")
    devices = set()
    for w, st, g, r, nv, l2 in zip(*lists):
        width = w.shape[1] if w.dim() == 2 else -1
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
        if not 0 <= nv <= min(r.shape[0], g.shape[0]):
            raise ValueError("n_valid %d outside [0, %d]"
                             % (nv, min(r.shape[0], g.shape[0])))
        if tuple(l2.shape) != (width,) or l2.dtype != torch.float32:
            raise ValueError("l2 must be float32 [%d], got %s %s"
                             % (width, l2.dtype, tuple(l2.shape)))
        devices |= {w.device, g.device, r.device, l2.device}
        devices |= {s.device for s in st}
    if len(devices) != 1:
        raise ValueError("row_update's tensors must be on one device, got %s"
                         % sorted(map(str, devices)))


def _kernel():
    fn = _build.load("row_update").row_update_f32
    fn.argtypes = ([ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def row_update(optimizer, tables, states, grads, rows, n_valid, l2s, lr,
               bias=None):
    """One optimizer step on the first ``n_valid[t]`` rows of ``rows[t]``
    of every table, in one launch.

    ``tables`` [V_t, W_t] float32 and ``states`` (a tuple per table: none
    for sgd, ``(acc,)`` for adagrad and rmsprop, ``(m, v)`` for adam, each
    shaped like its table) are updated in place.  ``grads`` [n_t, W_t]
    float32 are the summed gradients of the touched rows, ``rows`` [n_t]
    int64 their unique row ids, ``l2s`` [W_t] float32 the lazy L2 per
    column, ``bias`` a ``(1-b1^t, 1-b2^t)`` pair per table for adam.

    On CUDA tensors this launches the kernel (building it at first use) or
    raises.  Returns ``tables``."""
    global ROW_UPDATE_LAUNCHES
    n_valid = [int(n) for n in n_valid]
    _check(optimizer, tables, states, grads, rows, n_valid, l2s, bias)
    device = tables[0].device
    if device.type == "cpu":
        return row_update_ref(optimizer, tables, states, grads, rows,
                              n_valid, l2s, lr, bias)
    if device.type != "cuda":
        raise ValueError("no row-update kernel for device %s" % device)
    arrays = list(tables) + [s for st in states for s in st] + list(grads)
    if any(not a.is_contiguous() for a in arrays + list(rows) + list(l2s)):
        raise ValueError("row_update needs contiguous tensors")
    mode, _ = MODES[optimizer]
    meta, offsets = [], [0]
    for w, st, g, r, nv, l2 in zip(tables, states, grads, rows, n_valid,
                                   l2s):
        s1 = st[0].data_ptr() if st else 0
        s2 = st[1].data_ptr() if len(st) > 1 else 0
        meta += [w.data_ptr(), s1, s2, g.data_ptr(), r.data_ptr(),
                 l2.data_ptr(), nv, w.shape[1]]
        offsets.append(offsets[-1] + nv * w.shape[1])
    total = offsets[-1]
    if total == 0:
        return tables
    meta_d = device_array(meta + offsets, torch.int64, device)
    bias_d = device_array(
        [c for pair in (bias or [(1.0, 1.0)] * len(tables)) for c in pair],
        torch.float32, device)
    if optimizer == "adam":
        consts = (ADAM_B1, 1 - ADAM_B1, ADAM_B2, 1 - ADAM_B2)
    else:
        consts = (RMS_DECAY, 1 - RMS_DECAY, 0.0, 0.0)
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(meta_d.data_ptr(), meta_d.data_ptr() + 8 * len(meta),
                bias_d.data_ptr(), len(tables), total, mode, float(lr),
                _eps(optimizer), *consts, stream)
    if rc != 0:
        raise RuntimeError("row_update kernel launch failed with CUDA error "
                           "%d" % rc)
    ROW_UPDATE_LAUNCHES += 1
    return tables
