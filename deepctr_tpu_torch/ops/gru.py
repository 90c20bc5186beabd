"""Masked GRU / AGRU / AUGRU recurrence over hoisted input gates (forward).

The port's counterpart of ``deepctr_tpu/ops/pallas_gru.py`` (``gru_scan``,
the forward ``_fwd_call``).  For every batch row, from ``h = 0``::

    gh = h @ whh_t + bhh                        torch gate order r | z | n
    r = sigmoid(i_r + h_r); z = sigmoid(i_z + h_z); n = tanh(i_n + r * h_n)
    gru    h' = (1 - z) * n + z * h
    agru   h' = (1 - a) * h + a * n
    augru  u = a * z;  h' = (1 - u) * h + u * n
    h = h + m * (h' - h);  out_t = m * h'

The gates and the carry are float32 whatever the storage type of ``gi``;
only the outputs are rounded to it, as in the TPU kernel.

``gru_scan`` launches the CUDA kernel in ``csrc/gru_scan.cu`` for CUDA
tensors, or raises; it takes the plain version ``gru_scan_ref`` only
because its tensors lie on the CPU.  The backward kernel comes with the
training slice: on CUDA tensors that need a gradient ``gru_scan`` raises.
"""

import ctypes

import torch

from . import _build

# kernel launches since import (or since a caller reset it to 0); counts
# only launches of the CUDA kernel, never the plain version
GRU_SCAN_LAUNCHES = 0

MODES = {"gru": 0, "agru": 1, "augru": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# gru_scan_fwd's code for a hidden size a block does not take
_DOES_NOT_FIT = -2


def gru_scan_ref(gi, whh_t, bhh, mask, att=None, mode="gru"):
    """Plain PyTorch version: a loop over T in float32.  Arguments and
    result as :func:`gru_scan`."""
    _check(gi, whh_t, bhh, mask, att, mode)
    T, B, H3 = gi.shape
    H = H3 // 3
    f32 = torch.float32
    gi32, w, b = gi.to(f32), whh_t.to(f32), bhh.to(f32)
    m = mask.to(f32)
    a = None if att is None else att.to(f32)
    h = torch.zeros(B, H, dtype=f32, device=gi.device)
    outs = []
    for t in range(T):
        gh = h @ w + b
        g = gi32[t]
        r = torch.sigmoid(g[:, :H] + gh[:, :H])
        z = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
        if mode == "gru":
            h_new = (1.0 - z) * n + z * h
        else:
            a_t = a[:, t:t + 1]
            u = a_t * z if mode == "augru" else a_t
            h_new = (1.0 - u) * h + u * n
        m_t = m[:, t:t + 1]
        outs.append(m_t * h_new)
        h = h + m_t * (h_new - h)
    return torch.stack(outs).to(gi.dtype), h.to(gi.dtype)


def _check(gi, whh_t, bhh, mask, att, mode):
    if mode not in MODES:
        raise ValueError("gru_scan mode must be one of %s, got %r"
                         % (sorted(MODES), mode))
    if gi.dim() != 3 or gi.shape[2] % 3 or gi.shape[0] < 1:
        raise ValueError("gi must be [T >= 1, B, 3H], got %s"
                         % (tuple(gi.shape),))
    T, B, H3 = gi.shape
    H = H3 // 3
    if gi.dtype not in _DTYPES:
        raise ValueError("gi must be float32 or bfloat16, got %s" % gi.dtype)
    if tuple(whh_t.shape) != (H, H3) or tuple(bhh.shape) != (H3,):
        raise ValueError("whh_t must be [%d, %d] and bhh [%d], got %s and %s"
                         % (H, H3, H3, tuple(whh_t.shape),
                            tuple(bhh.shape)))
    if tuple(mask.shape) != (B, T):
        raise ValueError("mask must be [%d, %d], got %s"
                         % (B, T, tuple(mask.shape)))
    if (att is None) != (mode == "gru"):
        raise ValueError("mode %r takes %s attention scores"
                         % (mode, "no" if mode == "gru" else "[B, T]"))
    if att is not None and tuple(att.shape) != (B, T):
        raise ValueError("att must be [%d, %d], got %s"
                         % (B, T, tuple(att.shape)))
    tensors = [gi, whh_t, bhh, mask] + ([] if att is None else [att])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("gru_scan's tensors must be on one device, got %s"
                         % sorted(map(str, devices)))


def _kernel():
    lib = _build.load("gru_scan")
    fn = lib.gru_scan_fwd
    fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def gru_scan(gi, whh_t, bhh, mask, att=None, mode="gru"):
    """The masked recurrence of every row in one launch.

    gi    [T, B, 3H]  input gates (x @ W_ih^T + b_ih), float32 or bfloat16;
                      any strides with a contiguous last dimension
    whh_t [H, 3H]     recurrent weight, transposed (gh = h @ whh_t + bhh)
    bhh   [3H]
    mask  [B, T]      0/1 (or bool): step t updates row b iff mask[b, t]
    att   [B, T]      attention scores (modes agru and augru only)

    Returns ``(outs [T, B, H], h_last [B, H])`` in gi's dtype; padded steps
    emit zero rows and keep the carry.  Any B >= 1 and T >= 1.  On CUDA
    tensors this launches the kernel (building it at first use) or raises;
    it takes H <= 1024, and its ``outs`` is a ``[T, B, H]`` view of a
    contiguous ``[B, T, H]``.  The kernel reads float32 weights, a bool
    mask and float32 or gi-typed scores as they are; other types are cast
    first."""
    global GRU_SCAN_LAUNCHES
    if gi.device.type == "cpu":
        return gru_scan_ref(gi, whh_t, bhh, mask, att, mode)
    _check(gi, whh_t, bhh, mask, att, mode)
    if gi.device.type != "cuda":
        raise ValueError("no gru_scan kernel for device %s" % gi.device)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (gi, whh_t, bhh, mask, att)):
        raise NotImplementedError(
            "gru_scan has no backward kernel yet (it comes with the DIEN "
            "training slice): call it under torch.no_grad()")
    if gi.stride(2) != 1:
        raise ValueError("gru_scan needs gi's last dimension contiguous")
    T, B, H3 = gi.shape
    H = H3 // 3
    out = torch.empty(B, T, H, dtype=gi.dtype, device=gi.device)
    h_last = torch.empty(B, H, dtype=gi.dtype, device=gi.device)
    if B == 0:
        return out.transpose(0, 1), h_last
    f32 = torch.float32
    w = whh_t.to(f32).contiguous()
    b = bhh.to(f32).contiguous()
    m = (mask if mask.dtype == torch.bool else mask != 0).contiguous()
    a = None
    if att is not None:
        a = (att if att.dtype in (f32, gi.dtype) else att.to(f32)).contiguous()
    with torch.cuda.device(gi.device):
        stream = torch.cuda.current_stream(gi.device).cuda_stream
        rc = _kernel()(
            _DTYPES[gi.dtype], MODES[mode], gi.data_ptr(), gi.stride(0),
            gi.stride(1), w.data_ptr(), b.data_ptr(), m.data_ptr(),
            None if a is None else a.data_ptr(),
            int(a is not None and a.dtype == torch.bfloat16), B, T, H,
            out.data_ptr(), out.stride(1), out.stride(0), h_last.data_ptr(),
            stream)
    if rc == _DOES_NOT_FIT:
        raise ValueError("gru_scan takes hidden sizes up to 1024, got %d" % H)
    if rc != 0:
        raise RuntimeError("gru_scan kernel launch failed with CUDA error %d"
                           % rc)
    GRU_SCAN_LAUNCHES += 1
    return out.transpose(0, 1), h_last
