"""Masked GRU / AGRU / AUGRU recurrence over hoisted input gates, forward
and backward.

The port's counterpart of ``deepctr_tpu/ops/pallas_gru.py`` (``gru_scan``:
the forward ``_fwd_call`` and the backward ``_bwd_call``).  For every
batch row, from ``h = 0``::

    gh = h @ whh_t + bhh                        torch gate order r | z | n
    r = sigmoid(i_r + h_r); z = sigmoid(i_z + h_z); n = tanh(i_n + r * h_n)
    gru    h' = (1 - z) * n + z * h
    agru   h' = (1 - a) * h + a * n
    augru  u = a * z;  h' = (1 - u) * h + u * n
    h = h + m * (h' - h);  out_t = m * h'

The gates and the carry are float32 whatever the storage type of ``gi``;
only the outputs are rounded to it, as in the TPU kernel.

``gru_scan`` runs the ``deepctr_tpu_torch::gru_scan`` op
(``ops/library.py``), which launches the CUDA kernel in
``csrc/gru_scan.cu`` for CUDA tensors, or raises, and takes the plain
version ``gru_scan_ref`` only because its tensors lie on the CPU (where,
while autograd records, the wrapper calls the plain version itself, for
autograd to differentiate).  On
CUDA tensors while autograd records it runs as :class:`GruScan`: the
forward kernel also writes the carries ``h_{t-1}`` ([T, B, H], in the
storage type), and the backward is the kernel in ``csrc/gru_scan_bwd.cu``
(``gru_scan_bwd``, plain version ``gru_scan_bwd_ref``), which recomputes
the gates from them as ``_bwd_call`` does.
"""

import ctypes

import torch

from . import _build

# kernel launches since import (or since a caller reset it to 0); count
# only launches of the CUDA kernels, never the plain versions: the forward
# (with or without carries) and the backward
GRU_SCAN_LAUNCHES = 0
GRU_SCAN_BWD_LAUNCHES = 0

MODES = {"gru": 0, "agru": 1, "augru": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' code for a hidden size a block does not take
_DOES_NOT_FIT = -2


def _gates(g, h, w, b, H):
    gh = h @ w + b
    r = torch.sigmoid(g[:, :H] + gh[:, :H])
    z = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
    return r, z, n, gh[:, 2 * H:]


def last_valid_steps(mask):
    """The last step t with ``mask[b, t]`` set of every row b of a [B, T]
    mask (0/1 or bool), -1 for a row with none: [B] int64.  Holes inside
    a history count as any padded step does.  For H <= 64 the kernels walk
    a block of 8 rows only up to (forward) or from (backward) the largest
    of its rows' last valid steps, which they find from the mask as this
    function does."""
    valid = mask != 0
    B, T = valid.shape
    if T == 0:
        return torch.full((B,), -1, dtype=torch.int64, device=valid.device)
    steps = torch.arange(1, T + 1, device=valid.device)
    return (valid * steps).amax(dim=1) - 1


def gru_scan_ref(gi, whh_t, bhh, mask, att=None, mode="gru",
                 save_carry=False):
    """Plain PyTorch version: a loop over T in float32.  Arguments and
    result as :func:`gru_scan`; with ``save_carry`` it also returns the
    carries ``[T, B, H]`` (``h_{t-1}`` before step t, in gi's dtype), as
    the kernel's training forward writes them."""
    _check(gi, whh_t, bhh, mask, att, mode)
    T, B, H3 = gi.shape
    H = H3 // 3
    f32 = torch.float32
    gi32, w, b = gi.to(f32), whh_t.to(f32), bhh.to(f32)
    m = mask.to(f32)
    a = None if att is None else att.to(f32)
    h = torch.zeros(B, H, dtype=f32, device=gi.device)
    outs, carry = [], []
    for t in range(T):
        carry.append(h)
        r, z, n, _ = _gates(gi32[t], h, w, b, H)
        if mode == "gru":
            h_new = (1.0 - z) * n + z * h
        else:
            a_t = a[:, t:t + 1]
            u = a_t * z if mode == "augru" else a_t
            h_new = (1.0 - u) * h + u * n
        m_t = m[:, t:t + 1]
        outs.append(m_t * h_new)
        h = h + m_t * (h_new - h)
    res = torch.stack(outs).to(gi.dtype), h.to(gi.dtype)
    if save_carry:
        res += (torch.stack(carry).to(gi.dtype),)
    return res


@torch.no_grad()
def gru_scan_bwd_ref(gi, carry, whh_t, bhh, mask, att=None, douts=None,
                     dh_last=None, mode="gru"):
    """Plain PyTorch version of the backward: time in reverse from ``dh =
    dh_last``, the gates recomputed from the carries, in float32, as
    ``_make_bwd_kernel`` computes them.  Arguments as :func:`gru_scan_bwd`;
    returns ``(dgi [T, B, 3H] in gi's dtype, dwhh [H, 3H] float32, dbhh
    [3H] float32, datt [B, T] in att's dtype or None)``."""
    _check(gi, whh_t, bhh, mask, att, mode)
    _check_bwd(gi, carry, douts, dh_last)
    T, B, H3 = gi.shape
    H = H3 // 3
    f32 = torch.float32
    gi32, hs, w, b = gi.to(f32), carry.to(f32), whh_t.to(f32), bhh.to(f32)
    m = mask.to(f32)
    a = None if att is None else att.to(f32)
    dh = (torch.zeros(B, H, dtype=f32, device=gi.device) if dh_last is None
          else dh_last.to(f32))
    dgi = torch.empty(T, B, H3, dtype=f32, device=gi.device)
    dw = torch.zeros(H, H3, dtype=f32, device=gi.device)
    db = torch.zeros(H3, dtype=f32, device=gi.device)
    datt = None if a is None else torch.zeros(B, T, dtype=f32,
                                              device=gi.device)
    for t in reversed(range(T)):
        h = hs[t]
        r, z, n, h_n = _gates(gi32[t], h, w, b, H)
        m_t = m[:, t:t + 1]
        g = m_t * (dh if douts is None else dh + douts[t].to(f32))
        if mode == "gru":
            dn = g * (1.0 - z)
            dz = g * (h - n)
            dh_direct = g * z
        else:
            a_t = a[:, t:t + 1]
            u = a_t * z if mode == "augru" else a_t
            dn = g * u
            du = g * (n - h)
            dh_direct = g * (1.0 - u)
            if mode == "augru":
                datt[:, t] = torch.sum(du * z, dim=1)
                dz = du * a_t
            else:
                datt[:, t] = torch.sum(du, dim=1)
                dz = torch.zeros_like(du)
        d_n = dn * (1.0 - n * n)
        d_z = dz * z * (1.0 - z)
        d_r = d_n * h_n * r * (1.0 - r)
        d_gh = torch.cat([d_r, d_z, d_n * r], dim=1)
        dgi[t] = torch.cat([d_r, d_z, d_n], dim=1)
        dh = (1.0 - m_t) * dh + dh_direct + d_gh @ w.t()
        dw += h.t() @ d_gh
        db += d_gh.sum(dim=0)
    return (dgi.to(gi.dtype), dw, db,
            None if datt is None else datt.to(att.dtype))


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


def _check_bwd(gi, carry, douts, dh_last):
    T, B, H3 = gi.shape
    H = H3 // 3
    for name, t, shape in (("carry", carry, (T, B, H)),
                           ("douts", douts, (T, B, H)),
                           ("dh_last", dh_last, (B, H))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError("%s must be %s, got %s"
                             % (name, list(shape), tuple(t.shape)))
        if t.device != gi.device:
            raise ValueError("%s lies on %s, gi on %s"
                             % (name, t.device, gi.device))
    if carry.dtype != gi.dtype:
        raise ValueError("carry must have gi's dtype %s, got %s"
                         % (gi.dtype, carry.dtype))


def _kernel(lib=None):
    """gru_scan_fwd of ``lib`` (the built csrc/gru_scan.cu by default),
    its argument types declared."""
    lib = _build.load("gru_scan") if lib is None else lib
    fn = lib.gru_scan_fwd
    fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def _bwd_kernel(lib=None):
    """gru_scan_bwd_scratch and gru_scan_bwd of ``lib`` (the built
    csrc/gru_scan_bwd.cu by default), their argument types declared."""
    lib = _build.load("gru_scan_bwd") if lib is None else lib
    scratch = lib.gru_scan_bwd_scratch
    scratch.argtypes = [ctypes.c_int] * 3
    scratch.restype = ctypes.c_longlong
    fn = lib.gru_scan_bwd
    ll, ptr = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = ([ctypes.c_int] * 3 + [ptr, ll, ll]
                   + [ptr] * 6 + [ctypes.c_int]
                   + [ptr, ll, ll, ptr, ll]
                   + [ctypes.c_int] * 3
                   + [ptr, ll, ll] + [ptr] * 5)
    fn.restype = ctypes.c_int
    return scratch, fn


def _kernel_inputs(gi, whh_t, bhh, mask, att):
    """The weights, mask and scores as the kernels read them: float32
    contiguous weights, a bool mask, float32 or gi-typed scores."""
    f32 = torch.float32
    w = whh_t.detach().to(f32).contiguous()
    b = bhh.detach().to(f32).contiguous()
    m = (mask if mask.dtype == torch.bool else mask != 0).contiguous()
    a = None
    if att is not None:
        a = att.detach()
        a = (a if a.dtype in (f32, gi.dtype) else a.to(f32)).contiguous()
    return w, b, m, a


def _raise_on(rc, what, H):
    if rc == _DOES_NOT_FIT:
        raise ValueError("%s takes hidden sizes up to 1024, got %d"
                         % (what, H))
    if rc != 0:
        raise RuntimeError("%s kernel launch failed with CUDA error %d"
                           % (what, rc))


def launch(gi, whh_t, bhh, mask, att, mode, save_carry):
    """The forward kernel on CUDA tensors (the op's CUDA implementation):
    -> ``(outs [B, T, H], h_last [B, H], carry [T, B, H] or [0])`` in gi's
    dtype; checks what the kernel takes, launches it and counts the
    launch."""
    global GRU_SCAN_LAUNCHES
    if gi.device.type != "cuda":
        raise ValueError("no gru_scan kernel for device %s" % gi.device)
    if gi.stride(2) != 1:
        raise ValueError("gru_scan needs gi's last dimension contiguous")
    T, B, H3 = gi.shape
    H = H3 // 3
    out = torch.empty(B, T, H, dtype=gi.dtype, device=gi.device)
    h_last = torch.empty(B, H, dtype=gi.dtype, device=gi.device)
    carry = (torch.empty(T, B, H, dtype=gi.dtype, device=gi.device)
             if save_carry else gi.new_empty(0))
    if B == 0:
        return out, h_last, carry
    w, b, m, a = _kernel_inputs(gi, whh_t, bhh, mask, att)
    with torch.cuda.device(gi.device):
        stream = torch.cuda.current_stream(gi.device).cuda_stream
        rc = _kernel()(
            _DTYPES[gi.dtype], MODES[mode], gi.data_ptr(), gi.stride(0),
            gi.stride(1), w.data_ptr(), b.data_ptr(), m.data_ptr(),
            None if a is None else a.data_ptr(),
            int(a is not None and a.dtype == torch.bfloat16), B, T, H,
            out.data_ptr(), out.stride(1), out.stride(0), h_last.data_ptr(),
            carry.data_ptr() if save_carry else None, stream)
    _raise_on(rc, "gru_scan", H)
    GRU_SCAN_LAUNCHES += 1
    return out, h_last, carry


def plain(gi, whh_t, bhh, mask, att, mode, save_carry):
    """:func:`gru_scan_ref` in the op's layout (its CPU implementation):
    ``(outs [B, T, H] contiguous, h_last, carry or [0])``."""
    res = gru_scan_ref(gi, whh_t, bhh, mask, att, mode, save_carry)
    carry = res[2] if save_carry else gi.new_empty(0)
    return res[0].transpose(0, 1).contiguous(), res[1], carry


def gru_scan(gi, whh_t, bhh, mask, att=None, mode="gru"):
    """The masked recurrence of every row in one launch.

    gi    [T, B, 3H]  input gates (x @ W_ih^T + b_ih), float32 or bfloat16;
                      any strides with a contiguous last dimension
    whh_t [H, 3H]     recurrent weight, transposed (gh = h @ whh_t + bhh)
    bhh   [3H]
    mask  [B, T]      0/1 (or bool): step t updates row b iff mask[b, t]
    att   [B, T]      attention scores (modes agru and augru only)

    Returns ``(outs [T, B, H], h_last [B, H])`` in gi's dtype; padded steps
    emit zero rows and keep the carry.  Any B >= 1 and T >= 1.  Runs the
    ``deepctr_tpu_torch::gru_scan`` op (``ops/library.py``): on CUDA
    tensors it launches the kernel (building it at first use) or raises, on
    CPU tensors it is the plain version.  The kernel takes H <= 1024;
    ``outs`` is a ``[T, B, H]`` view of a contiguous ``[B, T, H]``.  The
    kernel reads float32 weights, a bool mask and float32 or gi-typed scores
    as they are; other types are cast first.  While autograd records
    through gi, whh_t, bhh or att, the call runs as :class:`GruScan` on
    CUDA tensors, whose backward is the backward kernel, and as the plain
    version, which autograd differentiates, on CPU tensors."""
    _check(gi, whh_t, bhh, mask, att, mode)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (gi, whh_t, bhh, att)):
        if gi.device.type == "cpu":
            return gru_scan_ref(gi, whh_t, bhh, mask, att, mode)
        return GruScan.apply(gi, whh_t, bhh, mask, att, mode)
    outs, h_last, _ = torch.ops.deepctr_tpu_torch.gru_scan(
        gi, whh_t, bhh, mask, att, mode, False)
    return outs.transpose(0, 1), h_last


def gru_scan_with_carry(gi, whh_t, bhh, mask, att=None, mode="gru"):
    """The training forward: :func:`gru_scan`'s ``(outs, h_last)`` and the
    carries ``[T, B, H]`` (``h_{t-1}`` before step t, rounded to gi's
    dtype), from the ``deepctr_tpu_torch::gru_scan`` op: on CUDA tensors
    one launch of the forward kernel, which writes them besides; on CPU
    tensors ``gru_scan_ref(..., save_carry=True)``.  Records no graph."""
    _check(gi, whh_t, bhh, mask, att, mode)
    with torch.no_grad():
        outs, h_last, carry = torch.ops.deepctr_tpu_torch.gru_scan(
            gi, whh_t, bhh, mask, att, mode, True)
    return outs.transpose(0, 1), h_last, carry


def gru_scan_bwd(gi, carry, whh_t, bhh, mask, att=None, douts=None,
                 dh_last=None, mode="gru"):
    """The recurrence's backward in one call (three launches: the reverse
    scan, the dW_hh product and its reduction).

    gi, whh_t, bhh, mask, att as :func:`gru_scan`; carry [T, B, H] from
    :func:`gru_scan_with_carry`; douts [T, B, H] and dh_last [B, H], the
    cotangents of ``outs`` and ``h_last`` (gi's dtype, any strides with a
    contiguous last dimension; None for zero).  Returns ``(dgi [T, B, 3H]
    in gi's dtype (a view of a contiguous [B, T, 3H]), dwhh [H, 3H]
    float32, dbhh [3H] float32, datt [B, T] in the scores' dtype as the
    kernel reads them, or None)``; dwhh and dbhh are summed in a fixed
    order, so a repeat gives the same bits.  On CPU tensors it is
    :func:`gru_scan_bwd_ref`."""
    if gi.device.type == "cpu":
        return gru_scan_bwd_ref(gi, carry, whh_t, bhh, mask, att, douts,
                                dh_last, mode)
    run, result = gru_scan_bwd_launcher(gi, carry, whh_t, bhh, mask, att,
                                        douts, dh_last, mode)
    run(BWD_SCAN | BWD_DW)
    return result


# the backward's launches, for gru_scan_bwd_launcher's ``run(parts)``: the
# reverse scan (which writes dgi, d(att) and the d_gh scratch), and the
# dW_hh product with its reduction (which reads that scratch)
BWD_SCAN = 1
BWD_DW = 2


def gru_scan_bwd_launcher(gi, carry, whh_t, bhh, mask, att=None, douts=None,
                          dh_last=None, mode="gru"):
    """:func:`gru_scan_bwd` on CUDA tensors, split so that its launches can
    be timed apart: returns ``(run, result)``, where ``run(parts)``
    launches the parts named by ``parts`` (``BWD_SCAN``, ``BWD_DW`` or
    both) into the outputs of ``result``, which hold the backward once
    both have run, the scan first."""
    _check(gi, whh_t, bhh, mask, att, mode)
    _check_bwd(gi, carry, douts, dh_last)
    if gi.device.type != "cuda":
        raise ValueError("no gru_scan_bwd kernel for device %s" % gi.device)
    if gi.stride(2) != 1:
        raise ValueError("gru_scan_bwd needs gi's last dimension contiguous")
    T, B, H3 = gi.shape
    H = H3 // 3
    dev = gi.device
    w, b, m, a = _kernel_inputs(gi, whh_t, bhh, mask, att)
    carry = carry.contiguous()
    cots = []
    for t in (douts, dh_last):
        if t is not None:
            t = t.detach().to(gi.dtype)
            if t.stride(-1) != 1:
                t = t.contiguous()
        cots.append(t)
    douts, dh_last = cots
    dgi = torch.empty(B, T, H3, dtype=gi.dtype, device=dev).transpose(0, 1)
    dwhh = torch.empty(H, H3, dtype=torch.float32, device=dev)
    dbhh = torch.empty(H3, dtype=torch.float32, device=dev)
    datt = None if a is None else torch.empty(B, T, dtype=a.dtype,
                                              device=dev)
    result = dgi, dwhh, dbhh, datt
    if B == 0:
        dwhh.zero_()
        dbhh.zero_()
        return (lambda parts: None), result
    scratch_fn, fn = _bwd_kernel()
    scratch = torch.empty(scratch_fn(B, T, H), dtype=torch.float32,
                          device=dev)
    whh = w.t().contiguous()

    def run(parts):
        global GRU_SCAN_BWD_LAUNCHES
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(
                parts, _DTYPES[gi.dtype], MODES[mode], gi.data_ptr(),
                gi.stride(0), gi.stride(1), carry.data_ptr(), w.data_ptr(),
                whh.data_ptr(), b.data_ptr(), m.data_ptr(),
                None if a is None else a.data_ptr(),
                int(a is not None and a.dtype == torch.bfloat16),
                None if douts is None else douts.data_ptr(),
                0 if douts is None else douts.stride(0),
                0 if douts is None else douts.stride(1),
                None if dh_last is None else dh_last.data_ptr(),
                0 if dh_last is None else dh_last.stride(0), B, T, H,
                dgi.data_ptr(), dgi.stride(0), dgi.stride(1),
                dwhh.data_ptr(), dbhh.data_ptr(),
                None if datt is None else datt.data_ptr(),
                scratch.data_ptr(), stream)
        _raise_on(rc, "gru_scan_bwd", H)
        if parts & BWD_SCAN:
            GRU_SCAN_BWD_LAUNCHES += 1

    return run, result


class GruScan(torch.autograd.Function):
    """:func:`gru_scan` with its backward: the forward runs
    :func:`gru_scan_with_carry` and keeps the carries, the backward runs
    :func:`gru_scan_bwd` on them, as ``_scan_noatt``/``_scan_att`` pair
    ``_fwd_call`` with ``_bwd_call``.  An output whose cotangent is absent
    (MaskedGRU's ``h_last`` in DIEN's extractor, DynamicGRU's ``outs``)
    reaches the kernel as a null pointer, not as zeros.  dW_hh and db_hh
    come back in the dtype of ``whh_t`` and ``bhh``, the scores'
    cotangent in the dtype of ``att``."""

    @staticmethod
    def forward(ctx, gi, whh_t, bhh, mask, att, mode):
        outs, h_last, carry = gru_scan_with_carry(gi, whh_t, bhh, mask, att,
                                                  mode)
        ctx.mode = mode
        ctx.has_att = att is not None
        ctx.save_for_backward(gi, carry, whh_t, bhh, mask,
                              *(() if att is None else (att,)))
        ctx.set_materialize_grads(False)
        return outs, h_last

    @staticmethod
    def backward(ctx, douts, dh_last):
        gi, carry, whh_t, bhh, mask, *rest = ctx.saved_tensors
        att = rest[0] if ctx.has_att else None
        dgi, dwhh, dbhh, datt = gru_scan_bwd(gi, carry, whh_t, bhh, mask, att,
                                             douts, dh_last, ctx.mode)
        return (dgi, dwhh.to(whh_t.dtype), dbhh.to(bhh.dtype), None,
                None if datt is None else datt.to(att.dtype), None)
