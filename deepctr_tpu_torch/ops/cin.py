"""Fused CIN layer of xDeepFM, D-major.

The port's counterpart of ``deepctr_tpu/ops/pallas.py`` (``cin_mix``, the
kernel ``_cin_pallas_fwd``)::

    out[b, d, o] = sum_{h, f} w3[o, h, f] * hidden_t[b, d, h] * x0_t[b, d, f]

at the operands' dtype: the outer product ``z = h * x`` is rounded to it,
the sum over ``K = H * F`` is float32 and is rounded once to the output's
dtype: the operands', or float32 from bfloat16 operands (``out_dtype``,
the CIN's ``carry`` mode, the JAX einsum's ``preferred_element_type``),
which writes the float32 sum unrounded on either route.

``cin_mix`` runs the ``deepctr_tpu_torch::cin_mix`` op
(``ops/library.py``), which launches the CUDA kernel in ``csrc/cin_mix.cu``
for CUDA tensors, for every layer and every shape, or raises, and takes the
plain version ``cin_mix_ref`` only because its tensors lie on the CPU
(where, while autograd records, the wrapper calls the plain version
itself, for autograd to differentiate).  The JAX package's
``cin_mix_supported`` gate (lane-aligned H, B a multiple of 8, a VMEM
estimate) is a TPU tiling rule and has no counterpart here.

bfloat16 operands whose rows fit the tensor-core kernel (``route``) take
the weight as ``mma_weight`` lays it out: ``[Op, F*Hp]``, K contiguous,
each field's H rows padded with zeros to a multiple of 16 and O to a
multiple of 8, so that every 16-deep step of the product lies in one field
and the rows meet TMA's 16-byte strides.  ``cin_mix_mma_ref`` is the plain
version of the product in that layout.  float32, and bfloat16 rows too
wide for the kernel's shared memory, take ``kernel_weight``'s ``[F*H, O]``
in the FMA kernel.

Unlike the JAX package, which runs its kernel only at inference unless
``set_use_pallas(True)``, the port runs it in training too: while autograd
records, ``cin_mix`` runs as :class:`CinMix`, whose forward is the kernel
and whose backward is ``_cin_mix_bwd``'s explicit contractions
(``cin_mix_bwd``), in the operands' dtype, from the saved inputs; a
float32 cotangent of a float32 output from bfloat16 operands enters its
products unrounded, as the JAX transposes of a ``preferred_element_type``
product take it.  The backward runs inside the span ``cin.backward``.
"""

import ctypes
import functools

import torch

from . import _build
from .reference import cin_mix_ref
from ..tracing import span

# kernel launches since import (or since a caller reset it to 0); counts
# only launches of the CUDA kernel, never the plain version
CIN_MIX_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_weight(w3, dtype):
    """The kernel's weight layout: ``wt [F*H, O]`` with ``wt[f*H + h, o] =
    w3[o, h, f]``, in ``dtype``, contiguous.  Differentiable."""
    O, H, F = w3.shape
    return w3.permute(2, 1, 0).reshape(F * H, O).to(dtype).contiguous()


def _round_up(v, m):
    return -(-v // m) * m


def mma_weight(wt, H, F):
    """The tensor-core kernel's weight layout from ``wt = kernel_weight(w3,
    dtype)`` [F*H, O]: ``wm [Op, F*Hp]`` with ``wm[o, f*Hp + h] = wt[f*H +
    h, o]`` for h < H and o < O, zeros elsewhere; Hp = H rounded up to 16,
    Op = O rounded up to 8.  Contiguous, in wt's dtype."""
    O = wt.shape[1]
    Hp, Op = _round_up(H, 16), _round_up(O, 8)
    w = wt.reshape(F, H, O).permute(2, 0, 1)                    # [O, F, H]
    w = torch.nn.functional.pad(w, (0, Hp - H, 0, 0, 0, Op - O))
    return w.reshape(Op, F * Hp).contiguous()


def cin_mix_mma_ref(hidden_t, x0_t, wm, O):
    """Plain version of the product in ``mma_weight``'s layout:
    hidden_t [B, D, H] padded with zero maps to Hp, z = x * h rounded to
    the operands' dtype, the float32 sum over F*Hp rounded once, the first
    O columns."""
    B, D, H = hidden_t.shape
    F = x0_t.shape[2]
    Hp = wm.shape[1] // F
    h = torch.nn.functional.pad(hidden_t, (0, Hp - H))
    z = (x0_t[..., :, None] * h[..., None, :]).reshape(B, D, F * Hp)
    out = torch.matmul(z.float(), wm.float().t())[..., :O]
    return out.to(hidden_t.dtype)


def route(dtype, H, F, O):
    """"mma" where the tensor-core kernel takes these shapes (bfloat16
    rows that fit its shared memory), else "fma".  Builds the kernel
    library at first use: a question for CUDA tensors only."""
    return _route(_DTYPES.get(dtype, -1), H, F, O)


@functools.lru_cache(maxsize=None)
def _route(code, H, F, O):
    fn = _build.load("cin_mix").cin_mix_route
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return "mma" if fn(code, H, F, O) else "fma"


def kernel_weights(w3, dtype):
    """What the kernel of ``w3 [O, H, F]``'s route at ``dtype`` reads:
    ``(kernel_weight, mma_weight or None)``, for a caller that keeps them
    between calls on CUDA tensors.  The second carries no graph."""
    O, H, F = w3.shape
    wt = kernel_weight(w3, dtype)
    wm = None
    if route(dtype, H, F, O) == "mma":
        with torch.no_grad():
            wm = mma_weight(wt.detach(), H, F)
    return wt, wm


def _check(hidden_t, x0_t, w3):
    if hidden_t.dim() != 3 or x0_t.dim() != 3 or w3.dim() != 3:
        raise ValueError("cin_mix takes hidden_t [B, D, H], x0_t [B, D, F] "
                         "and w3 [O, H, F], got %s, %s and %s"
                         % (tuple(hidden_t.shape), tuple(x0_t.shape),
                            tuple(w3.shape)))
    B, D, H = hidden_t.shape
    F = x0_t.shape[2]
    if tuple(x0_t.shape[:2]) != (B, D) or tuple(w3.shape[1:]) != (H, F):
        raise ValueError("cin_mix: hidden_t %s, x0_t %s and w3 %s do not "
                         "agree" % (tuple(hidden_t.shape),
                                    tuple(x0_t.shape), tuple(w3.shape)))
    devices = {t.device for t in (hidden_t, x0_t, w3)}
    if len(devices) != 1:
        raise ValueError("cin_mix's tensors must be on one device, got %s"
                         % sorted(map(str, devices)))


def _rows(t):
    """The row stride of a [B, D, n] tensor whose (b, d) rows lie at one
    stride with contiguous rows, else None."""
    if t.stride(2) != 1 and t.shape[2] > 1:
        return None
    if t.shape[0] > 1 and t.stride(0) != t.shape[1] * t.stride(1):
        return None
    ld = t.stride(1) if t.shape[1] > 1 else (
        t.stride(0) if t.shape[0] > 1 else t.shape[2])
    return ld if ld >= t.shape[2] else None


def _kernel(name):
    fn = getattr(_build.load("cin_mix"), name)
    # the dtype codes: (operands, output) for the FMA kernel, the output's
    # for the tensor-core one
    fn.argtypes = [ctypes.c_int] * (2 if name == "cin_mix_fwd" else 1) + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _out_dtype(dtype, out_dtype):
    """The output's dtype: ``dtype`` (the operands') by default, or
    float32."""
    if out_dtype is None or out_dtype == dtype:
        return dtype
    if out_dtype != torch.float32:
        raise ValueError("cin_mix writes its operands' dtype or float32, "
                         "got out_dtype %s for %s operands"
                         % (out_dtype, dtype))
    return out_dtype


def launch(hidden_t, x0_t, wt, wm=None, out_dtype=None):
    """The kernel on CUDA tensors (the op's CUDA implementation): -> [B, D,
    O] in ``out_dtype`` (hidden_t's dtype by default, or float32); checks
    what the kernel takes, launches it and counts the launch.  The
    tensor-core route takes ``wm`` (``mma_weight`` of wt), built here when
    None."""
    global CIN_MIX_LAUNCHES
    if hidden_t.device.type != "cuda":
        raise ValueError("no cin_mix kernel for device %s" % hidden_t.device)
    B, D, H = hidden_t.shape
    F = x0_t.shape[2]
    O = wt.shape[1]
    dtype = hidden_t.dtype
    if dtype not in _DTYPES or x0_t.dtype != dtype or wt.dtype != dtype:
        raise ValueError("cin_mix takes float32 or bfloat16 operands of one "
                         "dtype, got %s, %s and a weight of %s"
                         % (hidden_t.dtype, x0_t.dtype, wt.dtype))
    if tuple(wt.shape) != (F * H, O) or not wt.is_contiguous():
        raise ValueError("cin_mix: the kernel weight must be contiguous [%d, "
                         "%d], got %s" % (F * H, O, tuple(wt.shape)))
    ld_h, ld_x = _rows(hidden_t), _rows(x0_t)
    if ld_h is None or ld_x is None:
        raise ValueError("cin_mix: hidden_t and x0_t need contiguous rows at "
                         "one stride over (b, d), got strides %s and %s"
                         % (hidden_t.stride(), x0_t.stride()))
    out_dtype = _out_dtype(dtype, out_dtype)
    out = torch.empty(B, D, O, dtype=out_dtype, device=hidden_t.device)
    if B * D == 0:
        return out
    args = (hidden_t.data_ptr(), ld_h, x0_t.data_ptr(), ld_x)
    if route(dtype, H, F, O) == "mma":
        if wm is None:
            with torch.no_grad():
                wm = mma_weight(wt.detach(), H, F)
        shape = (_round_up(O, 8), F * _round_up(H, 16))
        if (tuple(wm.shape) != shape or wm.dtype != dtype
                or not wm.is_contiguous() or wm.data_ptr() % 16
                or wm.device != hidden_t.device):
            raise ValueError("cin_mix: the tensor-core weight must be "
                             "contiguous %s %s on %s, 16-byte aligned, got "
                             "%s %s" % (dtype, shape, hidden_t.device,
                                        wm.dtype, tuple(wm.shape)))
        fn = _kernel("cin_mix_mma_fwd")
        args = (_DTYPES[out_dtype],) + args + (wm.data_ptr(),)
    else:
        fn = _kernel("cin_mix_fwd")
        args = (_DTYPES[dtype], _DTYPES[out_dtype]) + args + (wt.data_ptr(),)
    with torch.cuda.device(hidden_t.device):
        stream = torch.cuda.current_stream(hidden_t.device).cuda_stream
        rc = fn(*args, out.data_ptr(), B * D, H, F, O, stream)
    if rc != 0:
        raise RuntimeError("cin_mix kernel launch failed with CUDA error %d"
                           % rc)
    CIN_MIX_LAUNCHES += 1
    return out


def cin_mix_bwd(hidden_t, x0_t, wt, g):
    """``_cin_mix_bwd``'s contractions (``pallas.py:104-117``) in the
    operands' dtype, from the forward's inputs and the cotangent g [B, D,
    O]: -> (dh [B, D, H], dx [B, D, F], dwt [F*H, O]).  A float32 g beside
    bfloat16 operands (the float32 output of the CIN's carry mode) enters
    the two products with it in float32, each rounded once to the
    operands' dtype, as JAX transposes a ``preferred_element_type``
    product."""
    B, D, H = hidden_t.shape
    F = x0_t.shape[2]
    dtype = hidden_t.dtype
    dz = torch.einsum("bdo,ko->bdk", g, wt.to(g.dtype)).to(dtype)
    dz = dz.reshape(B, D, F, H)
    dh = torch.einsum("bdfh,bdf->bdh", dz, x0_t)
    dx = torch.einsum("bdfh,bdh->bdf", dz, hidden_t)
    z = torch.einsum("bdf,bdh->bdfh", x0_t, hidden_t).reshape(B, D, F * H)
    dwt = torch.einsum("bdk,bdo->ko", z.to(g.dtype), g)
    return dh, dx, dwt.to(wt.dtype)


class CinMix(torch.autograd.Function):
    """The ``deepctr_tpu_torch::cin_mix`` op's forward (the kernel) on CUDA
    tensors, with the contractions of :func:`cin_mix_bwd` as its backward;
    saves only its inputs.  ``w3`` reaches the op, whose CPU version reads
    it; the gradient goes to ``wt``, from which autograd carries it to
    ``w3``."""

    @staticmethod
    def forward(ctx, hidden_t, x0_t, w3, wt, wm=None, out_dtype=None):
        ctx.save_for_backward(hidden_t, x0_t, wt)
        out = torch.ops.deepctr_tpu_torch.cin_mix(hidden_t, x0_t, w3, wt, wm,
                                                  out_dtype)
        ctx.out_dtype = out.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        hidden_t, x0_t, wt = ctx.saved_tensors
        with span("cin.backward"):
            dh, dx, dwt = cin_mix_bwd(hidden_t, x0_t, wt,
                                      g.to(ctx.out_dtype))
        return dh, dx, None, dwt, None, None


def cin_mix(hidden_t, x0_t, w3, wt=None, wm=None, out_dtype=None):
    """Fused CIN layer: hidden_t [B, D, H], x0_t [B, D, F], w3 [O, H, F] ->
    [B, D, O] in ``out_dtype``: hidden_t's dtype (float32 or bfloat16, all
    three alike) by default, or float32, the unrounded sum, from bfloat16
    operands.  ``wt`` and ``wm`` are ``kernel_weights(w3, dtype)`` from a
    caller that keeps them between calls; on CUDA tensors they are built
    when None.

    Runs the ``deepctr_tpu_torch::cin_mix`` op (``ops/library.py``): on
    CUDA tensors it launches the kernel (building it at first use), as
    :class:`CinMix` while autograd records, or raises; on CPU tensors it is
    the plain version, which autograd differentiates where it records.
    hidden_t and x0_t may be views whose (b, d) rows lie at one stride."""
    _check(hidden_t, x0_t, w3)
    out_dtype = _out_dtype(hidden_t.dtype, out_dtype)
    cuda = hidden_t.device.type == "cuda"
    if cuda and wt is None:
        wt = kernel_weight(w3, hidden_t.dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (hidden_t, x0_t, wt if cuda else w3)):
        if not cuda:
            return cin_mix_ref(hidden_t, x0_t, w3, out_dtype)
        return CinMix.apply(hidden_t, x0_t, w3, wt, wm, out_dtype)
    return torch.ops.deepctr_tpu_torch.cin_mix(hidden_t, x0_t, w3, wt, wm,
                                               out_dtype)
