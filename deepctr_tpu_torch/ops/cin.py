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
and whose backward runs from the saved inputs inside the span
``cin.backward``.  Where ``bwd_route`` says "mma" (bfloat16 operands, a
bfloat16 cotangent, tiles that fit shared memory: ``bwd_plan``) it is the
hand-written backward of ``csrc/cin_mix_bwd.cu`` (``bwd_launch``: dh and
dx from dz formed on chip, dwt from z formed on chip, neither written to
device memory; ``cin_mix_bwd_mma_ref`` is its plain version).  Elsewhere
(float32 operands, the CIN's carry mode, whose float32 cotangent enters
the products unrounded as the JAX transposes of a
``preferred_element_type`` product take it, and tiles too large) it is
``_cin_mix_bwd``'s explicit contractions (``cin_mix_bwd``), in the
operands' dtype.
"""

import ctypes
import functools

import torch

from . import _build
from .reference import cin_mix_ref
from ..tracing import span

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ROUTE = _build.Fn("cin_mix", "cin_mix_route", [_I] * 4)
# the dtype codes: (operands, output) for the FMA kernel, the output's for
# the tensor-core one
_FWD = {"fma": _build.Fn("cin_mix", "cin_mix_fwd", [
            _I, _I, _P, _LL, _P, _LL, _P, _P, _LL, _I, _I, _I, _P]),
        "mma": _build.Fn("cin_mix", "cin_mix_mma_fwd", [
            _I, _P, _LL, _P, _LL, _P, _P, _LL, _I, _I, _I, _P])}
_BWD_PLAN = _build.Fn("cin_mix_bwd", "cin_mix_bwd_plan",
                      [_I] * 3 + [ctypes.POINTER(_I)])
# the backward's kernels (launches counted as ``cin_mix_bwd``: seven a
# CinMix backward on its "mma" route, four tilings, data, weight, reduce)
_BWD = {name: _build.Fn("cin_mix_bwd", name, argtypes) for name, argtypes in (
    ("cin_mix_bwd_tile", [_P, _LL, _LL, _I, _P, _I, _I, _I, _I, _LL, _I, _I,
                          _I, _I, _P]),
    ("cin_mix_bwd_data", [_P, _I, _P, _P, _LL, _P, _LL, _P, _P, _LL, _I, _I,
                          _I, _I, _I, _I, _I, _P]),
    ("cin_mix_bwd_weight", [_P, _I, _P, _P, _P, _LL, _I, _I, _I, _I, _LL, _I,
                            _I, _I, _P]),
    ("cin_mix_bwd_reduce", [_P, _P, _LL, _I, _P]))}


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
    return "mma" if _ROUTE(code, H, F, O) else "fma"


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
    kind = route(dtype, H, F, O)
    if kind == "mma":
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
        args = (_DTYPES[out_dtype],) + args + (wm.data_ptr(),)
    else:
        args = (_DTYPES[dtype], _DTYPES[out_dtype]) + args + (wt.data_ptr(),)
    _FWD[kind].launch(hidden_t.device, *args, out.data_ptr(), B * D, H, F, O,
                      count="cin_mix")
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


# bwd_plan's keys, in the order cin_mix_bwd_plan writes them
_PLAN = ("NT", "nch", "FG", "XF", "stages", "NO", "hb_log2", "FB",
         "w_stages")


@functools.lru_cache(maxsize=None)
def bwd_plan(H, F, O):
    """The backward kernels' tiling at (H, F, O), as
    ``csrc/cin_mix_bwd.cu:cin_mix_bwd_plan`` chooses it, or None where a
    tile does not fit shared memory: the data kernel takes H in ``nch``
    chunks of ``NT`` maps, ``FG`` fields a product, x's rows at stride
    ``XF``; the weight kernel takes O in blocks of ``NO`` columns and dwt's
    rows in tiles of 2^``hb_log2`` maps by ``FB`` fields; ``stages`` and
    ``w_stages`` ring stages.  Builds the kernel library at first use: a
    question for CUDA tensors only.  Do not modify the dict it returns."""
    out = (ctypes.c_int * len(_PLAN))()
    return dict(zip(_PLAN, out)) if _BWD_PLAN(H, F, O, out) else None


def bwd_route(dtype, g_dtype, H, F, O):
    """"mma" where CinMix's backward takes the hand-written kernels:
    bfloat16 operands, a cotangent in the operands' dtype (the CIN's "bf16"
    mode) and tiles that fit shared memory (``bwd_plan``; a block's rows of
    g are staged whole, so O = 1024 does not); else "einsum"
    (``cin_mix_bwd``: float32 compute, the carry mode's float32 cotangent,
    rows of g too wide).  A pure function of its arguments; asks
    ``bwd_plan`` only where the dtypes would take the kernels."""
    if (dtype != torch.bfloat16 or g_dtype != dtype
            or bwd_plan(H, F, O) is None):
        return "einsum"
    return "mma"


def weight_splits(M, H, F, O, plan, n_sms):
    """``(rows_per_split, splits)`` of the weight kernel over M rows, each
    split a whole number of 64-row chunks: the fewest splits (at most 64)
    whose blocks, one an SM, fill 95% of their waves, else the best
    filled."""
    HB = 1 << plan["hb_log2"]
    tiles = -(-H // HB) * -(-F // plan["FB"]) * -(-O // plan["NO"])
    chunks = -(-M // 64)
    best = None
    for want in range(1, min(chunks, 64) + 1):
        rows = -(-chunks // want) * 64
        splits = -(-M // rows)
        blocks = tiles * splits
        fill = blocks / (-(-blocks // n_sms) * n_sms)
        if fill >= 0.95:
            return rows, splits
        if best is None or fill > best[0]:
            best = (fill, rows, splits)
    return best[1], best[2]


def cin_mix_bwd_mma_ref(hidden_t, x0_t, wt, g, rows_per_split=None):
    """Plain version of the backward kernels' arithmetic, from the forward's
    inputs and g [B, D, O] in their dtype: a field at a time, dz = g wt_f^T
    (a float32 sum) rounded to the dtype, dh summed over the fields in
    order and dx over the maps in float32; z rounded to the dtype and dwt's
    float32 sums over splits of ``rows_per_split`` rows (all in one by
    default) added in split order; each output rounded once.  -> (dh, dx,
    dwt [F*H, O])."""
    B, D, H = hidden_t.shape
    F = x0_t.shape[2]
    O = g.shape[2]
    M = B * D
    dtype = hidden_t.dtype
    h = hidden_t.reshape(M, H).float()
    x = x0_t.reshape(M, F).float()
    gg = g.reshape(M, O).float()
    w = wt.float().reshape(F, H, O)
    dh = torch.zeros(M, H)
    dx = torch.empty(M, F)
    for f in range(F):
        dz = torch.matmul(gg, w[f].t()).to(dtype).float()
        dh += dz * x[:, f:f + 1]
        dx[:, f] = (dz * h).sum(1)
    z = (x[:, :, None] * h[:, None, :]).to(dtype).float().reshape(M, F * H)
    step = rows_per_split or max(M, 1)
    dwt = torch.zeros(F * H, O)
    for lo in range(0, M, step):
        dwt = dwt + torch.matmul(z[lo:lo + step].t(), gg[lo:lo + step])
    return (dh.to(dtype).reshape(B, D, H), dx.to(dtype).reshape(B, D, F),
            dwt.to(dtype))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def bwd_launch(hidden_t, x0_t, wt, g):
    """The backward kernels on CUDA tensors, for shapes ``bwd_route`` sends
    to them: hidden_t [B, D, H] and x0_t [B, D, F] at a row stride each
    (``_rows``), wt [F*H, O] and g [B, D, O], all bfloat16 -> (dh, dx, dwt
    [F*H, O]) in bfloat16.  Seven launches (the tiles of g, wt, hid and x,
    the data and weight products, the partials' sum), counted in
    ``_build.LAUNCHES["cin_mix_bwd"]``; no host sync."""
    B, D, H = hidden_t.shape
    F = x0_t.shape[2]
    O = wt.shape[1]
    M = B * D
    dev = hidden_t.device
    plan = bwd_plan(H, F, O)
    if (plan is None or dev.type != "cuda" or any(
            t.dtype != torch.bfloat16 or t.device != dev
            for t in (hidden_t, x0_t, wt, g))
            or tuple(g.shape) != (B, D, O) or tuple(wt.shape) != (F * H, O)):
        raise ValueError("cin_mix's backward kernels take bfloat16 CUDA "
                         "tensors of one device at shapes bwd_plan tiles, got "
                         "%s %s, %s %s, %s %s and g %s %s"
                         % (hidden_t.dtype, tuple(hidden_t.shape), x0_t.dtype,
                            tuple(x0_t.shape), wt.dtype, tuple(wt.shape),
                            g.dtype, tuple(g.shape)))
    dh = torch.empty(B, D, H, dtype=torch.bfloat16, device=dev)
    dx = torch.empty(B, D, F, dtype=torch.bfloat16, device=dev)
    dwt = torch.empty(F * H, O, dtype=torch.bfloat16, device=dev)
    if M == 0:
        return dh, dx, dwt.zero_()
    if _rows(hidden_t) is None:
        hidden_t = hidden_t.contiguous()
    if _rows(x0_t) is None:
        x0_t = x0_t.contiguous()
    ld_h, ld_x = _rows(hidden_t), _rows(x0_t)
    g2 = g.reshape(M, O)
    if g2.stride(1) != 1:
        g2 = g2.contiguous()
    wt = wt.contiguous()
    NT, nch, NO = plan["NT"], plan["nch"], plan["NO"]
    nkc = -(-O // 64)
    # the operands as the kernels' shared-memory tiles, each copied whole
    # by the TMA: g's [64, 64] (both kernels'), wt's [FG * NT, 64] of FG
    # fields and an H chunk (the data kernel's), hid's [64, HB] and x's
    # [64, 8] of the weight kernel's HB maps and 128 / HB fields
    gcols = -(-O // NO) * -(-NO // 64)
    FG, FB = plan["FG"], plan["FB"]
    nfg = -(-F // FG)
    HB = 1 << plan["hb_log2"]
    nhb, nfb, nrt = -(-H // HB), -(-F // FB), -(-M // 64)
    gt = _bf16(nrt * gcols * 64 * 64, dev)
    wtl = _bf16(nch * nfg * nkc * FG * NT * 64, dev)
    ht = _bf16(nrt * nhb * 64 * HB, dev)
    xt = _bf16(nrt * nfb * 64 * 8, dev)
    rows, splits = weight_splits(M, H, F, O, plan,
                                 _sm_count(dev.index if dev.index is not None
                                           else torch.cuda.current_device()))
    part = torch.empty(splits, F * H, O, dtype=torch.float32, device=dev)
    tile = "cin_mix_bwd_tile"
    tiles = (
        # src, ld, rows, cols, dst, TR, CW, SCW, swz, tiles, column tiles,
        # and wt's fields: field_rows, fields, chunk
        (tile, (g2.data_ptr(), g2.stride(0), M, O, gt.data_ptr(), 64, 64, 64,
                1, nrt, gcols, 0, 0, 0)),
        (tile, (wt.data_ptr(), O, F * H, O, wtl.data_ptr(), FG * NT, 64, 64,
                1, nch * nfg, nkc, H, F, NT)),
        (tile, (hidden_t.data_ptr(), ld_h, M, H, ht.data_ptr(), 64, HB, HB, 0,
                nrt, nhb, 0, 0, 0)),
        (tile, (x0_t.data_ptr(), ld_x, M, F, xt.data_ptr(), 64, 8, FB, 0, nrt,
                nfb, 0, 0, 0)))
    data = ("cin_mix_bwd_data", (
        gt.data_ptr(), gcols, wtl.data_ptr(), hidden_t.data_ptr(), ld_h,
        x0_t.data_ptr(), ld_x, dh.data_ptr(), dx.data_ptr(), M, H, F, O, NT,
        nch, plan["XF"], plan["stages"]))
    weight = ("cin_mix_bwd_weight", (
        gt.data_ptr(), gcols, ht.data_ptr(), xt.data_ptr(), part.data_ptr(),
        M, H, F, O, NO, rows, splits, plan["hb_log2"], plan["w_stages"]))
    reduce = ("cin_mix_bwd_reduce", (part.data_ptr(), dwt.data_ptr(),
                                     F * H * O, splits))
    with torch.cuda.device(dev):
        # g's tiles, then the weight product's kernels on a second stream
        # beside the data product's, so that each fills the other's last
        # wave; every tensor is made on the current stream, which waits for
        # the second before it returns
        main = torch.cuda.current_stream(dev)
        _bwd_calls(tiles[:1], main)
        side = _side_stream(dev)
        side.wait_stream(main)
        _bwd_calls((tiles[1], data), main)
        _bwd_calls(tiles[2:] + (weight, reduce), side)
        main.wait_stream(side)
    return dh, dx, dwt


def _bf16(n, dev):
    return torch.empty(n, dtype=torch.bfloat16, device=dev)


@functools.lru_cache(maxsize=None)
def _side_stream(dev):
    return torch.cuda.Stream(dev)


def _bwd_calls(calls, stream):
    for name, args in calls:
        _BWD[name].launch(stream.device, *args, stream=stream,
                          count="cin_mix_bwd")


class CinMix(torch.autograd.Function):
    """The ``deepctr_tpu_torch::cin_mix`` op's forward (the kernel) on CUDA
    tensors; its backward is :func:`bwd_launch`'s kernels on
    :func:`bwd_route`'s "mma" route, else the contractions of
    :func:`cin_mix_bwd`.  Saves only its inputs.  ``w3`` reaches the op,
    whose CPU version reads it; the gradient goes to ``wt``, from which
    autograd carries it to ``w3``."""

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
        g = g.to(ctx.out_dtype)
        with span("cin.backward"):
            if bwd_route(hidden_t.dtype, g.dtype, hidden_t.shape[2],
                         x0_t.shape[2], wt.shape[1]) == "mma":
                dh, dx, dwt = bwd_launch(hidden_t, x0_t, wt, g)
            else:
                _build.LAUNCHES["cin_mix_bwd_einsum"] += 1
                dh, dx, dwt = cin_mix_bwd(hidden_t, x0_t, wt, g)
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
