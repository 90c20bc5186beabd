"""Fused DIN attention pooling over a behaviour history (inference).

The port's counterpart of ``deepctr_tpu/ops/pallas_attention.py``
(``din_attention_fused``): the LocalActivationUnit MLP over ``[q, k, q - k,
q * k]``, the padding mask, the softmax over T (with weight normalisation)
and the weighted sum of the keys, for every sample::

    s_t = MLP(x_t)                      hidden layers act(x @ W + b), then
                                        x @ W_out + b_out; act is sigmoid,
                                        relu or linear
    s_t = s_t * m_t + (1 - m_t) * (-2^32 + 1);  s = softmax_t(s)
                                        (or s_t = s_t * m_t without it)
    out = sum_t s_t * k_t               [B, 1, E]

The MLP, the softmax and the sum are float32 whatever the keys' type, as
in the TPU kernel; only the result is rounded to the keys' type.

``din_attention_fused`` runs the ``deepctr_tpu_torch::din_attention_fused``
op (``ops/library.py``), which launches the CUDA kernel in
``csrc/din_attention.cu`` for CUDA tensors, or raises, and takes the plain
version ``din_attention_fused_ref`` only because its tensors lie on the
CPU.  The kernel has no backward: training runs the layer composition.  The
kernel has two designs, chosen by shape (:func:`route`): the MLP on the
tensor cores in a TF32 split that keeps float32 accuracy, and float32
FMAs for shapes whose weights do not fit in a block's shared memory or
whose hidden layers are wider than 128; both read :func:`pack_params`.
"""

import ctypes

import torch

from . import _build

# kernel launches since import (or since a caller reset it to 0); counts
# only launches of the CUDA kernel, never the plain version
DIN_ATTENTION_LAUNCHES = 0

ACTIVATIONS = {"sigmoid": 0, "relu": 1, "linear": 2}
MAX_EMBEDDING = 512
# the mask constant of the reference layer (deepctr_tpu/ops/reference.py)
NEG = -2.0 ** 32 + 1.0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# din_attention_fwd's code for a launch whose rows do not fit in shared
# memory
_DOES_NOT_FIT = -2


def _act(name, x):
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "relu":
        return torch.relu(x)
    return x


def din_attention_weights_ref(query, keys, mask, layer_params, activation,
                              weight_normalization):
    """The float32 weight [B, T] of each key in the readout: the softmax
    over the masked scores, or the scores times the mask.  Arguments as
    :func:`din_attention_fused`."""
    _check(query, keys, mask, layer_params, activation)
    B, T, E = keys.shape
    f32 = torch.float32
    qb = query.to(f32).expand(B, T, E)
    k = keys.to(f32)
    x = torch.cat([qb, k, qb - k, qb * k], dim=-1)
    for w, b in layer_params[:-1]:
        x = _act(activation, x @ w.to(f32) + b.to(f32))
    w_o, b_o = layer_params[-1]
    s = (x @ w_o.to(f32) + b_o.to(f32))[..., 0]                  # [B, T]
    m = mask.to(f32)
    if weight_normalization:
        return torch.softmax(s * m + (1.0 - m) * NEG, dim=-1)
    return s * m


def din_attention_fused_ref(query, keys, mask, layer_params, activation,
                            weight_normalization):
    """Plain PyTorch version, in float32.  Arguments and result as
    :func:`din_attention_fused`."""
    s = din_attention_weights_ref(query, keys, mask, layer_params,
                                  activation, weight_normalization)
    out = torch.einsum("bt,bte->be", s, keys.to(torch.float32))
    return out[:, None, :].to(keys.dtype)


def pack_params(layer_params):
    """The kernel's float32 weight buffer for ``layer_params``: the first
    layer folded, ``[W_q = A + C | W_k = B - C | W_qk = D | b_0]`` with
    ``A, B, C, D`` the E-row quarters of its ``[4E, n1]`` weight (so that
    ``[q, k, q - k, q * k] @ W_0 = q @ W_q + k @ (W_k + diag(q) @ W_qk)``),
    then every later layer's ``W [in, out]`` and ``b [out]``, flattened."""
    f32 = torch.float32
    w0, b0 = (t.to(f32) for t in layer_params[0])
    a, b, c, d = w0.chunk(4)
    parts = [a + c, b - c, d, b0] + [t.to(f32) for wb in layer_params[1:]
                                     for t in wb]
    return torch.cat([p.reshape(-1) for p in parts])


def _check(query, keys, mask, layer_params, activation):
    if activation not in ACTIVATIONS:
        raise ValueError("din_attention_fused takes activations %s, got %r"
                         % (sorted(ACTIVATIONS), activation))
    if keys.dim() != 3:
        raise ValueError("keys must be [B, T, E], got %s"
                         % (tuple(keys.shape),))
    B, T, E = keys.shape
    if E > MAX_EMBEDDING:
        raise ValueError("din_attention_fused takes E <= %d, got %d"
                         % (MAX_EMBEDDING, E))
    if tuple(query.shape) != (B, 1, E) or tuple(mask.shape) != (B, T):
        raise ValueError("query must be [%d, 1, %d] and mask [%d, %d], got "
                         "%s and %s" % (B, E, B, T, tuple(query.shape),
                                        tuple(mask.shape)))
    if len(layer_params) < 2:
        raise ValueError("layer_params needs at least one hidden layer and "
                         "the output layer")
    width = 4 * E
    for w, b in layer_params:
        if w.dim() != 2 or w.shape[0] != width or tuple(b.shape) != (
                w.shape[1],):
            raise ValueError("layer weights must chain from %d inputs as "
                             "[in, out] with [out] biases, got %s"
                             % (4 * E, [(tuple(w.shape), tuple(b.shape))
                                        for w, b in layer_params]))
        width = w.shape[1]
    if width != 1:
        raise ValueError("the output layer must have one unit, got %d"
                         % width)
    tensors = [query, keys, mask] + [t for wb in layer_params for t in wb]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("din_attention_fused's tensors must be on one "
                         "device, got %s" % sorted(map(str, devices)))


def _check_packed(packed, keys, layer_params):
    E = keys.shape[2]
    widths = [w.shape[1] for w, _ in layer_params]
    n = 3 * E * widths[0] + widths[0] + sum(
        i * o + o for i, o in zip(widths[:-1], widths[1:]))
    if (packed.dtype != torch.float32 or packed.device != keys.device
            or packed.dim() != 1 or packed.numel() != n
            or not packed.is_contiguous() or packed.data_ptr() % 16):
        raise ValueError("packed must be pack_params(layer_params): %d "
                         "contiguous float32 values on %s from a 16-byte "
                         "boundary (the kernel copies them 16 bytes at a "
                         "time), got %s %s on %s"
                         % (n, keys.device, packed.dtype,
                            tuple(packed.shape), packed.device))


def _kernel(lib=None):
    """din_attention_fwd of ``lib`` (the built csrc/din_attention.cu by
    default), its argument types declared."""
    lib = _build.load("din_attention") if lib is None else lib
    fn = lib.din_attention_fwd
    fn.argtypes = ([ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def route(E, layer_widths, dtype=torch.float32):
    """The kernel's design for keys of ``dtype``, E and the widths of
    ``layer_params``' layers (the hidden widths, then 1): ``"mma8"`` or
    ``"mma16"`` (the tensor cores, the instance of up to 8 or 16 n tiles:
    hidden widths up to 64, up to 128) or ``"fma"`` (float32 FMAs); asks
    the built kernel, so it needs the CUDA toolkit."""
    lib = _build.load("din_attention")
    fn = lib.din_attention_route
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    widths = [4 * E] + list(layer_widths)
    c_widths = (ctypes.c_int * len(widths))(*widths)
    rc = fn(_DTYPES[dtype], len(widths) - 1, ctypes.addressof(c_widths), E)
    if rc not in (0, 8, 16):
        raise ValueError("no din_attention design takes E=%d with layers "
                         "%s (code %d)" % (E, widths, rc))
    return "mma%d" % rc if rc else "fma"


def din_attention_fused(query, keys, mask, layer_params, activation,
                        weight_normalization, packed=None):
    """query [B, 1, E] and keys [B, T, E] (float32 or bfloat16, the keys'
    last dimension contiguous), mask [B, T] (1 or True = valid, 0 or False
    = padded), ``layer_params`` = ``[(W [in, out], b [out]), ...]``: the
    hidden layers from ``4E`` inputs, then the output layer ``(W_out [H,
    1], b_out [1])``.  ``packed`` is ``pack_params(layer_params)`` from a
    caller that keeps it between calls; it is built here when None.
    Returns [B, 1, E] in the keys' dtype.

    Runs the ``deepctr_tpu_torch::din_attention_fused`` op
    (``ops/library.py``): on CUDA tensors it launches the kernel (building
    it at first use) or raises, on CPU tensors it is the plain version,
    which autograd differentiates where it records.  The kernel runs the
    MLP only for the valid steps, so any T."""
    _check(query, keys, mask, layer_params, activation)
    tensors = [query, keys] + [t for wb in layer_params for t in wb]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if keys.device.type == "cpu":
            return din_attention_fused_ref(query, keys, mask, layer_params,
                                           activation, weight_normalization)
        raise NotImplementedError(
            "din_attention_fused has no backward: call it under "
            "torch.no_grad(), or train through the layer composition")
    return torch.ops.deepctr_tpu_torch.din_attention_fused(
        query, keys, mask, [t for wb in layer_params for t in wb],
        activation, bool(weight_normalization), packed)


def launch(query, keys, mask, layer_params, activation,
           weight_normalization, packed=None):
    """The kernel on CUDA tensors (the op's CUDA implementation): checks
    what the kernel takes, launches it and counts the launch."""
    global DIN_ATTENTION_LAUNCHES
    if packed is not None:
        _check_packed(packed, keys, layer_params)
    if keys.device.type != "cuda":
        raise ValueError("no din_attention kernel for device %s"
                         % keys.device)
    if (keys.dtype not in _DTYPES or query.dtype not in _DTYPES
            or keys.stride(2) != 1):
        raise ValueError("query and keys must be float32 or bfloat16, the "
                         "keys with a contiguous last dimension, got %s and "
                         "%s with strides %s" % (query.dtype, keys.dtype,
                                                 keys.stride()))
    B, T, E = keys.shape
    widths = [4 * E] + [w.shape[1] for w, _ in layer_params]
    out = torch.empty(B, 1, E, dtype=keys.dtype, device=keys.device)
    if B == 0:
        return out
    if packed is None:
        packed = pack_params(layer_params)
    q = query.reshape(B, E).contiguous()
    m = (mask if mask.dtype == torch.bool else mask != 0).contiguous()
    c_widths = (ctypes.c_int * len(widths))(*widths)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = _kernel()(
            _DTYPES[keys.dtype], ACTIVATIONS[activation],
            int(bool(weight_normalization)), q.data_ptr(),
            _DTYPES[query.dtype], keys.data_ptr(), keys.stride(0),
            keys.stride(1), m.data_ptr(), packed.data_ptr(),
            len(layer_params), ctypes.addressof(c_widths), B, T, E,
            out.data_ptr(), stream)
    if rc == _DOES_NOT_FIT:
        raise ValueError("din_attention_fused: one step of E=%d with layers "
                         "%s does not fit in a block's shared memory"
                         % (E, widths))
    if rc != 0:
        raise RuntimeError("din_attention kernel launch failed with CUDA "
                           "error %d" % rc)
    DIN_ATTENTION_LAUNCHES += 1
    return out
