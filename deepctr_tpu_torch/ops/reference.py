"""Plain PyTorch versions of the interaction ops.

Counterpart of ``deepctr_tpu/ops/reference.py``.
"""

import torch


def fm_cross_ref(inputs):
    """FM order-2 interaction: [B, F, E] -> [B, 1].

    0.5 * sum_e((sum_f v)^2 - sum_f v^2).
    """
    square_of_sum = torch.sum(inputs, dim=1, keepdim=True) ** 2
    sum_of_square = torch.sum(inputs * inputs, dim=1, keepdim=True)
    cross = square_of_sum - sum_of_square
    return 0.5 * torch.sum(cross, dim=2)


def cin_layer_ref(hidden, x0, w, b):
    """One CIN layer: outer interaction + 1x1 channel-mix.

    hidden [B,H,D], x0 [B,F,D], w [O, H*F], b [O] -> [B,O,D]."""
    B, H, D = hidden.shape
    F = x0.shape[1]
    z = torch.einsum("bhd,bmd->bhmd", hidden, x0).reshape(B, H * F, D)
    return torch.einsum("oc,bcd->bod", w, z) + b[None, :, None]


def cin_mix_ref(hidden_t, x0_t, w3):
    """D-major CIN layer: hidden_t [B,D,H], x0_t [B,D,F], w3 [O,H,F]
    -> [B,D,O], out[b,d,o] = sum_{h,f} w3[o,h,f] h[b,d,h] x[b,d,f].

    Works at the operands' dtype as the JAX einsums do: the outer product
    z = h * x is rounded to it, the contraction accumulates in float32 and
    rounds once."""
    B, D, H = hidden_t.shape
    F = x0_t.shape[2]
    O = w3.shape[0]
    z = (hidden_t[..., :, None] * x0_t[..., None, :]).reshape(B, D, H * F)
    out = torch.matmul(z.float(), w3.reshape(O, H * F).t().float())
    return out.to(hidden_t.dtype)


def cross_net_ref(x, kernels, bias, parameterization="vector"):
    """DCN cross stack: x [B,n]; kernels [L,n,1] or [L,n,n]; bias [L,n,1].

    vector: x_{l+1} = x0 * (x_l . w_l) + b_l + x_l
    matrix: x_{l+1} = x0 * (W_l x_l + b_l) + x_l"""
    x0 = xl = x
    for i in range(kernels.shape[0]):
        b = bias[i][:, 0][None]
        if parameterization == "vector":
            xl = x0 * (xl @ kernels[i]) + b + xl
        else:
            xl = x0 * (xl @ kernels[i].t() + b) + xl
    return xl


def din_attention_ref(scores, keys, keys_masks, weight_normalization,
                      return_score):
    """Masked (optionally softmax) attention readout over history.

    scores [B,1,T], keys [B,T,E], keys_masks [B,1,T] bool -> [B,1,E], or
    the [B,1,T] weights with ``return_score``."""
    if weight_normalization:
        paddings = torch.full_like(scores, -2.0 ** 32 + 1)
    else:
        paddings = torch.zeros_like(scores)
    outputs = torch.where(keys_masks, scores, paddings)
    if weight_normalization:
        outputs = torch.softmax(outputs, dim=-1)
    if not return_score:
        dtype = torch.promote_types(outputs.dtype, keys.dtype)
        outputs = torch.matmul(outputs.to(dtype), keys.to(dtype))
    return outputs
