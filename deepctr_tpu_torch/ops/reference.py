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
