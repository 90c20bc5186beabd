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
