"""Small shared helpers (counterpart of ``deepctr_tpu/layers/utils.py``)."""

import torch


def concat_fun(inputs, axis=-1):
    if len(inputs) == 1:
        return inputs[0]
    return torch.cat(inputs, dim=axis)
