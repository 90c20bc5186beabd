"""Activation layers (counterpart of ``deepctr_tpu/layers/activation.py``).

``activation_layer`` resolves a name into a callable ``act(x)``.  Dice and
PReLU carry parameters and come with the DIN slice of the port.
"""

import torch


def activation_layer(act_name, hidden_size=None, dice_dim=2):
    """Resolve an activation spec to ``callable(x) -> x``.

    Accepts 'sigmoid' | 'linear' | 'relu' | 'tanh' or a plain callable.
    ``hidden_size``/``dice_dim`` are accepted for API parity.
    """
    if isinstance(act_name, str):
        name = act_name.lower()
        if name == "sigmoid":
            return torch.sigmoid
        if name == "linear":
            return lambda x: x
        if name == "relu":
            return torch.relu
        if name == "tanh":
            return torch.tanh
        if name in ("dice", "prelu"):
            raise NotImplementedError(
                "%s is not ported yet (it comes with DIN)" % act_name)
        raise NotImplementedError("unknown activation %r" % act_name)
    if callable(act_name):
        return act_name
    raise NotImplementedError(act_name)
