"""Activation layers (counterpart of ``deepctr_tpu/layers/activation.py``).

``activation_layer`` resolves a name into a callable ``act(x, training=
False)``: a plain function for the stateless activations, a module for
Dice and PReLU, which carry parameters.
"""

import torch
from torch import nn


class Dice(nn.Module):
    """Data-adaptive activation from DIN: ``alpha * (1 - p) * x + p * x``
    with ``p = sigmoid(BN(x))``, BatchNorm over every axis but the last,
    without scale or bias.

    Inference only: BN normalises with the running statistics, the buffers
    ``bn.mean`` and ``bn.var`` (the JAX package's ``batch_stats/.../bn/
    {mean,var}``), ``(x - mean) * rsqrt(var + epsilon)``.  Training mode,
    which updates them, comes with the DIN/DIEN training slice and
    raises."""

    def __init__(self, emb_size, epsilon=1e-8, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.alpha = nn.Parameter(torch.zeros(emb_size, device=device))
        self.bn = nn.Module()
        self.bn.register_buffer("mean", torch.zeros(emb_size, device=device))
        self.bn.register_buffer("var", torch.ones(emb_size, device=device))

    def forward(self, x, training=False):
        if training:
            raise NotImplementedError(
                "Dice in training mode is not ported yet (it comes with the "
                "DIN/DIEN training slice)")
        x32 = x.float()
        x_norm = (x32 - self.bn.mean) * torch.rsqrt(self.bn.var
                                                    + self.epsilon)
        x_p = torch.sigmoid(x_norm)
        return (self.alpha * (1.0 - x_p) * x32 + x_p * x32).to(x.dtype)


class PReLU(nn.Module):
    """Parametric ReLU with one learned slope (torch ``nn.PReLU``'s
    default)."""

    def __init__(self, init=0.25, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), init, device=device))

    def forward(self, x, training=False):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


def _wrap(fn):
    return lambda x, training=False: fn(x)


def activation_layer(act_name, hidden_size=None, dice_dim=2, device=None):
    """Resolve an activation spec to ``callable(x, training=False) -> x``.

    Accepts 'sigmoid' | 'linear' | 'relu' | 'tanh' | 'dice' | 'prelu' or a
    plain callable.  Dice needs ``hidden_size``, the width of its input's
    last axis; ``dice_dim`` is accepted for API parity."""
    if isinstance(act_name, str):
        name = act_name.lower()
        if name == "sigmoid":
            return _wrap(torch.sigmoid)
        if name == "linear":
            return _wrap(lambda x: x)
        if name == "relu":
            return _wrap(torch.relu)
        if name == "tanh":
            return _wrap(torch.tanh)
        if name == "dice":
            if hidden_size is None:
                raise ValueError("Dice needs hidden_size")
            return Dice(hidden_size, device=device)
        if name == "prelu":
            return PReLU(device=device)
        raise NotImplementedError("unknown activation %r" % act_name)
    if callable(act_name):
        return _wrap(act_name)
    raise NotImplementedError(act_name)
