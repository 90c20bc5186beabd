"""Activation layers (counterpart of ``deepctr_tpu/layers/activation.py``).

``activation_layer`` resolves a name into a callable ``act(x, training=
False)``: a plain function for the stateless activations, a module for
Dice and PReLU, which carry parameters.
"""

import math

import torch
from torch import nn

from ..parallel import context


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` as the JAX package builds it
    (``momentum=0.9``): what Dice normalises with, a ``DNN`` layer's
    ``bn_<i>`` with ``use_bn``, and the LTL's two (``axis=1``).

    ``features`` is the size of the feature axis ``axis`` (the last by
    default), or the shape of several (``axis`` a tuple: a stacked DNN's
    ``(expert, unit)`` axes); the statistics reduce over every other axis.

    Training normalises with the batch's own statistics, from flax 0.12's
    ``_compute_stats``: in float32, ``mean = E[x]`` and the biased
    ``var = max(0, E[x^2] - E[x]^2)`` over every row the batch holds (a
    sequence's padded steps and a fit's padded tail included), and the
    gradient flows through both.  Each training call then moves the
    running buffers ``mean`` and ``var`` (the JAX package's
    ``batch_stats/.../{mean,var}``) outside autograd, ``ra = momentum * ra
    + (1 - momentum) * batch``.  Inference normalises with them.  Either
    way ``y = (x - mean) * rsqrt(var + epsilon)``, then ``* scale + bias``
    where the layer has them (parameters ``scale`` and ``bias``, from 1 and
    0).  Returns float32, as flax does for float32 parameters.

    In a train step on a mesh (``parallel.context.data_shard``) the
    moments are the global batch's, as ``jnp.mean`` over a data-sharded
    axis is: the sums, the sums of squares and the count are summed over
    the data axis in one all-reduce, whose gradient is the sum of the
    ranks'."""

    def __init__(self, features, epsilon=1e-5, momentum=0.9, use_scale=True,
                 use_bias=True, axis=-1, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.axis = (axis,) if isinstance(axis, int) else tuple(axis)
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.scale = (nn.Parameter(torch.ones(features, device=device))
                      if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x, training=False):
        x32 = x.float()
        keep = sorted(a % x.dim() for a in self.axis)
        # a feature-shaped tensor broadcast against x
        shape = [x.shape[a] if a in keep else 1 for a in range(x.dim())]

        def bcast(t):
            return t.reshape(shape)
        if training:
            axes = tuple(a for a in range(x.dim()) if a not in keep)
            if context.active():
                mean, ex2 = self._global_moments(x32, axes)
            else:
                mean = torch.mean(x32, dim=axes)
                ex2 = torch.mean(x32 * x32, dim=axes)
            var = torch.clamp_min(ex2 - mean * mean, 0.0)
            with torch.no_grad():
                mom = self.momentum
                self.mean.copy_(mom * self.mean + (1 - mom) * mean)
                self.var.copy_(mom * self.var + (1 - mom) * var)
        else:
            mean, var = self.mean, self.var
        y = (x32 - bcast(mean)) * bcast(torch.rsqrt(var + self.epsilon))
        if self.scale is not None:
            y = y * bcast(self.scale)
        if self.bias is not None:
            y = y + bcast(self.bias)
        return y

    @staticmethod
    def _global_moments(x32, axes):
        """``(E[x], E[x^2])`` over ``axes`` of the global batch: this
        rank's sums and count summed over the data axis."""
        s1 = torch.sum(x32, dim=axes)
        s2 = torch.sum(x32 * x32, dim=axes)
        count = x32.new_full((1,), float(math.prod(x32.shape[a]
                                                  for a in axes)))
        total = context.data_sum(torch.cat([s1.reshape(-1), s2.reshape(-1),
                                            count]))
        k = s1.numel()
        n = total[-1]
        return (total[:k].view_as(s1) / n, total[k:2 * k].view_as(s2) / n)


class Dice(nn.Module):
    """Data-adaptive activation from DIN: ``alpha * (1 - p) * x + p * x``
    with ``p = sigmoid(BN(x))``, BatchNorm over every axis but the last,
    without scale or bias (:class:`BatchNorm` with ``epsilon=1e-8``, the
    JAX package's ``Dice``): batch statistics in training, which move the
    running buffers ``bn.mean`` and ``bn.var``, those buffers at
    inference.  Computed in float32, returned in x's dtype.

    ``experts`` gives every parameter and statistic a leading axis of that
    size, as the JAX package's ``nn.vmap`` of a DNN does for the stacked
    expert towers: ``alpha`` and ``bn.{mean,var}`` are [experts, emb_size],
    the input [experts, B, emb_size], and each expert normalises with its
    own batch's statistics.

    ``promote`` keeps the dtypes of flax's arithmetic on a low-precision
    input, as the CIN meets it: the normalised input is rounded to x's
    dtype (flax's ``BatchNorm`` returns it), the gate and ``p * x`` stay in
    it, and the float32 ``alpha`` promotes the result to float32."""

    def __init__(self, emb_size, epsilon=1e-8, experts=None, promote=False,
                 device=None):
        super().__init__()
        shape = emb_size if experts is None else (experts, emb_size)
        self.experts = experts
        self.promote = promote
        self.alpha = nn.Parameter(torch.zeros(shape, device=device))
        self.bn = BatchNorm(shape, epsilon=epsilon, use_scale=False,
                            use_bias=False,
                            axis=-1 if experts is None else (0, 2),
                            device=device)

    def forward(self, x, training=False):
        alpha = self.alpha if self.experts is None else self.alpha[:, None]
        x_norm = self.bn(x, training)
        if self.promote:
            x_p = torch.sigmoid(x_norm.to(x.dtype))
            return alpha * (1.0 - x_p) * x + x_p * x
        x32 = x.float()
        x_p = torch.sigmoid(x_norm)
        return (alpha * (1.0 - x_p) * x32 + x_p * x32).to(x.dtype)


class PReLU(nn.Module):
    """Parametric ReLU with one learned slope (torch ``nn.PReLU``'s
    default); ``experts`` gives the slope a leading axis, ``alpha``
    [experts, 1] over an [experts, B, units] input.  ``promote``: the
    float32 slope promotes a low-precision input's negative side, and with
    it the result, to float32, as ``jnp.where`` does."""

    def __init__(self, init=0.25, experts=None, promote=False, device=None):
        super().__init__()
        shape = (1,) if experts is None else (experts, 1)
        self.experts = experts
        self.promote = promote
        self.alpha = nn.Parameter(torch.full(shape, init, device=device))

    def forward(self, x, training=False):
        alpha = self.alpha if self.experts is None else self.alpha[:, None]
        if not self.promote:
            alpha = alpha.to(x.dtype)
        return torch.where(x >= 0, x, alpha * x)


def _wrap(fn):
    return lambda x, training=False: fn(x)


def activation_layer(act_name, hidden_size=None, dice_dim=2, device=None,
                     experts=None, promote=False):
    """Resolve an activation spec to ``callable(x, training=False) -> x``.

    Accepts 'sigmoid' | 'linear' | 'relu' | 'tanh' | 'dice' | 'prelu' or a
    plain callable.  Dice needs ``hidden_size``, the width of its input's
    last axis; ``dice_dim`` is accepted for API parity.  ``experts`` and
    ``promote`` go to Dice and PReLU (see there)."""
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
            return Dice(hidden_size, experts=experts, promote=promote,
                        device=device)
        if name == "prelu":
            return PReLU(experts=experts, promote=promote, device=device)
        raise NotImplementedError("unknown activation %r" % act_name)
    if callable(act_name):
        return _wrap(act_name)
    raise NotImplementedError(act_name)
