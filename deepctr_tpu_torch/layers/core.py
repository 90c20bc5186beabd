"""Core layers: dense layer, dropout, DNN tower, prediction head, DIN's
local activation unit, CCPM's SAME convolution.

Counterpart of ``deepctr_tpu/layers/core.py``.  Every matmul runs in
the global compute dtype (``config.compute_dtype()``); parameters stay
float32.  Weights are drawn at construction from the caller's
``torch.Generator``; biases start at zero, unlike ``nn.Linear``'s default.
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import config
from ..parallel import context
from .activation import BatchNorm, activation_layer

# flax's lecun_normal draws a normal truncated at two standard deviations
# and divides the scale by that truncated normal's own standard deviation
_TRUNC_NORMAL_STD = 0.87962566103423978


class Dense(nn.Module):
    """``y = x @ weight.T + bias`` computed in the compute dtype.

    ``weight`` is ``[out, in]`` (torch layout; the JAX kernel is its
    transpose).  Counterpart of flax's ``nn.Dense`` as ``_dense`` builds it.
    """

    def __init__(self, in_features, features, init_std=None, use_bias=True,
                 device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)
        with torch.no_grad():
            if init_std is not None:
                self.weight.normal_(0.0, init_std, generator=generator)
            else:
                std = math.sqrt(1.0 / in_features) / _TRUNC_NORMAL_STD
                nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)

    def forward(self, x):
        ct = config.compute_dtype()
        bias = None if self.bias is None else self.bias.to(ct)
        return F.linear(x.to(ct), self.weight.to(ct), bias)


# the generator a training forward draws its dropout masks from
# (``dropout_generator``); None outside a train step
_DROPOUT_GENERATOR = None


@contextlib.contextmanager
def dropout_generator(generator):
    """Draw the dropout masks of the forwards run inside from
    ``generator`` (the model's, ``BaseModel._dropout_generator``): the
    train step runs its forward inside this."""
    global _DROPOUT_GENERATOR
    saved, _DROPOUT_GENERATOR = _DROPOUT_GENERATOR, generator
    try:
        yield
    finally:
        _DROPOUT_GENERATOR = saved


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in training each value is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, else zero;
    rate 1 gives zeros; the identity at inference.

    The mask is drawn from the generator of the enclosing
    :func:`dropout_generator` on the input's device (``torch.rand(...,
    generator=g) < 1 - rate``), never from the global one, so that a step's
    masks are a function of that generator's state alone and a CUDA graph
    that registers it draws new masks at every replay.  A training forward
    with a rate above 0 outside :func:`dropout_generator` raises.  flax's
    bits are not reproduced.

    In a train step on a mesh (``parallel.context.data_shard``) the mask
    is drawn for the global batch and this rank keeps its rows, along
    ``batch_axis``, so that the ranks together draw the one rank's
    mask."""

    def __init__(self, rate, batch_axis=0):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError("dropout rate must lie in [0, 1], got %r"
                             % (rate,))
        self.rate = float(rate)
        self.batch_axis = batch_axis

    def keep_mask(self, x):
        """The [x.shape] bool mask of the values kept."""
        if _DROPOUT_GENERATOR is None:
            raise RuntimeError(
                "a training forward with dropout draws its masks from the "
                "model's dropout generator: run it inside "
                "layers.core.dropout_generator(...) (fit and the train "
                "step do)")
        shape = list(x.shape)
        n = shape[self.batch_axis]
        shape[self.batch_axis], first = context.global_rows(n)
        u = torch.rand(shape, generator=_DROPOUT_GENERATOR,
                       device=x.device).narrow(self.batch_axis, first, n)
        return u < 1.0 - self.rate

    def forward(self, x, training=False):
        if not training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        return torch.where(self.keep_mask(x), x / keep, x.new_zeros(()))


def _dense(in_features, features, init_std=None, use_bias=True,
           device=None, generator=None):
    """Kernel from normal(``init_std``), or lecun-normal when it is None."""
    return Dense(in_features, features, init_std, use_bias, device,
                 generator)


class DNN(nn.Module):
    """MLP tower: [Dense -> (BatchNorm) -> activation -> Dropout] * L.

    (counterpart of ``deepctr_tpu/layers/core.py:25-54``; only kernel
    weights are drawn from normal(init_std), biases start at 0.)  An
    activation with parameters (Dice, PReLU) is one module a layer, named
    ``Dice_<i>``/``PReLU_<i>`` as flax names them.  With ``use_bn`` each
    dense layer is followed by ``bn_<i>``, flax's ``nn.BatchNorm(momentum=
    0.9, epsilon=1e-5)`` with scale and bias (:class:`BatchNorm`): batch
    statistics in training, the running ones at inference.  With
    ``dropout_rate > 0`` each activation is followed by :class:`Dropout`
    in training.
    """

    def __init__(self, inputs_dim, hidden_units, activation="relu",
                 l2_reg=0.0, dropout_rate=0.0, use_bn=False, init_std=1e-4,
                 dice_dim=2, device=None, generator=None):
        super().__init__()
        if len(hidden_units) == 0:
            raise ValueError("hidden_units is empty!!")
        self.hidden_units = tuple(hidden_units)
        self.l2_reg = l2_reg
        self.use_bn = use_bn
        self.dropout = Dropout(dropout_rate)
        dims = (inputs_dim,) + self.hidden_units
        self.activations = []
        for i, units in enumerate(self.hidden_units):
            self.add_module("dense_%d" % i,
                            _dense(dims[i], units, init_std, device=device,
                                   generator=generator))
            if use_bn:
                self.add_module("bn_%d" % i, BatchNorm(units, epsilon=1e-5,
                                                       device=device))
            act = activation_layer(activation, hidden_size=units,
                                   dice_dim=dice_dim, device=device)
            if isinstance(act, nn.Module):
                self.add_module("%s_%d" % (type(act).__name__, i), act)
            self.activations.append(act)

    def forward(self, x, training=False):
        for i, act in enumerate(self.activations):
            x = getattr(self, "dense_%d" % i)(x)
            if self.use_bn:
                x = getattr(self, "bn_%d" % i)(x, training)
            x = self.dropout(act(x, training), training)
        return x


class PredictionLayer(nn.Module):
    """Adds a scalar bias and applies sigmoid iff task == 'binary'.
    (counterpart of ``deepctr_tpu/layers/core.py:57-74``)
    """

    def __init__(self, task="binary", use_bias=True, device=None):
        super().__init__()
        if task not in ("binary", "multiclass", "regression"):
            raise ValueError("task must be binary, multiclass or regression")
        self.task = task
        self.bias = (nn.Parameter(torch.zeros(1, device=device))
                     if use_bias else None)

    def forward(self, x):
        out = x
        if self.bias is not None:
            out = out + self.bias
        if self.task == "binary":
            out = torch.sigmoid(out)
        return out


class LocalActivationUnit(nn.Module):
    """DIN attention scorer over ``[query, key, query - key, query * key]``:
    query [B,1,E], keys [B,T,E] -> scores [B,T,1].
    (counterpart of ``deepctr_tpu/layers/core.py:77-100``)
    """

    def __init__(self, hidden_units=(64, 32), embedding_dim=4,
                 activation="sigmoid", dropout_rate=0.0, use_bn=False,
                 init_std=1e-4, device=None, generator=None):
        super().__init__()
        self.dnn = DNN(4 * embedding_dim, hidden_units, activation=activation,
                       dropout_rate=dropout_rate, use_bn=use_bn,
                       init_std=init_std, device=device, generator=generator)
        self.dense = _dense(hidden_units[-1], 1, device=device,
                            generator=generator)

    def forward(self, query, user_behavior, training=False):
        T = user_behavior.shape[1]
        queries = query.expand(query.shape[0], T, query.shape[2])
        att_input = torch.cat([queries, user_behavior,
                               queries - user_behavior,
                               queries * user_behavior], dim=-1)
        return self.dense(self.dnn(att_input, training))


class Conv2dSame(nn.Module):
    """TF-style "SAME"-padded 2-D convolution over NCHW inputs
    (``deepctr_tpu/layers/core.py:103-131``): ``kernel`` [out, in, kh, kw]
    from flax's ``xavier_uniform`` (jax's fans of that shape: the last two
    axes in and out, the others a receptive field), ``bias`` [out] from
    zeros, computed in the compute dtype.

    The JAX layer calls ``lax.conv_general_dilated``.  Here the padded
    input's windows (``Tensor.unfold`` views along both spatial axes) are
    multiplied by the kernel as one matrix: the backward then sums in a
    fixed order (``unfold``'s backward and a matrix product), where cuDNN's
    weight-gradient algorithms may add with atomics, which would part a
    graphed train step from the eager one.  (``F.unfold`` would do as
    well on the CPU, but on the card it launches one ``im2col`` kernel for
    each sample of the batch.)"""

    def __init__(self, in_channels, out_channels, kernel_size, stride=(1, 1),
                 device=None, generator=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        shape = (out_channels, in_channels) + self.kernel_size
        receptive = math.prod(shape[:-2])
        bound = math.sqrt(6.0 / ((shape[-2] + shape[-1]) * receptive))
        self.kernel = nn.Parameter(torch.empty(shape, device=device).uniform_(
            -bound, bound, generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x):
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ih, iw = x.shape[-2:]
        oh, ow = math.ceil(ih / sh), math.ceil(iw / sw)
        pad_h = max((oh - 1) * sh + kh - ih, 0)
        pad_w = max((ow - 1) * sw + kw - iw, 0)
        ct = config.compute_dtype()
        x = F.pad(x.to(ct), (pad_w // 2, pad_w - pad_w // 2,
                             pad_h // 2, pad_h - pad_h // 2))
        B, C = x.shape[:2]
        windows = x.unfold(2, kh, sh).unfold(3, kw, sw)    # [B,C,oh,ow,kh,kw]
        cols = windows.permute(0, 2, 3, 1, 4, 5).reshape(B, oh * ow, -1)
        w = self.kernel.to(ct).reshape(self.kernel.shape[0], -1)
        y = torch.matmul(w, cols.transpose(1, 2))         # [B, out, oh*ow]
        return (y.view(B, -1, oh, ow)
                + self.bias.to(ct)[None, :, None, None])
