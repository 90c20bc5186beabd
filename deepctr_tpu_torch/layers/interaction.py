"""Feature-interaction layers (counterpart of
``deepctr_tpu/layers/interaction.py``).  Every layer consumes a stacked
``[B, F, E]`` field tensor."""

import torch
from torch import nn

from .. import config
from ..ops import cin_mix, fm_cross
from ..ops._args import ParamCache
from ..ops.cin import kernel_weights
from .activation import activation_layer


class FM(nn.Module):
    """Factorization-machine pairwise interaction:
    ``0.5 * sum_e((sum_f v)^2 - sum_f v^2)`` over [B,F,E] -> [B,1].
    """

    def forward(self, inputs):
        return fm_cross(inputs)


class CIN(nn.Module):
    """Compressed Interaction Network (xDeepFM), D-major
    (``deepctr_tpu/layers/interaction.py:114-197``).

    Layer i mixes the outer product of its hidden maps [B, E, H_i] and the
    fields [B, E, F] with ``conv_w_<i> [size, H_i * F]`` (``cin_mix``),
    adds ``conv_b_<i>`` and applies the activation.  With ``split_half``
    the first half of every layer's maps but the last's is the next hidden
    and the second half goes to the output; the output maps are summed
    over E at the end: [B, F, E] -> [B, featuremap_num].

    Everything runs in the compute dtype, operands and carried maps alike,
    as the JAX layer's default policy (``DEEPCTR_CIN_DTYPE=bf16``) does in
    training and at inference; the bias is added after the kernel, in that
    dtype.  ``conv_w_<i>`` is drawn from U(+-1/sqrt(size)), the JAX layer's
    ``variance_scaling(1/3, "fan_in", "uniform")`` on shape ``(size,
    in_ch)`` (flax's fan-in of a 2-D kernel is its first axis), and
    ``conv_b_<i>`` starts at zero (the JAX layer's ``init_std`` is unused
    there and has no counterpart).  On CUDA the kernel's weight layouts are
    kept between calls (``ops.cin.kernel_weights``), so inference casts and
    transposes no weight a batch."""

    def __init__(self, field_size, layer_size=(128, 128), activation="relu",
                 split_half=True, device=None, generator=None):
        super().__init__()
        if len(layer_size) == 0:
            raise ValueError("layer_size must be a list(tuple) of length "
                             "greater than 1")
        if isinstance(activation, str) and activation.lower() in (
                "dice", "prelu"):
            raise NotImplementedError("CIN takes activations without "
                                      "parameters, got %r" % (activation,))
        self.field_size = field_size
        self.layer_size = tuple(layer_size)
        self.split_half = split_half
        self.activation = activation_layer(activation)
        self.field_nums = [field_size]
        last = len(self.layer_size) - 1
        for i, size in enumerate(self.layer_size):
            if split_half and i != last and size % 2 > 0:
                raise ValueError("layer_size must be even number except for "
                                 "the last layer when split_half=True")
            w = torch.empty(size, self.field_nums[-1] * field_size,
                            device=device)
            bound = size ** -0.5
            w.uniform_(-bound, bound, generator=generator)
            self.register_parameter("conv_w_%d" % i, nn.Parameter(w))
            self.register_parameter("conv_b_%d" % i, nn.Parameter(
                torch.zeros(size, device=device)))
            self.field_nums.append(size // 2 if split_half and i != last
                                   else size)
        # the output's width: every layer's direct maps
        self.featuremap_num = (sum(self.field_nums[1:-1])
                               + self.layer_size[-1])
        self._wt = [ParamCache() for _ in self.layer_size]

    def forward(self, inputs):
        if inputs.dim() != 3:
            raise ValueError("CIN expects [B, F, E] inputs")
        dtype = config.compute_dtype()
        F = self.field_size
        x0_t = inputs.transpose(1, 2).to(dtype).contiguous()     # [B, E, F]
        hidden = x0_t
        finals = []
        last = len(self.layer_size) - 1
        for i, size in enumerate(self.layer_size):
            w = getattr(self, "conv_w_%d" % i)
            b = getattr(self, "conv_b_%d" % i)
            w3 = w.view(size, self.field_nums[i], F)
            if x0_t.is_cuda:
                wt, wm = self._wt[i].get([w], dtype,
                                         lambda: kernel_weights(w3, dtype))
            else:
                w3, wt, wm = w3.to(dtype), None, None
            x = cin_mix(hidden, x0_t, w3, wt=wt, wm=wm) + b.to(dtype)
            curr = self.activation(x)                            # [B, E, size]
            if self.split_half and i != last:
                hidden, direct = torch.split(curr, size // 2, dim=-1)
            else:
                hidden = direct = curr
            finals.append(direct)
        return torch.cat(finals, dim=-1).sum(dim=1)        # [B, featuremap_num]
