"""Feature-interaction layers (counterpart of
``deepctr_tpu/layers/interaction.py``).  Every layer consumes a stacked
``[B, F, E]`` field tensor (``CrossNet`` and ``CrossNetMix`` a flat
``[B, n]``), and keeps the JAX layer's parameter layout and initializer.
The pairwise layers index the field pairs with tensors built once, at
construction (``_pair_indices``)."""

import math

import numpy as np
import torch
from torch import nn

from .. import config
from ..ops import cin_mix, cross_net, fm_cross
from ..ops._args import ParamCache
from ..ops.cin import kernel_weights
from .activation import activation_layer
from .core import _TRUNC_NORMAL_STD, _dense


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


def _pair_indices(num_fields, device=None):
    """The field pairs ``i < j`` in row-major order, as the JAX layers'
    ``np.triu_indices(num_fields, k=1)``: two int64 tensors [P] on
    ``device``.  Built once, at a layer's construction: a forward indexes
    with them and never builds them, so that a captured graph keeps their
    addresses."""
    rows, cols = np.triu_indices(num_fields, k=1)
    return (torch.as_tensor(rows, dtype=torch.int64, device=device),
            torch.as_tensor(cols, dtype=torch.int64, device=device))


class _Gather(torch.autograd.Function):
    """``x.index_select(dim, idx)`` (``dim`` 0 or 1) whose backward adds
    the cotangents of the gathered slices into their sources as a product
    with the fixed 0/1 matrix ``hits`` [n, len(idx)], ``hits[f, p] =
    (idx[p] == f)``.  On CUDA ``index_select``'s backward adds them with
    atomics, in an order that changes from run to run, so two runs of one
    train step would part; a product sums in a fixed order."""

    @staticmethod
    def forward(ctx, x, idx, hits, dim):
        ctx.save_for_backward(hits)
        ctx.dim = dim
        return x.index_select(dim, idx)

    @staticmethod
    def backward(ctx, g):
        hits = ctx.saved_tensors[0].to(g.dtype)
        if ctx.dim == 1:                     # [B, P, ...] -> [B, n, ...]
            return torch.matmul(hits, g), None, None, None
        out = torch.matmul(hits, g.reshape(g.shape[0], -1))
        return out.view(hits.shape[0], *g.shape[1:]), None, None, None


def _register_pairs(module, num_fields, device):
    """``module.rows``/``module.cols``: the pair indices of ``num_fields``
    fields, and their 0/1 matrices ``rows_hits``/``cols_hits`` [F, P]
    (``_Gather``), as buffers that follow the module across devices and
    stay out of its ``state_dict``."""
    module.num_fields = num_fields
    for name, idx in zip(("rows", "cols"),
                         _pair_indices(num_fields, device)):
        hits = (torch.arange(num_fields, device=device)[:, None]
                == idx[None, :]).float()
        module.register_buffer(name, idx, persistent=False)
        module.register_buffer(name + "_hits", hits, persistent=False)


def _gather(module, x, name, dim):
    return _Gather.apply(x, getattr(module, name),
                         getattr(module, name + "_hits"), dim)


def _pairs(module, inputs):
    """(v_i, v_j) [B, P, E] of every field pair of ``inputs`` [B, F, E]."""
    if inputs.dim() != 3 or inputs.shape[1] != module.num_fields:
        raise ValueError("%s expects [B, %d, E] inputs, got %r" % (
            type(module).__name__, module.num_fields, tuple(inputs.shape)))
    return _gather(module, inputs, "rows", 1), _gather(module, inputs,
                                                        "cols", 1)


def _fans(shape):
    """jax's fans of a kernel: the last two axes in and out, the others
    a receptive field that multiplies both."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _stacked_xavier_normal(shape, device=None, generator=None):
    """Xavier-normal per leading slice, as the JAX layers'
    ``_stacked_xavier_normal``: normal(0, sqrt(2 / (shape[-2] +
    shape[-1])))."""
    std = (2.0 / (shape[-2] + shape[-1])) ** 0.5
    return torch.empty(shape, device=device).normal_(0.0, std,
                                                     generator=generator)


def _uniform(shape, bound, device=None, generator=None):
    return torch.empty(shape, device=device).uniform_(-bound, bound,
                                                      generator=generator)


def _fan_in_uniform(shape, device=None, generator=None):
    """flax's ``variance_scaling(1/3, "fan_in", "uniform")``:
    U(+-1/sqrt(fan_in))."""
    return _uniform(shape, _fans(shape)[0] ** -0.5, device, generator)


def _xavier_uniform(shape, device=None, generator=None):
    """flax's ``xavier_uniform``: U(+-sqrt(6 / (fan_in + fan_out)))."""
    return _uniform(shape, (6.0 / sum(_fans(shape))) ** 0.5, device,
                    generator)


def _xavier_normal(shape, device=None, generator=None):
    """flax's ``xavier_normal``, a normal truncated at two standard
    deviations and scaled to the variance 2 / (fan_in + fan_out)."""
    std = (2.0 / sum(_fans(shape))) ** 0.5 / _TRUNC_NORMAL_STD
    w = torch.empty(shape, device=device)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    return w


class BiInteractionPooling(nn.Module):
    """NFM bi-interaction: the FM cross term kept as a vector,
    ``0.5 * ((sum_f v)^2 - sum_f v^2)``: [B, F, E] -> [B, 1, E]
    (``deepctr_tpu/layers/interaction.py:44-53``)."""

    def forward(self, inputs):
        square_of_sum = torch.sum(inputs, dim=1, keepdim=True) ** 2
        sum_of_square = torch.sum(inputs * inputs, dim=1, keepdim=True)
        return 0.5 * (square_of_sum - sum_of_square)


class SENETLayer(nn.Module):
    """Squeeze-and-excitation over fields (FiBiNET): the fields' mean over
    E, two bias-free dense layers with relu (``reduce`` to
    ``max(1, F // reduction_ratio)``, ``expand`` back to F, lecun-normal,
    in the compute dtype), and the fields scaled by the result
    (``deepctr_tpu/layers/interaction.py:56-73``)."""

    def __init__(self, filed_size, reduction_ratio=3, device=None,
                 generator=None):
        super().__init__()
        self.filed_size = filed_size
        reduction_size = max(1, filed_size // reduction_ratio)
        self.reduce = _dense(filed_size, reduction_size, use_bias=False,
                             device=device, generator=generator)
        self.expand = _dense(reduction_size, filed_size, use_bias=False,
                             device=device, generator=generator)

    def forward(self, inputs, training=False):
        if inputs.dim() != 3:
            raise ValueError("SENETLayer expects [B, F, E] inputs")
        a = torch.relu(self.reduce(torch.mean(inputs, dim=-1)))
        a = torch.relu(self.expand(a))
        return inputs * a[:, :, None]


class BilinearInteraction(nn.Module):
    """Bilinear products ``(v_i W) * v_j`` of every field pair i < j:
    [B, F, E] -> [B, P, E], in the compute dtype
    (``deepctr_tpu/layers/interaction.py:76-111``).  ``kernel`` is one
    [E, E] (``"all"``), one a field [F, E, E] (``"each"``, the pair's
    first field's) or one a pair [P, E, E] (``"interaction"``), drawn from
    U(+-1/sqrt(fan_in)), jax's fan-in of the stacked kernel."""

    def __init__(self, filed_size, embedding_size,
                 bilinear_type="interaction", device=None, generator=None):
        super().__init__()
        F, E = filed_size, embedding_size
        _register_pairs(self, F, device)
        shapes = {"all": (E, E), "each": (F, E, E),
                  "interaction": (self.rows.numel(), E, E)}
        if bilinear_type not in shapes:
            raise NotImplementedError(bilinear_type)
        self.bilinear_type = bilinear_type
        self.kernel = nn.Parameter(_fan_in_uniform(
            shapes[bilinear_type], device, generator))

    def forward(self, inputs):
        dtype = config.compute_dtype()
        vi, vj = (v.to(dtype) for v in _pairs(self, inputs))
        w = self.kernel
        if self.bilinear_type == "all":
            return torch.matmul(vi, w.to(dtype)) * vj
        if self.bilinear_type == "each":
            w = _gather(self, w, "rows", 0)              # the pair's first
        return torch.einsum("bpe,pef->bpf", vi, w.to(dtype)) * vj


class AFMLayer(nn.Module):
    """Attentional FM: a softmax over the field pairs of a one-layer
    attention net's score of each element product ``v_i * v_j``, the
    weighted sum of the products projected to a logit: [B, F, E] -> [B, 1]
    (``deepctr_tpu/layers/interaction.py:200-232``), float32 whatever the
    compute dtype.  ``attention_W`` [E, A], ``projection_h`` [A, 1] and
    ``projection_p`` [E, 1] are xavier-normal, ``attention_b`` zeros.  The
    port takes the number of fields at construction, ``field_size``, to
    build the pair indices once.  Dropout is not ported yet and raises."""

    def __init__(self, in_features, attention_factor=4, l2_reg_w=0.0,
                 dropout_rate=0.0, *, field_size, device=None,
                 generator=None):
        super().__init__()
        if dropout_rate > 0:
            raise NotImplementedError("AFMLayer dropout is not ported yet")
        E, A = in_features, attention_factor
        self.l2_reg_w = l2_reg_w
        _register_pairs(self, field_size, device)
        self.attention_W = nn.Parameter(_xavier_normal((E, A), device,
                                                       generator))
        self.attention_b = nn.Parameter(torch.zeros(A, device=device))
        self.projection_h = nn.Parameter(_xavier_normal((A, 1), device,
                                                        generator))
        self.projection_p = nn.Parameter(_xavier_normal((E, 1), device,
                                                        generator))

    def forward(self, inputs, training=False):
        p, q = _pairs(self, inputs)
        bi = p * q                                              # [B, P, E]
        att_tmp = torch.relu(torch.matmul(bi, self.attention_W)
                             + self.attention_b)
        score = torch.softmax(torch.matmul(att_tmp, self.projection_h),
                              dim=1)                            # [B, P, 1]
        att_out = torch.sum(score * bi, dim=1)                  # [B, E]
        return torch.matmul(att_out, self.projection_p)         # [B, 1]


class InteractingLayer(nn.Module):
    """Multi-head self-attention over the fields (AutoInt): per head of
    width E / head_num, softmax(q k^T) v (scaled by 1/sqrt(d) with
    ``scaling``), the heads side by side, plus ``x W_Res`` with
    ``use_res``, then relu: [B, F, E] -> [B, F, E] in the compute dtype
    (``deepctr_tpu/layers/interaction.py:235-279``, its einsums).
    ``W_Query``, ``W_key``, ``W_Value``, ``W_Res`` are [E, E] from
    normal(0.05)."""

    def __init__(self, embedding_size, head_num=2, use_res=True,
                 scaling=False, device=None, generator=None):
        super().__init__()
        if head_num <= 0:
            raise ValueError("head_num must be a int > 0")
        if embedding_size % head_num != 0:
            raise ValueError(
                "embedding_size is not an integer multiple of head_num!")
        self.embedding_size = embedding_size
        self.head_num = head_num
        self.use_res = use_res
        self.scaling = scaling
        E = embedding_size
        for name in ("W_Query", "W_key", "W_Value") + (
                ("W_Res",) if use_res else ()):
            self.register_parameter(name, nn.Parameter(torch.empty(
                E, E, device=device).normal_(0.0, 0.05,
                                             generator=generator)))

    def forward(self, inputs):
        if inputs.dim() != 3:
            raise ValueError("InteractingLayer expects [B, F, E] inputs")
        dtype = config.compute_dtype()
        E, H = self.embedding_size, self.head_num
        d = E // H
        x = inputs.to(dtype)
        B, F = x.shape[0], x.shape[1]

        def heads(w):           # x w: [B, F, E] -> [B, H, F, d]
            return torch.matmul(x, w.to(dtype)).reshape(
                B, F, H, d).transpose(1, 2)

        q, k, v = heads(self.W_Query), heads(self.W_key), heads(self.W_Value)
        scores = torch.matmul(q, k.transpose(-1, -2))
        if self.scaling:
            scores = scores / (d ** 0.5)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)   # [B, H, F, d]
        out = out.transpose(1, 2).reshape(B, F, E)
        if self.use_res:
            out = out + torch.matmul(x, self.W_Res.to(dtype))
        return torch.relu(out)


class CrossNet(nn.Module):
    """DCN cross network, ``"vector"`` (DCN) or ``"matrix"`` (DCN-V2)
    (``deepctr_tpu/layers/interaction.py:282-306``): ``cross_net`` over
    [B, n] in the compute dtype.  ``kernels`` [L, n, 1] or [L, n, n]
    xavier-normal per layer, ``bias`` [L, n, 1] zeros."""

    def __init__(self, in_features, layer_num=2, parameterization="vector",
                 device=None, generator=None):
        super().__init__()
        n = in_features
        if parameterization not in ("vector", "matrix"):
            raise ValueError("parameterization should be 'vector' or "
                             "'matrix'")
        self.parameterization = parameterization
        self.kernels = nn.Parameter(_stacked_xavier_normal(
            (layer_num, n, 1 if parameterization == "vector" else n),
            device, generator))
        self.bias = nn.Parameter(torch.zeros(layer_num, n, 1, device=device))

    def forward(self, inputs):
        dtype = config.compute_dtype()
        return cross_net(inputs.to(dtype), self.kernels.to(dtype),
                         self.bias.to(dtype), self.parameterization)


class CrossNetMix(nn.Module):
    """DCN-Mix: at each of L layers a softmax gate over K low-rank experts
    ``x0 * (U tanh(C tanh(V^T x)) + b)``, added to x, in the compute dtype
    (``deepctr_tpu/layers/interaction.py:309-349``).  C applies as
    ``C v`` (``out_s = sum_r C[s, r] v_r``), as the reference's
    ``torch.matmul(C, v)``.  ``U_list``/``V_list`` [L, K, n, r] and
    ``C_list`` [L, K, r, r] xavier-normal per slice, ``bias`` [L, n, 1]
    zeros, ``gating`` [K, n, 1] from U(+-1/sqrt(fan_in)) (fan-in n K)."""

    def __init__(self, in_features, low_rank=32, num_experts=4, layer_num=2,
                 device=None, generator=None):
        super().__init__()
        n, r, K, L = in_features, low_rank, num_experts, layer_num
        self.layer_num = L
        for name, shape in (("U_list", (L, K, n, r)), ("V_list", (L, K, n, r)),
                            ("C_list", (L, K, r, r))):
            self.register_parameter(name, nn.Parameter(
                _stacked_xavier_normal(shape, device, generator)))
        self.bias = nn.Parameter(torch.zeros(L, n, 1, device=device))
        self.gating = nn.Parameter(_fan_in_uniform((K, n, 1), device,
                                                   generator))

    def forward(self, inputs):
        dtype = config.compute_dtype()
        x0 = inputs.to(dtype)                                   # [B, n]
        xl = x0
        gates = self.gating.to(dtype)
        for i in range(self.layer_num):
            g = torch.einsum("bn,knr->bkr", xl, gates)[..., 0]   # [B, K]
            vx = torch.tanh(torch.einsum("bn,knr->bkr", xl,
                                         self.V_list[i].to(dtype)))
            cx = torch.tanh(torch.einsum("bkr,ksr->bks", vx,
                                         self.C_list[i].to(dtype)))
            ux = torch.einsum("bks,kns->bkn", cx, self.U_list[i].to(dtype))
            dot = ux + self.bias[i].to(dtype)[None, :, 0][:, None, :]
            expert_out = x0[:, None, :] * dot                   # [B, K, n]
            moe = torch.einsum("bkn,bk->bn", expert_out,
                               torch.softmax(g, dim=1))
            xl = moe + xl
        return xl


class InnerProductLayer(nn.Module):
    """Inner products ``<v_i, v_j>`` of every field pair (PNN): [B, F, E]
    -> [B, P, 1], or the element products [B, P, E] without
    ``reduce_sum`` (``deepctr_tpu/layers/interaction.py:352-367``).  The
    port takes the number of fields at construction, ``field_size``, to
    build the pair indices once."""

    def __init__(self, reduce_sum=True, *, field_size, device=None):
        super().__init__()
        self.reduce_sum = reduce_sum
        _register_pairs(self, field_size, device)

    def forward(self, inputs):
        p, q = _pairs(self, inputs)
        inner = p * q
        if self.reduce_sum:
            inner = torch.sum(inner, dim=2, keepdim=True)
        return inner


class OutterProductLayer(nn.Module):
    """Kernel products of every field pair (PNN): [B, F, E] -> [B, P]
    (``deepctr_tpu/layers/interaction.py:370-399``).  ``"mat"``:
    ``sum_{i,j} p_j K[i, pair, j] q_i`` with ``kernel`` [E, P, E], in the
    compute dtype; ``"vec"``/``"num"``: ``sum_e p q k`` with ``kernel``
    [P, E] or [P, 1], in the inputs' dtype.  ``kernel`` is
    xavier-uniform."""

    def __init__(self, field_size, embedding_size, kernel_type="mat",
                 device=None, generator=None):
        super().__init__()
        _register_pairs(self, field_size, device)
        P, E = self.rows.numel(), embedding_size
        shapes = {"mat": (E, P, E), "vec": (P, E), "num": (P, 1)}
        if kernel_type not in shapes:
            raise ValueError("kernel_type must be mat, vec or num")
        self.kernel_type = kernel_type
        self.kernel = nn.Parameter(_xavier_uniform(shapes[kernel_type],
                                                   device, generator))

    def forward(self, inputs):
        p, q = _pairs(self, inputs)
        if self.kernel_type == "mat":
            dtype = config.compute_dtype()
            kp = torch.einsum("bpj,ipj->bpi", p.to(dtype),
                              self.kernel.to(dtype))
            return torch.sum(kp * q.to(dtype), dim=-1)
        return torch.sum(p * q * self.kernel[None].to(p.dtype), dim=-1)
