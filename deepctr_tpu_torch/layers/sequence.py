"""Sequence (behaviour-history) layers.

Counterpart of ``deepctr_tpu/layers/sequence.py``.  Histories are padded
to a static ``maxlen`` and masked by their lengths.  The GRU family hoists
the input projection out of the recurrence into one matmul and runs the
masked recurrence through ``ops/gru.py:gru_scan`` (on the card the CUDA
kernel, and in training its backward kernel);
``AttentionSequencePoolingLayer`` runs the fused attention kernel
(``ops/attention.py``) at inference and the composition in training.
"""

import torch
from torch import nn

from .. import config
from ..ops._args import ParamCache
from ..ops.attention import (ACTIVATIONS, MAX_EMBEDDING, din_attention_fused,
                             pack_params)
from ..ops.dispatch import din_attention
from ..ops.gru import gru_scan
from .core import LocalActivationUnit


def masked_pooling(seq_value_len_list, mode, supports_masking):
    """Masked sum/mean/max pooling over [B, T, E] -> [B, 1, E].

    With ``supports_masking=True`` the second element is a boolean mask
    [B, T]; otherwise it is a length column [B, 1] (floats are truncated).
    A sequence with no valid step max-pools to 0, not to the mask constant
    (``deepctr_tpu/layers/sequence.py:36-43``)."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError("parameter mode should in [sum, mean, max]")
    if supports_masking:
        seq, mask = seq_value_len_list                # [B,T,E], [B,T] bool
        mask = mask.to(seq.dtype)
        length = torch.sum(mask, dim=-1, keepdim=True)          # [B,1]
        mask = mask[:, :, None]
    else:
        seq, length = seq_value_len_list              # [B,T,E], [B,1]
        pos = torch.arange(seq.shape[1], device=seq.device)[None, :]
        mask = (pos < length.to(torch.int32))[:, :, None].to(seq.dtype)
    if mode == "max":
        hist = seq - (1.0 - mask) * 1e9
        out = torch.amax(hist, dim=1, keepdim=True)
        return torch.where(length[:, None] > 0, out, torch.zeros_like(out))
    hist = torch.sum(seq * mask, dim=1)
    if mode == "mean":
        hist = hist / (length.to(seq.dtype) + 1e-8)
    return hist[:, None, :]


class SequencePoolingLayer(nn.Module):
    """Module wrapper around :func:`masked_pooling`."""

    def __init__(self, mode="mean", supports_masking=False):
        super().__init__()
        self.mode = mode
        self.supports_masking = supports_masking

    def forward(self, seq_value_len_list):
        return masked_pooling(seq_value_len_list, self.mode,
                              self.supports_masking)


class KMaxPooling(nn.Module):
    """The ``k`` largest values along ``axis``, in descending order
    (``deepctr_tpu/layers/sequence.py:127-144``).

    The JAX layer takes them with ``lax.top_k``, which puts the lower
    index first among equal values; ``torch.topk`` does not promise that.
    Here a stable descending sort orders the values, so equal values keep
    their index order, and the first ``k`` are gathered from the input: the
    gradient lands on the fields ``lax.top_k`` picks (CCPM's tanh saturates
    to exactly +-1 at bfloat16, so ties are common)."""

    def __init__(self, k, axis):
        super().__init__()
        self.k = k
        self.axis = axis

    def forward(self, inputs):
        if self.axis < 0 or self.axis >= inputs.dim():
            raise ValueError("axis must be 0~%d,now is %d"
                             % (inputs.dim() - 1, self.axis))
        if self.k < 1 or self.k > inputs.shape[self.axis]:
            raise ValueError("k must be in 1 ~ %d,now k is %d"
                             % (inputs.shape[self.axis], self.k))
        x = inputs.movedim(self.axis, -1).contiguous()
        order = torch.sort(x.detach(), dim=-1, descending=True,
                           stable=True).indices[..., :self.k].contiguous()
        return torch.gather(x, -1, order).movedim(-1, self.axis)


class AttentionSequencePoolingLayer(nn.Module):
    """DIN/DIEN attention over a history: LocalActivationUnit scores,
    masked, optionally softmax-normalised, then a weighted sum of the keys
    (or the [B, 1, T] weights with ``return_score``).

    At inference, without ``return_score``, with a sigmoid, relu or linear
    activation and E <= 512, the whole readout is one call of the
    ``deepctr_tpu_torch::din_attention_fused`` op (``ops/attention.py``),
    as the JAX layer dispatches its Pallas kernel
    (``deepctr_tpu/layers/sequence.py:101-120``): one launch of the fused
    kernel on CUDA tensors, its plain version (float32) on CPU tensors, so
    that an exported model carries the op on either device.  Dice, the
    score path and training run the composition."""

    def __init__(self, att_hidden_units=(80, 40), att_activation="sigmoid",
                 weight_normalization=False, return_score=False,
                 supports_masking=False, embedding_dim=4, device=None,
                 generator=None):
        super().__init__()
        self.att_activation = att_activation
        self.weight_normalization = weight_normalization
        self.return_score = return_score
        self.supports_masking = supports_masking
        self.local_att = LocalActivationUnit(
            hidden_units=att_hidden_units, embedding_dim=embedding_dim,
            activation=att_activation, device=device, generator=generator)
        # the fused kernel's packed weights, rebuilt when they change
        self._packed = ParamCache()

    def _fused(self, query, keys, training):
        return (not training and not self.return_score
                and self.att_activation in ACTIVATIONS
                and keys.shape[2] <= MAX_EMBEDDING)

    def fused_readout(self, query, keys, mask):
        """The fused kernel's readout with this layer's weights: query
        [B,1,E], keys [B,T,E], mask [B,T] -> [B,1,E]."""
        att = self.local_att
        layers = [getattr(att.dnn, "dense_%d" % i)
                  for i in range(len(att.dnn.hidden_units))] + [att.dense]
        params = [(d.weight.t(), d.bias) for d in layers]
        packed = self._packed.get([t for d in layers for t in (d.weight,
                                                               d.bias)],
                                  None, lambda: pack_params(params))
        return din_attention_fused(query, keys, mask, params,
                                   self.att_activation,
                                   self.weight_normalization, packed=packed)

    def forward(self, query, keys, keys_length=None, mask=None,
                training=False):
        T = keys.shape[1]
        if self.supports_masking:
            if mask is None:
                raise ValueError(
                    "When supports_masking=True, input must support masking")
            keys_masks = mask[:, None, :]                       # [B,1,T]
        else:
            pos = torch.arange(T, device=keys.device)[None, :]
            keys_masks = (pos < keys_length.reshape(-1, 1))[:, None, :]
        if self._fused(query, keys, training):
            return self.fused_readout(query, keys, keys_masks[:, 0, :])
        scores = self.local_att(query, keys, training)          # [B,T,1]
        return din_attention(scores.transpose(1, 2), keys, keys_masks,
                             self.weight_normalization, self.return_score)


def _gru_params(module, input_size, hidden_size, init_std, device,
                generator):
    """``weight_ih [3H, I]``, ``weight_hh [3H, H]`` from normal(init_std),
    zero ``bias_ih``/``bias_hh`` (separate, unlike upstream's AUGRU)."""
    for name, cols in (("weight_ih", input_size), ("weight_hh", hidden_size)):
        w = torch.empty(3 * hidden_size, cols, device=device)
        w.normal_(0.0, init_std, generator=generator)
        module.register_parameter(name, nn.Parameter(w))
    for name in ("bias_ih", "bias_hh"):
        module.register_parameter(name, nn.Parameter(
            torch.zeros(3 * hidden_size, device=device)))


def _gru_gates(x, h, module):
    dtype = x.dtype
    gi = x @ module.weight_ih.t().to(dtype) + module.bias_ih.to(dtype)
    gh = h @ module.weight_hh.t().to(dtype) + module.bias_hh.to(dtype)
    return gi.chunk(3, dim=-1) + gh.chunk(3, dim=-1)


def _gru_input_gates(inputs, w_ih, b_ih):
    """The input projection of every time step as one [B*T, I] x [I, 3H]
    matmul in the compute dtype: [B, T, I] -> [T, B, 3H] (a view of the
    [B, T, 3H] product)."""
    ct = config.compute_dtype()
    gi = inputs.to(ct) @ w_ih.t().to(ct) + b_ih.to(ct)
    return gi.transpose(0, 1)


def _gru_recurrence(gi, module, lengths, att, mode):
    """``gru_scan`` over hoisted gates gi [T, B, 3H] with ``module``'s
    recurrent weights (rounded to gi's dtype, as the JAX layer gives them)
    and the mask of ``lengths`` [B]: -> (outputs [B, T, H], final state
    [B, H]).  Under autograd the float32 copy of W_hh^T is built afresh,
    so the way back rounds dW_hh to gi's dtype, as the JAX wrapper does
    (``pallas_gru.py:335``); the scores' gradient comes back as [B, T]."""
    T, B, _ = gi.shape
    dtype = gi.dtype
    pos = torch.arange(T, device=gi.device)[None, :]
    mask = pos < lengths.to(torch.int32).reshape(-1, 1)
    att_bt = None if att is None else att.reshape(B, T).to(dtype)
    w_hh, b_hh = module.weight_hh, module.bias_hh
    whh_t, bhh = module._recurrent.get(
        [w_hh, b_hh], dtype, lambda: (
            w_hh.t().to(dtype).float().contiguous(), b_hh.to(dtype).float()))
    outs, h_last = gru_scan(gi, whh_t, bhh, mask, att=att_bt, mode=mode)
    return outs.transpose(0, 1), h_last


class AGRUCell(nn.Module):
    """GRU cell whose update gate is replaced by the attention score."""

    def __init__(self, input_size, hidden_size, init_std=1e-3, device=None,
                 generator=None):
        super().__init__()
        _gru_params(self, input_size, hidden_size, init_std, device,
                    generator)

    def forward(self, x, h, att_score):
        i_r, _, i_n, h_r, _, h_n = _gru_gates(x, h, self)
        reset = torch.sigmoid(i_r + h_r)
        new = torch.tanh(i_n + reset * h_n)
        a = att_score.reshape(-1, 1).to(h.dtype)
        return (1.0 - a) * h + a * new


class AUGRUCell(nn.Module):
    """GRU cell with an attention-scaled update gate (AUGRU, DIEN)."""

    def __init__(self, input_size, hidden_size, init_std=1e-3, device=None,
                 generator=None):
        super().__init__()
        _gru_params(self, input_size, hidden_size, init_std, device,
                    generator)

    def forward(self, x, h, att_score):
        i_r, i_z, i_n, h_r, h_z, h_n = _gru_gates(x, h, self)
        reset = torch.sigmoid(i_r + h_r)
        update = torch.sigmoid(i_z + h_z)
        new = torch.tanh(i_n + reset * h_n)
        update = att_score.reshape(-1, 1).to(h.dtype) * update
        return (1.0 - update) * h + update * new


class DynamicGRU(nn.Module):
    """Attention-gated GRU (AGRU or AUGRU) over padded sequences: steps at
    or past a row's length keep its state and emit zeros.

    ``forward(inputs [B,T,I], att_scores [B,T] or [B,1,T], lengths [B])``
    -> ``(outputs [B,T,H], final_state [B,H])``."""

    def __init__(self, input_size, hidden_size, gru_type="AGRU",
                 init_std=1e-3, device=None, generator=None):
        super().__init__()
        if gru_type not in ("AGRU", "AUGRU"):
            raise NotImplementedError(gru_type)
        self.gru_type = gru_type
        _gru_params(self, input_size, hidden_size, init_std, device,
                    generator)
        # the recurrence's float32 copies of W_hh^T and b_hh
        self._recurrent = ParamCache()

    def forward(self, inputs, att_scores, lengths, training=False):
        gi = _gru_input_gates(inputs, self.weight_ih, self.bias_ih)
        mode = "augru" if self.gru_type == "AUGRU" else "agru"
        return _gru_recurrence(gi, self, lengths, att_scores, mode)


class MaskedGRU(nn.Module):
    """Standard GRU (torch gate layout) over padded [B,T,I] sequences with
    a length mask, DIEN's interest extractor and evolution GRU.

    ``forward(inputs, lengths)`` -> ``(outputs [B,T,H] zero-padded,
    final_state [B,H])``."""

    def __init__(self, input_size, hidden_size, init_std=1e-3, device=None,
                 generator=None):
        super().__init__()
        _gru_params(self, input_size, hidden_size, init_std, device,
                    generator)
        # the recurrence's float32 copies of W_hh^T and b_hh
        self._recurrent = ParamCache()

    def forward(self, inputs, lengths, training=False):
        gi = _gru_input_gates(inputs, self.weight_ih, self.bias_ih)
        return _gru_recurrence(gi, self, lengths, None, "gru")
