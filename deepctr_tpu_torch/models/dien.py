"""DIEN (Zhou et al., 2019): interest extractor GRU (+ auxiliary loss on
negative samples) -> interest evolving GRU (GRU/AIGRU/AGRU/AUGRU) -> DNN.

Counterpart of ``deepctr_tpu/models/dien.py``.  Both GRUs run the masked
recurrence of ``ops/gru.py`` (rows with ``length == 0`` keep a zero state;
on the card its forward and backward kernels), and the ``GRU`` variant's
attention readout the fused kernel of ``ops/attention.py`` at inference.
With ``use_negsampling`` a training forward also gathers the
``neg_hist_*`` sequences (in the same gather launch as the other fields)
and computes the auxiliary loss, which the train step adds to the total
loss scaled by ``alpha``; ``predict`` neither runs it nor gathers them.
"""

import torch
from torch import nn

from .basemodel import BaseModel
from ..features import DenseFeat, SparseFeat, VarLenSparseFeat
from ..inputs import (combined_dnn_input, embedding_lookup, get_dense_input,
                      maxlen_lookup)
from ..layers import DNN
from ..layers.core import _dense
from ..parallel import context
from ..layers.sequence import (AttentionSequencePoolingLayer, DynamicGRU,
                               MaskedGRU)


class InterestExtractor(nn.Module):
    """GRU over the behaviour sequence, and the auxiliary BCE that pushes
    state t to tell the click at t + 1 from the non-click
    (``deepctr_tpu/models/dien.py:27-74``)."""

    def __init__(self, input_size, use_neg=False, init_std=1e-3, device=None,
                 generator=None):
        super().__init__()
        self.use_neg = use_neg
        self.gru = MaskedGRU(input_size, input_size, init_std=init_std,
                             device=device, generator=generator)
        if use_neg:
            self.auxiliary_net = DNN(2 * input_size, (100, 50, 1),
                                     activation="sigmoid", init_std=init_std,
                                     device=device, generator=generator)

    def forward(self, keys, keys_length, neg_keys=None, training=False):
        """keys [B, T, H], keys_length [B], neg_keys [B, T, H] or None ->
        (interests [B, T, H], auxiliary loss: a float32 scalar, 0 without
        negative samples)."""
        interests, _ = self.gru(keys, keys_length, training=training)
        aux_loss = torch.zeros((), dtype=torch.float32, device=keys.device)
        if self.use_neg and neg_keys is not None:
            aux_loss = self._auxiliary_loss(
                interests[:, :-1, :], keys[:, 1:, :], neg_keys[:, 1:, :],
                keys_length - 1, training)
        return interests, aux_loss

    def _auxiliary_loss(self, states, click_seq, noclick_seq, keys_length,
                        training):
        """The mean BCE over the valid (state, next behaviour) pairs, the
        clicks and the non-clicks, each through its own pass of the
        auxiliary network (``deepctr_tpu/models/dien.py:53-74``)."""
        T = states.shape[1]
        pos = torch.arange(T, device=states.device)[None, :]
        mask = (pos < torch.clamp_min(keys_length, 0).reshape(-1, 1)).to(
            torch.float32)
        click_p = self.auxiliary_net(torch.cat(
            [states, click_seq.to(states.dtype)], dim=-1), training)[..., 0]
        noclick_p = self.auxiliary_net(torch.cat(
            [states, noclick_seq.to(states.dtype)], dim=-1),
            training)[..., 0]
        eps = 1e-7
        click_p = torch.clamp(click_p.float(), eps, 1 - eps)
        noclick_p = torch.clamp(noclick_p.float(), eps, 1 - eps)
        losses = -(torch.log(click_p) + torch.log(1.0 - noclick_p)) * mask
        # on a mesh the global batch's count of pairs, so that the ranks'
        # terms sum to the one rank's mean
        denom = 2.0 * torch.clamp_min(context.data_sum(torch.sum(mask)),
                                      1.0)
        return torch.sum(losses) / denom


class InterestEvolving(nn.Module):
    """Attention-directed interest evolution (GRU/AIGRU/AGRU/AUGRU)."""

    def __init__(self, input_size, gru_type="GRU", init_std=1e-3,
                 att_hidden_size=(64, 16), att_activation="sigmoid",
                 att_weight_normalization=False, device=None,
                 generator=None):
        super().__init__()
        if gru_type not in ("GRU", "AIGRU", "AGRU", "AUGRU"):
            raise NotImplementedError(
                "gru_type: %s is not supported" % gru_type)
        self.gru_type = gru_type
        self.attention = AttentionSequencePoolingLayer(
            att_hidden_units=tuple(att_hidden_size),
            att_activation=att_activation,
            weight_normalization=att_weight_normalization,
            return_score=(gru_type != "GRU"), embedding_dim=input_size,
            device=device, generator=generator)
        if gru_type in ("GRU", "AIGRU"):
            self.evolution = MaskedGRU(input_size, input_size,
                                       init_std=init_std, device=device,
                                       generator=generator)
        else:
            self.evolution = DynamicGRU(input_size, input_size,
                                        gru_type=gru_type, init_std=init_std,
                                        device=device, generator=generator)

    def forward(self, query, keys, keys_length, training=False):
        """query [B, H], keys [B, T, H], keys_length [B] -> [B, H]."""
        q = query[:, None, :]
        if self.gru_type == "GRU":
            interests, _ = self.evolution(keys, keys_length,
                                          training=training)
            out = self.attention(q, interests, keys_length,
                                 training=training)[:, 0]
        elif self.gru_type == "AIGRU":
            att_scores = self.attention(q, keys, keys_length,
                                        training=training)     # [B, 1, T]
            interests = keys * att_scores.transpose(1, 2).to(keys.dtype)
            _, out = self.evolution(interests, keys_length,
                                    training=training)
        else:
            att_scores = self.attention(q, keys, keys_length,
                                        training=training)[:, 0]  # [B, T]
            _, out = self.evolution(keys, att_scores, keys_length,
                                    training=training)
        # rows with an empty history emit exactly zero
        valid = (keys_length > 0).reshape(-1, 1)
        return torch.where(valid, out, torch.zeros_like(out))


class DIEN(BaseModel):
    """Instantiates DIEN with the JAX package's constructor.  Runs on
    ``device`` (default ``"cuda"``); ``predict``, ``fit`` and ``evaluate``,
    the auxiliary loss weighed by ``alpha``.  ``mesh`` and
    ``shard_embeddings`` run it over ranks (``parallel/``)."""

    def __init__(self, dnn_feature_columns, history_feature_list,
                 gru_type="GRU", use_negsampling=False, alpha=1.0,
                 use_bn=False, dnn_hidden_units=(256, 128),
                 dnn_activation="relu", att_hidden_units=(64, 16),
                 att_activation="relu", att_weight_normalization=True,
                 l2_reg_dnn=0, l2_reg_embedding=1e-6, dnn_dropout=0,
                 init_std=1e-4, seed=1024, task="binary", device=None,
                 gpus=None, mesh=None, shard_embeddings=False):
        self._capture_init_args(locals())
        super().__init__([], dnn_feature_columns, l2_reg_linear=0,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task,
                         device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        generator = self._init_generator
        device = generator.device
        cols = self.dnn_feature_columns
        self.history_feature_list = list(history_feature_list)
        self.sparse_feature_columns = [f for f in cols
                                       if isinstance(f, SparseFeat)]
        self.dense_feature_columns = [f for f in cols
                                      if isinstance(f, DenseFeat)]
        self.varlen_sparse_feature_columns = [
            f for f in cols if isinstance(f, VarLenSparseFeat)]
        self.history_fc_names = ["hist_" + x
                                 for x in self.history_feature_list]
        self.history_feature_columns = [
            f for f in self.varlen_sparse_feature_columns
            if f.name in self.history_fc_names]
        self.use_negsampling = use_negsampling
        self.alpha = alpha
        self.neg_history_fc_names = ["neg_" + x
                                     for x in self.history_fc_names]
        self.neg_history_feature_columns = [
            f for f in self.varlen_sparse_feature_columns
            if f.name in self.neg_history_fc_names]
        # the lookups of one predict (no neg_hist_*), in one gather launch;
        # a training forward with negative sampling adds neg_hist_*
        self._gather_columns = (self.sparse_feature_columns
                                + self.history_feature_columns)

        interest_dim = sum(f.embedding_dim
                           for f in self.sparse_feature_columns
                           if f.name in self.history_feature_list)
        self.interest_extractor = InterestExtractor(
            interest_dim, use_neg=use_negsampling, init_std=init_std,
            device=device, generator=generator)
        self.interest_evolution = InterestEvolving(
            interest_dim, gru_type=gru_type, init_std=init_std,
            att_hidden_size=att_hidden_units,
            att_activation=att_activation.lower(),
            att_weight_normalization=att_weight_normalization,
            device=device, generator=generator)
        dnn_in = (interest_dim
                  + sum(f.embedding_dim for f in self.sparse_feature_columns)
                  + sum(f.dimension for f in self.dense_feature_columns))
        self.dnn = DNN(dnn_in, dnn_hidden_units, activation=dnn_activation,
                       dropout_rate=dnn_dropout, use_bn=use_bn,
                       init_std=init_std, device=device, generator=generator)
        self.dnn_linear = _dense(dnn_hidden_units[-1], 1, init_std=init_std,
                                 use_bias=False, device=device,
                                 generator=generator)
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)

    def forward(self, X, training=False):
        index, ed = self.feature_index, self.embedding_dict
        with_neg = training and self.use_negsampling
        rows = ed.gather(X, index, self._gather_columns + (
            self.neg_history_feature_columns if with_neg else []))
        query_emb = torch.cat(embedding_lookup(
            X, ed, index, self.sparse_feature_columns,
            return_feat_list=self.history_feature_list, to_list=True,
            rows=rows), dim=-1)[:, 0]                          # [B, H]
        keys_emb = torch.cat(embedding_lookup(
            X, ed, index, self.history_feature_columns,
            return_feat_list=self.history_fc_names, to_list=True,
            rows=rows), dim=-1)                                # [B, T, H]
        keys_length = maxlen_lookup(
            X, index, [f.length_name
                       for f in self.varlen_sparse_feature_columns
                       if f.length_name is not None])[:, 0]
        neg_keys_emb = None
        if with_neg:
            neg_keys_emb = torch.cat(embedding_lookup(
                X, ed, index, self.neg_history_feature_columns,
                return_feat_list=self.neg_history_fc_names, to_list=True,
                rows=rows), dim=-1)                            # [B, T, H]
        masked_interest, aux_loss = self.interest_extractor(
            keys_emb, keys_length, neg_keys_emb, training=training)
        if with_neg:
            self.aux_loss = self.alpha * aux_loss
        hist = self.interest_evolution(query_emb, masked_interest,
                                       keys_length, training)  # [B, H]
        deep_input_emb = torch.cat(embedding_lookup(
            X, ed, index, self.sparse_feature_columns, to_list=True,
            rows=rows), dim=-1)[:, 0]
        deep_input_emb = torch.cat([hist, deep_input_emb.to(hist.dtype)],
                                   dim=-1)
        dense_value_list = get_dense_input(X, index,
                                           self.dense_feature_columns)
        dnn_input = combined_dnn_input([deep_input_emb], dense_value_list)
        output = self.dnn_linear(self.dnn(dnn_input, training)).float()
        return self.out(output)
