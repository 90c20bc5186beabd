"""DIN (Zhou et al., 2018): deep interest network, attention over the
user-behaviour sequence keyed by the candidate item.

Counterpart of ``deepctr_tpu/models/din.py``.  Behaviour sequences are
``VarLenSparseFeat`` named ``hist_<x>`` for each ``x`` in
``history_feature_list``; they share tables with the query features
through ``embedding_name`` and declare ``length_name``.
"""

import torch

from .basemodel import BaseModel
from ..features import DenseFeat, SparseFeat, VarLenSparseFeat
from ..inputs import (combined_dnn_input, embedding_lookup, get_dense_input,
                      get_varlen_pooling_list, maxlen_lookup,
                      varlen_embedding_lookup)
from ..layers import DNN
from ..layers.core import _dense
from ..layers.sequence import AttentionSequencePoolingLayer


class DIN(BaseModel):
    """Instantiates DIN with the JAX package's constructor.  Runs on
    ``device`` (default ``"cuda"``); ``predict``, ``fit`` and ``evaluate``
    (a training forward runs Dice, the default attention activation, on
    its batch statistics).  ``mesh`` and ``shard_embeddings`` run it over
    ranks (``parallel/``)."""

    def __init__(self, dnn_feature_columns, history_feature_list,
                 dnn_use_bn=False, dnn_hidden_units=(256, 128),
                 dnn_activation="relu", att_hidden_size=(64, 16),
                 att_activation="Dice", att_weight_normalization=False,
                 l2_reg_dnn=0.0, l2_reg_embedding=1e-6, dnn_dropout=0,
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
        varlen = [f for f in cols if isinstance(f, VarLenSparseFeat)]
        self.history_fc_names = ["hist_" + x
                                 for x in self.history_feature_list]
        self.history_feature_columns = [f for f in varlen
                                        if f.name in self.history_fc_names]
        self.sparse_varlen_feature_columns = [
            f for f in varlen if f.name not in self.history_fc_names]
        # every lookup of a forward, in one gather launch a row width
        self._gather_columns = (self.sparse_feature_columns
                                + self.history_feature_columns
                                + self.sparse_varlen_feature_columns)

        att_dim = sum(f.embedding_dim for f in self.sparse_feature_columns
                      if f.name in self.history_feature_list)
        self.attention = AttentionSequencePoolingLayer(
            att_hidden_units=tuple(att_hidden_size),
            att_activation=att_activation.lower(),
            weight_normalization=att_weight_normalization,
            return_score=False, supports_masking=False,
            embedding_dim=att_dim, device=device, generator=generator)
        dnn_in = (sum(f.embedding_dim for f in self.sparse_feature_columns
                      + self.sparse_varlen_feature_columns)
                  + att_dim + sum(f.dimension
                                  for f in self.dense_feature_columns))
        self.dnn = DNN(dnn_in, dnn_hidden_units, activation=dnn_activation,
                       dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                       init_std=init_std, device=device, generator=generator)
        self.dnn_linear = _dense(dnn_hidden_units[-1], 1, use_bias=False,
                                 device=device, generator=generator)
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)

    def forward(self, X, training=False):
        index, ed = self.feature_index, self.embedding_dict
        rows = ed.gather(X, index, self._gather_columns)
        dense_value_list = get_dense_input(X, index,
                                           self.dense_feature_columns)
        query_emb_list = embedding_lookup(
            X, ed, index, self.sparse_feature_columns,
            return_feat_list=self.history_feature_list, to_list=True,
            rows=rows)
        keys_emb_list = embedding_lookup(
            X, ed, index, self.history_feature_columns,
            return_feat_list=self.history_fc_names, to_list=True, rows=rows)
        dnn_input_emb_list = embedding_lookup(
            X, ed, index, self.sparse_feature_columns, to_list=True,
            rows=rows)
        sequence_embed_dict = varlen_embedding_lookup(
            X, ed, index, self.sparse_varlen_feature_columns, rows=rows)
        dnn_input_emb_list += get_varlen_pooling_list(
            sequence_embed_dict, X, index,
            self.sparse_varlen_feature_columns)

        deep_input_emb = torch.cat(dnn_input_emb_list, dim=-1)
        query_emb = torch.cat(query_emb_list, dim=-1)          # [B, 1, E]
        keys_emb = torch.cat(keys_emb_list, dim=-1)            # [B, T, E]
        keys_length = maxlen_lookup(
            X, index, [f.length_name for f in self.history_feature_columns
                       if f.length_name is not None])[:, 0]

        hist = self.attention(query_emb, keys_emb, keys_length,
                              training=training)               # [B, 1, E]
        deep_input_emb = torch.cat(
            [deep_input_emb, hist.to(deep_input_emb.dtype)], dim=-1)
        deep_input_emb = deep_input_emb.reshape(deep_input_emb.shape[0], -1)
        dnn_input = combined_dnn_input([deep_input_emb], dense_value_list)
        dnn_output = self.dnn(dnn_input, training)
        dnn_logit = self.dnn_linear(dnn_output).float()
        return self.out(dnn_logit)
