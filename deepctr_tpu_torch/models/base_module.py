"""Shared building blocks for all models.

Counterpart of ``deepctr_tpu/models/base_module.py``.  ``LinearModel`` is
the wide/linear part; ``BaseModule`` owns the shared embedding tables, the
linear part and the prediction head, and gives the canonical embed step.
"""

import torch
from torch import nn

from ..features import (SparseFeat, DenseFeat, VarLenSparseFeat,
                        build_input_features)
from ..inputs import (EmbeddingDict, embedding_lookup,
                      varlen_embedding_lookup, get_varlen_pooling_list,
                      get_dense_input, compute_input_dim, embedding_size_of)
from ..layers.core import PredictionLayer


def fused_wide_names(linear_feature_columns, dnn_feature_columns):
    """Tables whose wide weight rides as an extra column of the deep
    table: every embedding_name used by the linear columns that a deep
    column also declares with the same vocabulary."""
    deep = {f.embedding_name: (f.vocabulary_size, f.embedding_dim)
            for f in dnn_feature_columns
            if isinstance(f, (SparseFeat, VarLenSparseFeat))}
    fused = []
    for f in linear_feature_columns:
        if not isinstance(f, (SparseFeat, VarLenSparseFeat)):
            continue
        entry = deep.get(f.embedding_name)
        if entry is None or entry[0] != f.vocabulary_size:
            continue
        if f.embedding_name not in fused:
            fused.append(f.embedding_name)
    return tuple(fused)


class LinearModel(nn.Module):
    """Wide part: dim-1 embeddings for sparse feats, a weight vector for
    dense feats, masked-pooled dim-1 embeddings for varlen feats.
    Supports the IFM/DIFM ``sparse_feat_refine_weight`` rescaling hook.

    Features whose table name appears in ``fused_names`` read their wide
    weight from the extra column of the shared deep table
    (``shared_embedding_dict.wide``); the others have their own width-1
    tables here.
    """

    def __init__(self, feature_columns, feature_index, init_std=1e-4,
                 shared_embedding_dict=None, fused_names=(), device=None,
                 generator=None):
        super().__init__()
        cols = list(feature_columns)
        self.feature_index = dict(feature_index)
        self.fused_names = tuple(fused_names)
        self.sparse_feature_columns = [
            f for f in cols if isinstance(f, SparseFeat)]
        self.dense_feature_columns = [
            f for f in cols if isinstance(f, DenseFeat)]
        self.varlen_sparse_feature_columns = [
            f for f in cols if isinstance(f, VarLenSparseFeat)]
        own_cols = [f for f in cols
                    if not (isinstance(f, (SparseFeat, VarLenSparseFeat))
                            and f.embedding_name in self.fused_names)]
        self.embedding_dict = EmbeddingDict(own_cols, init_std, linear=True,
                                            device=device,
                                            generator=generator)
        # not a submodule: the shared tables belong to the model's own
        # embedding_dict, and registering them here too would list them
        # twice in state_dict
        object.__setattr__(self, "shared_embedding_dict",
                           shared_embedding_dict)
        dense_dim = sum(f.dimension for f in self.dense_feature_columns)
        if dense_dim > 0:
            weight = torch.empty(dense_dim, 1, device=device)
            weight.normal_(0.0, init_std, generator=generator)
            self.weight = nn.Parameter(weight)

    def forward(self, X, rows=None, sparse_feat_refine_weight=None):
        """``rows``: full-width rows of the shared tables from
        ``shared_embedding_dict.gather``, covering the fused features;
        without them this gathers those features itself."""
        index = self.feature_index
        cols = self.sparse_feature_columns + self.varlen_sparse_feature_columns
        fused = [fc for fc in cols if fc.embedding_name in self.fused_names]
        own = [fc for fc in cols if fc.embedding_name not in self.fused_names]
        if fused and rows is None:
            rows = self.shared_embedding_dict.gather(X, index, fused)
        own_rows = self.embedding_dict.gather(X, index, own) if own else {}

        def lookup(fc):
            if fc.embedding_name in self.fused_names:
                return self.shared_embedding_dict.wide(fc.embedding_name,
                                                       rows[fc.name])
            return self.embedding_dict(fc.embedding_name, own_rows[fc.name])

        sparse_embedding_list = [lookup(fc)
                                 for fc in self.sparse_feature_columns]
        sparse_embedding_list += get_varlen_pooling_list(
            {fc.name: lookup(fc)
             for fc in self.varlen_sparse_feature_columns},
            X, index, self.varlen_sparse_feature_columns)
        dense_value_list = get_dense_input(X, index,
                                           self.dense_feature_columns)

        linear_logit = torch.zeros((X.shape[0], 1), dtype=X.dtype,
                                   device=X.device)
        if len(sparse_embedding_list) > 0:
            cat = torch.cat(sparse_embedding_list, dim=-1)   # [B,1,n]
            if sparse_feat_refine_weight is not None:
                cat = cat * sparse_feat_refine_weight[:, None, :]
            linear_logit = linear_logit + torch.sum(cat, dim=-1)
        if len(dense_value_list) > 0:
            dense = torch.cat(dense_value_list, dim=-1)
            linear_logit = linear_logit + dense @ self.weight.to(dense.dtype)
        return linear_logit


class BaseModule(nn.Module):
    """Base for all models: owns the shared embedding tables, the linear
    part and the prediction head; exposes the canonical embed step."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 task="binary", init_std=1e-4, device=None, generator=None):
        super().__init__()
        self.linear_feature_columns = list(linear_feature_columns)
        self.dnn_feature_columns = list(dnn_feature_columns)
        self.feature_index = build_input_features(
            self.linear_feature_columns + self.dnn_feature_columns)
        fused = fused_wide_names(self.linear_feature_columns,
                                 self.dnn_feature_columns)
        self.embedding_dict = EmbeddingDict(self.dnn_feature_columns,
                                            init_std, wide_names=fused,
                                            device=device,
                                            generator=generator)
        self.linear_model = LinearModel(
            self.linear_feature_columns, self.feature_index, init_std,
            shared_embedding_dict=self.embedding_dict, fused_names=fused,
            device=device, generator=generator)
        self.out = PredictionLayer(task, device=device)
        # every feature a forward reads from the shared tables, deep and
        # wide, so that one gather per row width serves them all
        sparse = (SparseFeat, VarLenSparseFeat)
        shared = {f.name: f for f in self.dnn_feature_columns
                  if isinstance(f, sparse)}
        for f in self.linear_feature_columns:
            if isinstance(f, sparse) and f.embedding_name in fused:
                shared.setdefault(f.name, f)
        self._shared_columns = list(shared.values())

    def shared_rows(self, X):
        """Full-width rows of every feature read from the shared tables:
        ``{feature name: [B, 1 or maxlen, width]}``, one launch per row
        width."""
        return self.embedding_dict.gather(X, self.feature_index,
                                          self._shared_columns)

    def embed_columns(self, X, feature_columns, support_dense=True,
                      rows=None):
        """Canonical embed step on a flat device batch X [B, input_dim]:
        (sparse embeddings [B,1,E] list, then the pooled varlen ones, dense
        values [B,d] list).  ``rows`` from :meth:`shared_rows` lets the
        linear part share this gather.  The JAX module calls this step
        ``input_from_feature_columns``; in the port that name is the
        model's host-input hook (``BaseModel.input_from_feature_columns``),
        since model and module are one object here."""
        sparse_feature_columns = [f for f in feature_columns
                                  if isinstance(f, SparseFeat)]
        dense_feature_columns = [f for f in feature_columns
                                 if isinstance(f, DenseFeat)]
        varlen_sparse_feature_columns = [f for f in feature_columns
                                         if isinstance(f, VarLenSparseFeat)]
        if not support_dense and len(dense_feature_columns) > 0:
            raise ValueError("DenseFeat is not supported in dnn_feature_columns")
        if rows is None:
            rows = self.embedding_dict.gather(
                X, self.feature_index,
                sparse_feature_columns + varlen_sparse_feature_columns)
        sparse_embedding_list = embedding_lookup(
            X, self.embedding_dict, self.feature_index,
            sparse_feature_columns, to_list=True, rows=rows)
        seq_embed_dict = varlen_embedding_lookup(
            X, self.embedding_dict, self.feature_index,
            varlen_sparse_feature_columns, rows=rows)
        varlen_embedding_list = get_varlen_pooling_list(
            seq_embed_dict, X, self.feature_index,
            varlen_sparse_feature_columns)
        dense_value_list = get_dense_input(X, self.feature_index,
                                           dense_feature_columns)
        return sparse_embedding_list + varlen_embedding_list, dense_value_list

    def compute_input_dim(self, feature_columns, include_sparse=True,
                          include_dense=True, feature_group=False):
        return compute_input_dim(feature_columns, include_sparse,
                                 include_dense, feature_group)

    @property
    def embedding_size(self):
        return embedding_size_of(self.dnn_feature_columns)
