"""ONN / NFFM (Yang et al., 2019): operation-aware (per-pair) second-order
embeddings feeding a DNN.

Counterpart of ``deepctr_tpu/models/onn.py``.
"""

import numpy as np
import torch
from torch import nn

from .basemodel import BaseModel
from ..features import SparseFeat
from ..inputs import TableHolder, combined_dnn_input, embedding_size_of
from ..layers import DNN
from ..layers.core import _dense


class PairEmbedding(TableHolder):
    """Operation-aware embedding tables (``deepctr_tpu/models/onn.py:
    23-56``): feature i's parameter ``<name>`` is a ``[vocab, F-1, E]``
    table holding one E-vector for each partner feature, partner j in slot
    ``j`` if j < i else ``j - 1``; drawn from normal(init_std).

    The JAX layer takes each table's rows with ``jnp.take``.  Here every
    table is viewed as ``[vocab, (F-1)·E]`` and one ``gather_rows`` launch
    takes the rows of all F (``ops/gather.py``).  In the engine's train step
    the gather is captured as the shared tables' are (:class:`TableHolder`):
    the engine scatters the rows' cotangent into each table's dense
    gradient with ``scatter_add_rows``, K1.  Each
    pair (i < j) multiplies slot j-1 of feature i's row by slot i of
    feature j's; those 2·P slots are each of the F·(F-1) slots once, so one
    ``index_select`` of distinct indices picks them (its backward adds one
    value a slot, in a fixed order)."""

    def __init__(self, sparse_feature_columns, embedding_size, init_std=1e-4,
                 device=None, generator=None):
        super().__init__()
        self.columns = list(sparse_feature_columns)
        F = len(self.columns)
        self.slots = max(F - 1, 1)
        self.embedding_size = embedding_size
        for feat in self.columns:
            table = torch.empty(feat.vocabulary_size, self.slots,
                                embedding_size, device=device)
            table.normal_(0.0, init_std, generator=generator)
            self.register_parameter(feat.name, nn.Parameter(table))
        pairs = [(i, j) for i in range(F - 1) for j in range(i + 1, F)]
        self.num_pairs = len(pairs)
        first = [i * self.slots + j - 1 for i, j in pairs]
        second = [j * self.slots + i for i, j in pairs]
        self.register_buffer("pair_slots", torch.as_tensor(
            np.asarray(first + second, np.int64), device=device),
            persistent=False)

    @property
    def tables(self):
        """``{feature name: [vocab, F-1, E] table}``."""
        return {f.name: getattr(self, f.name) for f in self.columns}

    def forward(self, X, feature_index):
        """-> [B, P, E] pair products, pairs in (i < j) lexicographic
        order."""
        B, E, P = X.shape[0], self.embedding_size, self.num_pairs
        if P == 0:
            return X.new_zeros(B, 0, E)
        names = [f.name for f in self.columns]
        tables = [getattr(self, n).flatten(1) for n in names]
        cols = [feature_index[n][0] for n in names]
        rows = self._gather(X, tables, names, cols)
        picked = rows.view(B, -1, E).index_select(1, self.pair_slots)
        return picked[:, :P] * picked[:, P:]


class ONN(BaseModel):
    """Instantiates the ONN/NFFM architecture, with the JAX package's
    constructor.  Runs on ``device`` (default ``"cuda"``; raises where CUDA
    is absent unless ``device="cpu"``).  Besides the pair tables the model
    keeps the shared ``embedding_dict``, as the JAX model does: its logit
    reads only their wide column, but L2 reaches the deep columns too.  The
    pair tables are dense parameters (``second_order_embedding/<name>``),
    never on the sparse path.  ``mesh`` and ``shard_embeddings`` run it over
    ranks (``parallel/``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 dnn_hidden_units=(128, 128), l2_reg_embedding=1e-5,
                 l2_reg_linear=1e-5, l2_reg_dnn=0, dnn_dropout=0,
                 init_std=1e-4, seed=1024, dnn_use_bn=False,
                 dnn_activation="relu", task="binary", device=None, gpus=None,
                 mesh=None, shard_embeddings=False):
        self._capture_init_args(locals())
        super().__init__(linear_feature_columns, dnn_feature_columns,
                         l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task,
                         device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        generator = self._init_generator
        device = generator.device
        sparse_feats = [f for f in self.dnn_feature_columns
                        if isinstance(f, SparseFeat)]
        embedding_size = embedding_size_of(self.dnn_feature_columns)
        self.second_order_embedding = PairEmbedding(
            sparse_feats, embedding_size, init_std, device=device,
            generator=generator)
        in_dim = (self.second_order_embedding.num_pairs * embedding_size
                  + self.compute_input_dim(self.dnn_feature_columns,
                                           include_sparse=False))
        self.dnn = DNN(in_dim, dnn_hidden_units, activation=dnn_activation,
                       dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                       init_std=init_std, device=device, generator=generator)
        self.dnn_linear = _dense(dnn_hidden_units[-1], 1, use_bias=False,
                                 device=device, generator=generator)
        # deepctr_tpu/models/onn.py:107-111, by JAX path
        self.add_regularization_rule(r"^second_order_embedding/",
                                     l2=l2_reg_embedding)
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)
        self.add_regularization_rule(r"^dnn_linear/kernel$", l2=l2_reg_dnn)

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        _, dense_value_list = self.embed_columns(
            X, self.dnn_feature_columns, rows=rows)
        linear_logit = self.linear_model(X, rows=rows)
        pairs = self.second_order_embedding(X, self.feature_index)
        second_order = ([pairs.reshape(X.shape[0], 1, -1)]
                        if pairs.shape[1] else [])
        dnn_input = combined_dnn_input(second_order, dense_value_list)
        dnn_logit = self.dnn_linear(self.dnn(dnn_input, training)).to(
            linear_logit.dtype)
        if len(self.dnn_feature_columns) > 0:
            return self.out(dnn_logit + linear_logit)
        return self.out(linear_logit)
