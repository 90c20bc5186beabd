"""PNN (Qu et al., 2016): product layers (inner/outer) feeding a DNN.

Counterpart of ``deepctr_tpu/models/pnn.py``.  No wide/linear part: the
base is built with an empty linear column list.
"""

import torch

from .basemodel import BaseModel
from ..inputs import combined_dnn_input
from ..layers import DNN, InnerProductLayer, OutterProductLayer
from ..layers.core import _dense


class PNN(BaseModel):
    """Instantiates the PNN architecture, with the JAX package's
    constructor (``dnn_feature_columns`` only).  Runs on ``device``
    (default ``"cuda"``; raises where CUDA is absent unless
    ``device="cpu"``).  ``mesh``/``shard_embeddings`` are not ported yet
    and raise, as does ``dnn_dropout > 0``."""

    def __init__(self, dnn_feature_columns, dnn_hidden_units=(128, 128),
                 l2_reg_embedding=1e-5, l2_reg_dnn=0, init_std=1e-4,
                 seed=1024, dnn_dropout=0, dnn_activation="relu",
                 use_inner=True, use_outter=False, kernel_type="mat",
                 task="binary", device=None, gpus=None, mesh=None,
                 shard_embeddings=False):
        if mesh is not None or shard_embeddings:
            raise NotImplementedError("sharded models are not ported yet")
        if kernel_type not in ("mat", "vec", "num"):
            raise ValueError("kernel_type must be mat,vec or num")
        super().__init__([], dnn_feature_columns, l2_reg_linear=0,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task,
                         device=device, gpus=gpus)
        generator = self._init_generator
        device = generator.device
        self.use_inner = use_inner
        self.use_outter = use_outter
        num_inputs = self.compute_input_dim(
            self.dnn_feature_columns, include_dense=False, feature_group=True)
        embedding_size = self.embedding_size
        n_pairs = num_inputs * (num_inputs - 1) // 2
        # the product layer: the fields flat, then the inner and the outer
        # products of every pair, then the dense values
        in_dim = num_inputs * embedding_size + self.compute_input_dim(
            self.dnn_feature_columns, include_sparse=False)
        if use_inner:
            self.innerproduct = InnerProductLayer(field_size=num_inputs,
                                                  device=device)
            in_dim += n_pairs
        if use_outter:
            self.outterproduct = OutterProductLayer(
                num_inputs, embedding_size, kernel_type=kernel_type,
                device=device, generator=generator)
            in_dim += n_pairs
        self.dnn = DNN(in_dim, dnn_hidden_units, activation=dnn_activation,
                       dropout_rate=dnn_dropout, use_bn=False,
                       init_std=init_std, device=device, generator=generator)
        self.dnn_linear = _dense(dnn_hidden_units[-1], 1, use_bias=False,
                                 device=device, generator=generator)
        # deepctr_tpu/models/pnn.py:84-85, by JAX path
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)
        self.add_regularization_rule(r"^dnn_linear/kernel$", l2=l2_reg_dnn)

    def forward(self, X, training=False):
        sparse_embedding_list, dense_value_list = (
            self.embed_columns(X, self.dnn_feature_columns))
        emb = torch.cat(sparse_embedding_list, dim=1)          # [B, F, E]
        parts = [emb.reshape(emb.shape[0], -1)]
        if self.use_inner:
            inner = self.innerproduct(emb)
            parts.append(inner.reshape(inner.shape[0], -1))
        if self.use_outter:
            parts.append(self.outterproduct(emb))
        product_layer = torch.cat(parts, dim=1)
        dnn_input = combined_dnn_input([product_layer], dense_value_list)
        dnn_output = self.dnn(dnn_input, training)
        return self.out(self.dnn_linear(dnn_output).float())
