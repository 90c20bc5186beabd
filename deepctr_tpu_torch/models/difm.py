"""DIFM (Lu et al., 2020): dual input-aware FM.  A vector-wise net (field
self-attention) and a bit-wise net (a DNN) jointly estimate the
input-aware factors.

Counterpart of ``deepctr_tpu/models/difm.py``.
"""

import torch

from .basemodel import BaseModel
from .ifm import sparse_feat_num
from ..inputs import combined_dnn_input
from ..layers import DNN, FM, InteractingLayer
from ..layers.core import _dense


class DIFM(BaseModel):
    """Instantiates the DIFM architecture, with the JAX package's
    constructor.  Runs on ``device`` (default ``"cuda"``; raises where CUDA
    is absent unless ``device="cpu"``).  ``mesh`` and ``shard_embeddings`` run
    it over ranks (``parallel/``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 att_head_num=4, att_res=True, dnn_hidden_units=(256, 128),
                 l2_reg_linear=1e-5, l2_reg_embedding=1e-5, l2_reg_dnn=0,
                 init_std=1e-4, seed=1024, dnn_dropout=0,
                 dnn_activation="relu", dnn_use_bn=False, task="binary",
                 device=None, gpus=None, mesh=None, shard_embeddings=False):
        self._capture_init_args(locals())
        if not len(dnn_hidden_units) > 0:
            raise ValueError("dnn_hidden_units is null!")
        super().__init__(linear_feature_columns, dnn_feature_columns,
                         l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task,
                         device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        generator = self._init_generator
        device = generator.device
        embedding_size = self.embedding_size
        self.fm = FM()
        self.vector_wise_net = InteractingLayer(
            embedding_size, att_head_num, att_res, scaling=True,
            device=device, generator=generator)
        self.bit_wise_net = DNN(
            self.compute_input_dim(self.dnn_feature_columns,
                                   include_dense=False),
            dnn_hidden_units, activation=dnn_activation,
            dropout_rate=dnn_dropout, use_bn=dnn_use_bn, init_std=init_std,
            device=device, generator=generator)
        self.sparse_feat_num = sparse_feat_num(self.dnn_feature_columns)
        self.transform_matrix_P_vec = _dense(
            self.sparse_feat_num * embedding_size, self.sparse_feat_num,
            use_bias=False, device=device, generator=generator)
        self.transform_matrix_P_bit = _dense(
            dnn_hidden_units[-1], self.sparse_feat_num, use_bias=False,
            device=device, generator=generator)
        # deepctr_tpu/models/difm.py:101-105, by JAX path
        self.add_regularization_rule(r"^vector_wise_net/W_", l2=l2_reg_dnn)
        self.add_regularization_rule(r"^bit_wise_net/.*kernel$",
                                     l2=l2_reg_dnn)
        self.add_regularization_rule(r"^transform_matrix_P_(vec|bit)/kernel$",
                                     l2=l2_reg_dnn)

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        sparse_embedding_list, _ = self.embed_columns(
            X, self.dnn_feature_columns, rows=rows)
        if not len(sparse_embedding_list) > 0:
            raise ValueError("there are no sparse features")
        fm_input = torch.cat(sparse_embedding_list, dim=1)
        att_out = self.vector_wise_net(fm_input)
        m_vec = self.transform_matrix_P_vec(
            att_out.reshape(X.shape[0], -1))
        dnn_output = self.bit_wise_net(
            combined_dnn_input(sparse_embedding_list, []), training)
        m_bit = self.transform_matrix_P_bit(dnn_output)
        m_x = (m_vec + m_bit).float()
        logit = self.linear_model(X, rows=rows, sparse_feat_refine_weight=m_x)
        refined = fm_input * m_x[:, :, None].to(fm_input.dtype)
        return self.out(logit + self.fm(refined).to(logit.dtype))
