"""IFM (Yu et al., 2019): input-aware factorization machine.  A
factor-estimating DNN gives per-field weights m_{x,i} that rescale both
the linear part and the FM embeddings.

Counterpart of ``deepctr_tpu/models/ifm.py``.
"""

import torch

from .basemodel import BaseModel
from ..features import SparseFeat, VarLenSparseFeat
from ..inputs import combined_dnn_input
from ..layers import DNN, FM
from ..layers.core import _dense


def sparse_feat_num(feature_columns):
    """The sparse and varlen columns: the fields that the input-aware
    factors weigh."""
    return len([f for f in feature_columns
                if isinstance(f, (SparseFeat, VarLenSparseFeat))])


class IFM(BaseModel):
    """Instantiates the IFM architecture, with the JAX package's
    constructor.  Runs on ``device`` (default ``"cuda"``; raises where CUDA
    is absent unless ``device="cpu"``).  ``mesh`` and ``shard_embeddings`` run
    it over ranks (``parallel/``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 dnn_hidden_units=(256, 128), l2_reg_linear=1e-5,
                 l2_reg_embedding=1e-5, l2_reg_dnn=0, init_std=1e-4,
                 seed=1024, dnn_dropout=0, dnn_activation="relu",
                 dnn_use_bn=False, task="binary", device=None, gpus=None,
                 mesh=None, shard_embeddings=False):
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
        self.fm = FM()
        self.factor_estimating_net = DNN(
            self.compute_input_dim(self.dnn_feature_columns,
                                   include_dense=False),
            dnn_hidden_units, activation=dnn_activation,
            dropout_rate=dnn_dropout, use_bn=dnn_use_bn, init_std=init_std,
            device=device, generator=generator)
        self.sparse_feat_num = sparse_feat_num(self.dnn_feature_columns)
        self.transform_weight_matrix_P = _dense(
            dnn_hidden_units[-1], self.sparse_feat_num, use_bias=False,
            device=device, generator=generator)
        # deepctr_tpu/models/ifm.py:82-85, by JAX path
        self.add_regularization_rule(r"^factor_estimating_net/.*kernel$",
                                     l2=l2_reg_dnn)
        self.add_regularization_rule(r"^transform_weight_matrix_P/kernel$",
                                     l2=l2_reg_dnn)

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        sparse_embedding_list, _ = self.embed_columns(
            X, self.dnn_feature_columns, rows=rows)
        if not len(sparse_embedding_list) > 0:
            raise ValueError("there are no sparse features")
        dnn_input = combined_dnn_input(sparse_embedding_list, [])
        dnn_output = self.transform_weight_matrix_P(
            self.factor_estimating_net(dnn_input, training))
        input_aware_factor = (self.sparse_feat_num
                              * torch.softmax(dnn_output, dim=1))
        logit = self.linear_model(
            X, rows=rows, sparse_feat_refine_weight=input_aware_factor)
        fm_input = torch.cat(sparse_embedding_list, dim=1)
        refined = fm_input * input_aware_factor[:, :, None].to(
            fm_input.dtype)
        return self.out(logit + self.fm(refined).to(logit.dtype))
