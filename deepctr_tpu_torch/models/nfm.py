"""NFM (He & Chua, 2017): bi-interaction pooling feeding a DNN.

Counterpart of ``deepctr_tpu/models/nfm.py``.
"""

import torch

from .basemodel import BaseModel
from ..inputs import combined_dnn_input
from ..layers import DNN, BiInteractionPooling
from ..layers.core import Dropout, _dense


class NFM(BaseModel):
    """Instantiates the NFM architecture, with the JAX package's
    constructor.  Runs on ``device`` (default ``"cuda"``; raises where CUDA
    is absent unless ``device="cpu"``).  ``bi_dropout`` drops values of
    the bi-interaction in training, as ``dnn_dropout`` does after each DNN
    layer (``layers.core.Dropout``).  ``mesh`` and ``shard_embeddings`` run it
    over ranks (``parallel/``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 dnn_hidden_units=(128, 128), l2_reg_embedding=1e-5,
                 l2_reg_linear=1e-5, l2_reg_dnn=0, init_std=1e-4, seed=1024,
                 bi_dropout=0, dnn_dropout=0, dnn_activation="relu",
                 task="binary", device=None, gpus=None, mesh=None,
                 shard_embeddings=False):
        self._capture_init_args(locals())
        super().__init__(linear_feature_columns, dnn_feature_columns,
                         l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task,
                         device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        generator = self._init_generator
        device = generator.device
        # the DNN reads the [B, 1, E] bi-interaction and the dense values
        in_dim = self.embedding_size + self.compute_input_dim(
            self.dnn_feature_columns, include_sparse=False)
        self.dnn = DNN(in_dim, dnn_hidden_units, activation=dnn_activation,
                       dropout_rate=dnn_dropout, use_bn=False,
                       init_std=init_std, device=device, generator=generator)
        self.dnn_linear = _dense(dnn_hidden_units[-1], 1, use_bias=False,
                                 device=device, generator=generator)
        self.bi_pooling = BiInteractionPooling()
        self.bi_dropout_layer = Dropout(bi_dropout)
        # deepctr_tpu/models/nfm.py:68-69, by JAX path
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)
        self.add_regularization_rule(r"^dnn_linear/kernel$", l2=l2_reg_dnn)

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        sparse_embedding_list, dense_value_list = (
            self.embed_columns(X, self.dnn_feature_columns, rows=rows))
        linear_logit = self.linear_model(X, rows=rows)
        bi_out = self.bi_dropout_layer(
            self.bi_pooling(torch.cat(sparse_embedding_list, dim=1)),
            training)
        dnn_input = combined_dnn_input([bi_out], dense_value_list)
        dnn_output = self.dnn(dnn_input, training)
        logit = linear_logit + self.dnn_linear(dnn_output).to(
            linear_logit.dtype)
        return self.out(logit)
