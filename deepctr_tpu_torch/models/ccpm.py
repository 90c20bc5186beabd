"""CCPM (Liu et al., 2015): convolutional click prediction model.

Counterpart of ``deepctr_tpu/models/ccpm.py``.
"""

import torch

from .basemodel import BaseModel
from ..layers import DNN, ConvLayer
from ..layers.core import _dense


class CCPM(BaseModel):
    """Instantiates the CCPM architecture, with the JAX package's
    constructor: the fields' embeddings as a [B, 1, F, E] image through
    ``ConvLayer`` (width-w x 1 convolutions along the fields, tanh,
    k-max pooling), then a DNN.  Runs on ``device`` (default ``"cuda"``;
    raises where CUDA is absent unless ``device="cpu"``).  Dense deep
    columns raise at the forward, as the JAX model's.
    ``mesh`` and ``shard_embeddings`` run it over ranks (``parallel/``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 conv_kernel_width=(6, 5), conv_filters=(4, 4),
                 dnn_hidden_units=(256,), l2_reg_linear=1e-5,
                 l2_reg_embedding=1e-5, l2_reg_dnn=0, dnn_dropout=0,
                 init_std=1e-4, seed=1024, task="binary", device=None,
                 dnn_use_bn=False, dnn_activation="relu", gpus=None,
                 mesh=None, shard_embeddings=False):
        self._capture_init_args(locals())
        if len(conv_kernel_width) != len(conv_filters):
            raise ValueError(
                "conv_kernel_width must have same element with conv_filters")
        super().__init__(linear_feature_columns, dnn_feature_columns,
                         l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task,
                         device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        generator = self._init_generator
        device = generator.device
        filed_size = self.compute_input_dim(
            self.dnn_feature_columns, include_dense=False, feature_group=True)
        self.conv_layer = ConvLayer(filed_size, conv_kernel_width,
                                    conv_filters, device=device,
                                    generator=generator)
        in_dim = (self.conv_layer.shapes[-1] * conv_filters[-1]
                  * self.embedding_size)
        self.dnn = DNN(in_dim, dnn_hidden_units, activation=dnn_activation,
                       dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                       init_std=init_std, device=device, generator=generator)
        self.dnn_linear = _dense(dnn_hidden_units[-1], 1, use_bias=False,
                                 device=device, generator=generator)
        # deepctr_tpu/models/ccpm.py:75-76, by JAX path
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)
        self.add_regularization_rule(r"^dnn_linear/kernel$", l2=l2_reg_dnn)

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        linear_logit = self.linear_model(X, rows=rows)
        sparse_embedding_list, _ = self.embed_columns(
            X, self.dnn_feature_columns, support_dense=False, rows=rows)
        if len(sparse_embedding_list) == 0:
            raise ValueError("must have the embedding feature,now the "
                             "embedding feature is None!")
        conv_input = torch.cat(sparse_embedding_list, dim=1)[:, None]
        pooled = self.conv_layer(conv_input)
        dnn_output = self.dnn(pooled.reshape(X.shape[0], -1), training)
        logit = linear_logit + self.dnn_linear(dnn_output).to(
            linear_logit.dtype)
        return self.out(logit)
