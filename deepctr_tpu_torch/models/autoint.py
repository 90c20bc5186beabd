"""AutoInt (Song et al., 2019): stacked field self-attention + DNN.

Counterpart of ``deepctr_tpu/models/autoint.py``; as there (and in the
reference, ``autoint.py:45``) the linear part's L2 is 0.
"""

import torch

from .basemodel import BaseModel
from ..inputs import combined_dnn_input
from ..layers import DNN, InteractingLayer
from ..layers.core import _dense


class AutoInt(BaseModel):
    """Instantiates the AutoInt architecture, with the JAX package's
    constructor.  Runs on ``device`` (default ``"cuda"``; raises where CUDA
    is absent unless ``device="cpu"``).  ``mesh`` and
    ``shard_embeddings`` run it over ranks (``parallel/``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 att_layer_num=3, att_head_num=2, att_res=True,
                 dnn_hidden_units=(256, 128), dnn_activation="relu",
                 l2_reg_dnn=0, l2_reg_embedding=1e-5, dnn_use_bn=False,
                 dnn_dropout=0, init_std=1e-4, seed=1024, task="binary",
                 device=None, gpus=None, mesh=None, shard_embeddings=False):
        self._capture_init_args(locals())
        if len(dnn_hidden_units) <= 0 and att_layer_num <= 0:
            raise ValueError("Either hidden_layer or att_layer_num must > 0")
        super().__init__(linear_feature_columns, dnn_feature_columns,
                         l2_reg_linear=0,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task,
                         device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        generator = self._init_generator
        device = generator.device
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.att_layer_num = att_layer_num
        self.use_dnn = (len(self.dnn_feature_columns) > 0 and
                        len(dnn_hidden_units) > 0)
        embedding_size = self.embedding_size
        head_dim = 0
        if self.use_dnn:
            self.dnn = DNN(self.compute_input_dim(self.dnn_feature_columns),
                           dnn_hidden_units, activation=dnn_activation,
                           dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                           init_std=init_std, device=device,
                           generator=generator)
            head_dim += self.dnn_hidden_units[-1]
        if att_layer_num > 0:
            # the attention output: every sparse and varlen column a field
            n_fields = self.compute_input_dim(
                self.dnn_feature_columns, include_dense=False,
                feature_group=True)
            head_dim += n_fields * embedding_size
        self.int_layers = []
        for i in range(att_layer_num):
            layer = InteractingLayer(embedding_size, att_head_num, att_res,
                                     device=device, generator=generator)
            self.add_module("int_layer_%d" % i, layer)
            self.int_layers.append(layer)
        self.dnn_linear = _dense(head_dim, 1, use_bias=False, device=device,
                                 generator=generator)
        # deepctr_tpu/models/autoint.py:89, by JAX path
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        sparse_embedding_list, dense_value_list = (
            self.embed_columns(X, self.dnn_feature_columns, rows=rows))
        logit = self.linear_model(X, rows=rows)
        parts = []
        if self.att_layer_num > 0:
            att_input = torch.cat(sparse_embedding_list, dim=1)
            for layer in self.int_layers:
                att_input = layer(att_input)
            parts.append(att_input.reshape(att_input.shape[0], -1))
        if self.dnn_hidden_units:
            dnn_input = combined_dnn_input(sparse_embedding_list,
                                           dense_value_list)
            deep_out = self.dnn(dnn_input, training)
            parts.append(deep_out.to(parts[0].dtype) if parts else deep_out)
        stack_out = torch.cat(parts, dim=-1)
        logit = logit + self.dnn_linear(stack_out).to(logit.dtype)
        return self.out(logit)
