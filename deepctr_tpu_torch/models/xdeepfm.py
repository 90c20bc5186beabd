"""xDeepFM (Lian et al., 2018): linear + CIN + DNN over shared embeddings.

Counterpart of ``deepctr_tpu/models/xdeepfm.py``.
"""

import torch

from .basemodel import BaseModel
from ..features import SparseFeat, VarLenSparseFeat
from ..inputs import combined_dnn_input
from ..layers import CIN, DNN
from ..layers.core import _dense


def _field_num(feature_columns):
    """Distinct embedding tables (``embedding_name`` dedup), the CIN's
    field count as the JAX package counts it (``xdeepfm.py:16-20``)."""
    return len({f.embedding_name for f in feature_columns
                if isinstance(f, (SparseFeat, VarLenSparseFeat))})


class xDeepFM(BaseModel):
    """Instantiates the xDeepFM architecture, with the JAX package's
    constructor.  Runs on ``device`` (default ``"cuda"``; raises where CUDA
    is absent unless ``device="cpu"``).  On CUDA every CIN layer runs the
    kernel of ``ops/cin.py``, in training too, in the mode of
    ``config.set_cin_dtype`` at bfloat16 compute.  ``mesh`` and
    ``shard_embeddings`` run it over ranks (``parallel/``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 dnn_hidden_units=(256, 256), cin_layer_size=(256, 128),
                 cin_split_half=True, cin_activation="relu",
                 l2_reg_linear=1e-5, l2_reg_embedding=1e-5, l2_reg_dnn=0,
                 l2_reg_cin=0, init_std=1e-4, seed=1024, dnn_dropout=0,
                 dnn_activation="relu", dnn_use_bn=False, task="binary",
                 device=None, gpus=None, mesh=None, shard_embeddings=False):
        self._capture_init_args(locals())
        super().__init__(linear_feature_columns, dnn_feature_columns,
                         l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task,
                         device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        generator = self._init_generator
        device = generator.device
        self.use_dnn = (len(self.dnn_feature_columns) > 0 and
                        len(dnn_hidden_units) > 0)
        if self.use_dnn:
            self.dnn = DNN(self.compute_input_dim(self.dnn_feature_columns),
                           dnn_hidden_units, activation=dnn_activation,
                           l2_reg=l2_reg_dnn, dropout_rate=dnn_dropout,
                           use_bn=dnn_use_bn, init_std=init_std,
                           device=device, generator=generator)
            self.dnn_linear = _dense(dnn_hidden_units[-1], 1, use_bias=False,
                                     device=device, generator=generator)
        self.use_cin = (len(cin_layer_size) > 0 and
                        len(self.dnn_feature_columns) > 0)
        if self.use_cin:
            self.cin = CIN(_field_num(self.dnn_feature_columns),
                           cin_layer_size, activation=cin_activation,
                           split_half=cin_split_half, device=device,
                           generator=generator)
            self.cin_linear = _dense(self.cin.featuremap_num, 1,
                                     use_bias=False, device=device,
                                     generator=generator)
        # deepctr_tpu/models/xdeepfm.py:94-96, by JAX path
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)
        self.add_regularization_rule(r"^dnn_linear/kernel$", l2=l2_reg_dnn)
        self.add_regularization_rule(r"^cin/conv_w", l2=l2_reg_cin)

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        sparse_embedding_list, dense_value_list = (
            self.embed_columns(X, self.dnn_feature_columns, rows=rows))
        logit = self.linear_model(X, rows=rows)
        if self.use_cin:
            cin_output = self.cin(torch.cat(sparse_embedding_list, dim=1),
                                  training)
            logit = logit + self.cin_linear(cin_output).to(logit.dtype)
        if self.use_dnn:
            dnn_input = combined_dnn_input(sparse_embedding_list,
                                           dense_value_list)
            dnn_output = self.dnn(dnn_input, training)
            logit = logit + self.dnn_linear(dnn_output).to(logit.dtype)
        return self.out(logit)
