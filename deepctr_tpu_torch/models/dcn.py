"""DCN / DCN-V2 (Wang et al., 2017/2020): cross network + DNN, stacked head.

Counterpart of ``deepctr_tpu/models/dcn.py``.
"""

import torch

from .basemodel import BaseModel
from ..inputs import combined_dnn_input
from ..layers import DNN, CrossNet
from ..layers.core import _dense


class DCN(BaseModel):
    """Instantiates the DCN (``cross_parameterization="vector"``) or DCN-M
    (``"matrix"``) architecture, with the JAX package's constructor.  Runs
    on ``device`` (default ``"cuda"``; raises where CUDA is absent unless
    ``device="cpu"``).  ``mesh``/``shard_embeddings`` are not ported yet
    and raise, as does ``dnn_dropout > 0``."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 cross_num=2, cross_parameterization="vector",
                 dnn_hidden_units=(128, 128), l2_reg_linear=1e-5,
                 l2_reg_embedding=1e-5, l2_reg_cross=1e-5, l2_reg_dnn=0,
                 init_std=1e-4, seed=1024, dnn_dropout=0,
                 dnn_activation="relu", dnn_use_bn=False, task="binary",
                 device=None, gpus=None, mesh=None, shard_embeddings=False):
        if mesh is not None or shard_embeddings:
            raise NotImplementedError("sharded models are not ported yet")
        super().__init__(linear_feature_columns, dnn_feature_columns,
                         l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task,
                         device=device, gpus=gpus)
        self._build_towers(
            cross_num, lambda n, **kw: CrossNet(
                n, cross_num, cross_parameterization, **kw),
            dnn_hidden_units, dnn_activation, dnn_dropout, dnn_use_bn,
            init_std)
        # deepctr_tpu/models/dcn.py:81-83, by JAX path
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)
        self.add_regularization_rule(r"^dnn_linear/kernel$", l2=l2_reg_linear)
        self.add_regularization_rule(r"^crossnet/kernels$", l2=l2_reg_cross)

    def _build_towers(self, cross_num, cross_layer, dnn_hidden_units,
                      dnn_activation, dnn_dropout, dnn_use_bn, init_std):
        """The DNN, the cross network ``cross_layer(in_dim, device=,
        generator=)`` (when ``cross_num > 0``) and the head over their
        outputs side by side."""
        generator = self._init_generator
        device = generator.device
        self.dnn_hidden_units = tuple(dnn_hidden_units)
        self.cross_num = cross_num
        in_dim = self.compute_input_dim(self.dnn_feature_columns)
        head_dim = 0
        if cross_num > 0:
            self.crossnet = cross_layer(in_dim, device=device,
                                        generator=generator)
            head_dim += in_dim
        if self.dnn_hidden_units:
            self.dnn = DNN(in_dim, dnn_hidden_units, activation=dnn_activation,
                           dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                           init_std=init_std, device=device,
                           generator=generator)
            head_dim += self.dnn_hidden_units[-1]
        if head_dim:
            self.dnn_linear = _dense(head_dim, 1, use_bias=False,
                                     device=device, generator=generator)

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        logit = self.linear_model(X, rows=rows)
        sparse_embedding_list, dense_value_list = (
            self.embed_columns(X, self.dnn_feature_columns, rows=rows))
        dnn_input = combined_dnn_input(sparse_embedding_list,
                                       dense_value_list)
        parts = []
        if self.cross_num > 0:
            parts.append(self.crossnet(dnn_input))
        if self.dnn_hidden_units:
            deep_out = self.dnn(dnn_input, training)
            parts.append(deep_out.to(parts[0].dtype) if parts else deep_out)
        if parts:
            stack_out = torch.cat(parts, dim=-1)
            logit = logit + self.dnn_linear(stack_out).to(logit.dtype)
        return self.out(logit)
