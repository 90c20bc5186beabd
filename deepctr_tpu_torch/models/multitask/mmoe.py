"""MMOE (Ma et al., 2018): multi-gate mixture-of-experts.

Counterpart of ``deepctr_tpu/models/multitask/mmoe.py``: the expert towers
are one :class:`StackedDNN` (parameters with a leading expert axis, one
batched product a layer), as the JAX package vmaps them.
"""

from ..basemodel import BaseModel
from ...inputs import combined_dnn_input
from ...layers import DNN
from ...layers.core import _dense
from .utils import (StackedDNN, add_towers, gate_mix, task_outputs,
                    validate_tasks)


class MMOE(BaseModel):
    """Instantiates the MMOE architecture, with the JAX package's
    constructor: ``expert_dnn`` (``num_experts`` stacked towers), each
    task's gate ``gate_dnn_<i>`` (where there are gate units) and
    ``gate_final_<i>``, tower, head and prediction layer; ``predict`` gives
    [N, n_tasks].  Runs on ``device`` (default ``"cuda"``; raises where
    CUDA is absent unless ``device="cpu"``).  Dropout draws one mask over
    every expert's values, from the model's generator: not JAX's bits.
    ``mesh`` and ``shard_embeddings`` run it over ranks (``parallel/``)."""

    def __init__(self, dnn_feature_columns, num_experts=3,
                 expert_dnn_hidden_units=(256, 128),
                 gate_dnn_hidden_units=(64,), tower_dnn_hidden_units=(64,),
                 l2_reg_linear=1e-5, l2_reg_embedding=1e-5, l2_reg_dnn=0,
                 init_std=1e-4, seed=1024, dnn_dropout=0,
                 dnn_activation="relu", dnn_use_bn=False,
                 task_types=("binary", "binary"),
                 task_names=("ctr", "ctcvr"), device=None, gpus=None,
                 mesh=None, shard_embeddings=False):
        self._capture_init_args(locals())
        num_tasks = validate_tasks(task_types, task_names,
                                   dnn_feature_columns)
        if num_experts <= 1:
            raise ValueError("num_experts must be greater than 1")
        super().__init__([], dnn_feature_columns,
                         l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task_types[0],
                         device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        self.out = None
        self.num_tasks = num_tasks
        self.task_names = list(task_names)
        generator = self._init_generator
        device = generator.device
        kw = dict(activation=dnn_activation, dropout_rate=dnn_dropout,
                  use_bn=dnn_use_bn, init_std=init_std, device=device,
                  generator=generator)
        in_dim = self.compute_input_dim(self.dnn_feature_columns)
        self.expert_dnn = StackedDNN(num_experts, in_dim,
                                     expert_dnn_hidden_units, **kw)
        self.gate_dnn_hidden_units = tuple(gate_dnn_hidden_units)
        gate_dim = in_dim
        for i in range(num_tasks):
            if self.gate_dnn_hidden_units:
                self.add_module("gate_dnn_%d" % i, DNN(
                    in_dim, gate_dnn_hidden_units, **kw))
                gate_dim = gate_dnn_hidden_units[-1]
            self.add_module("gate_final_%d" % i, _dense(
                gate_dim, num_experts, use_bias=False, device=device,
                generator=generator))
        add_towers(self, expert_dnn_hidden_units[-1], tower_dnn_hidden_units,
                   task_types, kw, device, generator)
        # deepctr_tpu/models/multitask/mmoe.py:138-142, by JAX path
        self.add_regularization_rule(
            r"^(expert_dnn|gate_dnn_\d+|tower_dnn_\d+)/.*kernel$",
            l2=l2_reg_dnn)
        self.add_regularization_rule(
            r"^(gate_final_\d+|tower_final_\d+)/kernel$", l2=l2_reg_dnn)

    def forward(self, X, training=False):
        sparse_embedding_list, dense_value_list = self.embed_columns(
            X, self.dnn_feature_columns)
        dnn_input = combined_dnn_input(sparse_embedding_list,
                                       dense_value_list)
        experts = self.expert_dnn(dnn_input, training)       # [B, K, dim]
        mixed = []
        for i in range(self.num_tasks):
            gate_in = (getattr(self, "gate_dnn_%d" % i)(dnn_input, training)
                       if self.gate_dnn_hidden_units else dnn_input)
            mixed.append(gate_mix(getattr(self, "gate_final_%d" % i)(gate_in),
                                  experts))
        return task_outputs(self, mixed, training)
