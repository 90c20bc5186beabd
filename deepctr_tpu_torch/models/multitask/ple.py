"""PLE (Tang et al., 2020): progressive layered extraction, CGC levels of
task-specific and shared experts with progressive routing.

Counterpart of ``deepctr_tpu/models/multitask/ple.py``: each group of
experts is one :class:`StackedDNN`, as the JAX package vmaps them.
"""

import torch

from ..basemodel import BaseModel
from ...inputs import combined_dnn_input
from ...layers import DNN
from ...layers.core import _dense
from .utils import (StackedDNN, add_towers, gate_mix, task_outputs,
                    validate_tasks)


class PLE(BaseModel):
    """Instantiates the PLE architecture, with the JAX package's
    constructor.  Level ``l`` holds each task's specific experts
    ``specific_expert_l<l>_t<t>``, the shared experts ``shared_expert_l<l>``
    and their gates (``specific_gate_dnn_l<l>_t<t>``/``shared_gate_dnn_l<l>``
    where there are gate units, ``specific_gate_final_l<l>_t<t>``,
    ``shared_gate_final_l<l>``); a task's gate mixes its own and the shared
    experts, the shared gate all of them (``deepctr_tpu/models/multitask/
    ple.py:86-115``).  ``predict`` gives [N, n_tasks].  Runs on ``device``
    (default ``"cuda"``; raises where CUDA is absent unless
    ``device="cpu"``).
    ``mesh`` and ``shard_embeddings`` run it over ranks (``parallel/``)."""

    def __init__(self, dnn_feature_columns, shared_expert_num=1,
                 specific_expert_num=1, num_levels=2,
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
        super().__init__([], dnn_feature_columns,
                         l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task_types[0],
                         device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        self.out = None
        self.num_tasks = num_tasks
        self.task_names = list(task_names)
        self.num_levels = num_levels
        self.gate_dnn_hidden_units = tuple(gate_dnn_hidden_units)
        generator = self._init_generator
        device = generator.device
        kw = dict(activation=dnn_activation, dropout_rate=dnn_dropout,
                  use_bn=dnn_use_bn, init_std=init_std, device=device,
                  generator=generator)
        T = num_tasks
        in_dim = self.compute_input_dim(self.dnn_feature_columns)
        gate_dims = {"specific": specific_expert_num + shared_expert_num,
                     "shared": T * specific_expert_num + shared_expert_num}
        for level in range(num_levels):
            for t in range(T):
                self.add_module("specific_expert_l%d_t%d" % (level, t),
                                StackedDNN(specific_expert_num, in_dim,
                                           expert_dnn_hidden_units, **kw))
            self.add_module("shared_expert_l%d" % level, StackedDNN(
                shared_expert_num, in_dim, expert_dnn_hidden_units, **kw))
            for kind, suffix in ([("specific", "_l%d_t%d" % (level, t))
                                  for t in range(T)]
                                 + [("shared", "_l%d" % level)]):
                gate_dim = in_dim
                if self.gate_dnn_hidden_units:
                    self.add_module("%s_gate_dnn%s" % (kind, suffix), DNN(
                        in_dim, gate_dnn_hidden_units, **kw))
                    gate_dim = gate_dnn_hidden_units[-1]
                self.add_module("%s_gate_final%s" % (kind, suffix), _dense(
                    gate_dim, gate_dims[kind], use_bias=False, device=device,
                    generator=generator))
            in_dim = expert_dnn_hidden_units[-1]
        add_towers(self, in_dim, tower_dnn_hidden_units, task_types, kw,
                   device, generator)
        # deepctr_tpu/models/multitask/ple.py:216-218, by JAX path
        self.add_regularization_rule(
            r"^(specific_expert|shared_expert|specific_gate|shared_gate|"
            r"tower_dnn_\d+|tower_final_\d+).*kernel$", l2=l2_reg_dnn)

    def _gate(self, name, gate_in, experts, training):
        if self.gate_dnn_hidden_units:
            gate_in = getattr(self, name.replace("_gate_", "_gate_dnn_"))(
                gate_in, training)
        return gate_mix(getattr(self, name.replace("_gate_", "_gate_final_"))(
            gate_in), experts)

    def _cgc_net(self, inputs, level, training):
        """One CGC level; ``inputs`` = [task 1 .. task T, shared]."""
        T = self.num_tasks
        specific = [getattr(self, "specific_expert_l%d_t%d" % (level, t))(
            inputs[t], training) for t in range(T)]              # [B,Ks,dim]
        shared = getattr(self, "shared_expert_l%d" % level)(inputs[-1],
                                                             training)
        outs = [self._gate("specific_gate_l%d_t%d" % (level, t), inputs[t],
                           torch.cat([specific[t], shared], dim=1), training)
                for t in range(T)]
        outs.append(self._gate("shared_gate_l%d" % level, inputs[-1],
                               torch.cat(specific + [shared], dim=1),
                               training))
        return outs

    def forward(self, X, training=False):
        sparse_embedding_list, dense_value_list = self.embed_columns(
            X, self.dnn_feature_columns)
        dnn_input = combined_dnn_input(sparse_embedding_list,
                                       dense_value_list)
        ple_inputs = [dnn_input] * (self.num_tasks + 1)
        for level in range(self.num_levels):
            ple_inputs = self._cgc_net(ple_inputs, level, training)
        return task_outputs(self, ple_inputs[:self.num_tasks], training)
