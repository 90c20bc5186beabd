"""ESMM (Ma et al., 2018): entire-space CTR/CTCVR factorization; predicts
``[ctr, ctr * cvr]``.

Counterpart of ``deepctr_tpu/models/multitask/esmm.py``.
"""

import torch

from ..basemodel import BaseModel
from ...inputs import combined_dnn_input
from ...layers import DNN
from ...layers.core import _dense
from .utils import validate_tasks


class ESMM(BaseModel):
    """Instantiates the ESMM architecture, with the JAX package's
    constructor (exactly two binary tasks): a CTR and a CVR tower, each
    with its head (``ctr_final``, ``cvr_final``), both through the one
    prediction layer ``out``; ``predict`` gives [N, 2], the CTR and the
    CTCVR.  Runs on ``device`` (default ``"cuda"``; raises where CUDA is
    absent unless ``device="cpu"``).  ``mesh`` and ``shard_embeddings`` run
    it over ranks (``parallel/``)."""

    def __init__(self, dnn_feature_columns, tower_dnn_hidden_units=(256, 128),
                 l2_reg_linear=1e-5, l2_reg_embedding=1e-5, l2_reg_dnn=0,
                 init_std=1e-4, seed=1024, dnn_dropout=0,
                 dnn_activation="relu", dnn_use_bn=False,
                 task_types=("binary", "binary"),
                 task_names=("ctr", "ctcvr"), device=None, gpus=None,
                 mesh=None, shard_embeddings=False):
        self._capture_init_args(locals())
        num_tasks = validate_tasks(task_types, task_names,
                                   dnn_feature_columns, exactly_two=True,
                                   binary_only=True)
        super().__init__([], dnn_feature_columns,
                         l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task="binary",
                         device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        self.num_tasks = num_tasks
        self.task_names = list(task_names)
        generator = self._init_generator
        device = generator.device
        in_dim = self.compute_input_dim(self.dnn_feature_columns)
        for name in ("ctr", "cvr"):
            self.add_module(name + "_dnn", DNN(
                in_dim, tower_dnn_hidden_units, activation=dnn_activation,
                dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                init_std=init_std, device=device, generator=generator))
            self.add_module(name + "_final", _dense(
                tower_dnn_hidden_units[-1], 1, use_bias=False, device=device,
                generator=generator))
        # deepctr_tpu/models/multitask/esmm.py:89-93, by JAX path
        self.add_regularization_rule(r"^(ctr_dnn|cvr_dnn)/.*kernel$",
                                     l2=l2_reg_dnn)
        self.add_regularization_rule(r"^(ctr_final|cvr_final)/kernel$",
                                     l2=l2_reg_dnn)

    def forward(self, X, training=False):
        sparse_embedding_list, dense_value_list = self.embed_columns(
            X, self.dnn_feature_columns)
        dnn_input = combined_dnn_input(sparse_embedding_list,
                                       dense_value_list)
        ctr_logit = self.ctr_final(self.ctr_dnn(dnn_input, training)).float()
        cvr_logit = self.cvr_final(self.cvr_dnn(dnn_input, training)).float()
        ctr_pred = self.out(ctr_logit)
        cvr_pred = self.out(cvr_logit)
        return torch.cat([ctr_pred, ctr_pred * cvr_pred], dim=-1)
