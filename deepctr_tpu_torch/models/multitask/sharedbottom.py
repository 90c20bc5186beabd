"""Shared-Bottom multi-task learning (Caruana, 1997): a shared DNN and
one tower a task.

Counterpart of ``deepctr_tpu/models/multitask/sharedbottom.py``.
"""

from ..basemodel import BaseModel
from ...inputs import combined_dnn_input
from ...layers import DNN
from .utils import add_towers, task_outputs, validate_tasks


class SharedBottom(BaseModel):
    """Instantiates the Shared-Bottom architecture, with the JAX package's
    constructor: ``predict`` gives [N, n_tasks], one column a task, each
    task's loss from ``compile``'s list.  Runs on ``device`` (default
    ``"cuda"``; raises where CUDA is absent unless ``device="cpu"``).
    ``mesh`` and ``shard_embeddings`` run it over ranks (``parallel/``)."""

    def __init__(self, dnn_feature_columns, bottom_dnn_hidden_units=(256, 128),
                 tower_dnn_hidden_units=(64,), l2_reg_linear=1e-5,
                 l2_reg_embedding=1e-5, l2_reg_dnn=0, init_std=1e-4,
                 seed=1024, dnn_dropout=0, dnn_activation="relu",
                 dnn_use_bn=False, task_types=("binary", "binary"),
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
        generator = self._init_generator
        device = generator.device
        kw = dict(activation=dnn_activation, dropout_rate=dnn_dropout,
                  use_bn=dnn_use_bn, init_std=init_std, device=device,
                  generator=generator)
        self.bottom_dnn = DNN(self.compute_input_dim(self.dnn_feature_columns),
                              bottom_dnn_hidden_units, **kw)
        add_towers(self, bottom_dnn_hidden_units[-1], tower_dnn_hidden_units,
                   task_types, kw, device, generator)
        # deepctr_tpu/models/multitask/sharedbottom.py:99-103, by JAX path
        self.add_regularization_rule(
            r"^(bottom_dnn|tower_dnn_\d+)/.*kernel$", l2=l2_reg_dnn)
        self.add_regularization_rule(r"^tower_final_\d+/kernel$",
                                     l2=l2_reg_dnn)

    def forward(self, X, training=False):
        sparse_embedding_list, dense_value_list = self.embed_columns(
            X, self.dnn_feature_columns)
        shared = self.bottom_dnn(
            combined_dnn_input(sparse_embedding_list, dense_value_list),
            training)
        return task_outputs(self, [shared] * self.num_tasks, training)
