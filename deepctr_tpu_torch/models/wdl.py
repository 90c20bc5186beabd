"""Wide & Deep (Cheng et al., 2016): linear wide part + DNN deep part.

Counterpart of ``deepctr_tpu/models/wdl.py``.
"""

from .basemodel import BaseModel
from ..inputs import combined_dnn_input
from ..layers import DNN
from ..layers.core import _dense


class WDL(BaseModel):
    """Instantiates the Wide & Deep architecture, with the JAX package's
    constructor.  Runs on ``device`` (default ``"cuda"``; raises where CUDA
    is absent unless ``device="cpu"``).  ``mesh`` and
    ``shard_embeddings`` run it over ranks (``parallel/``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 dnn_hidden_units=(256, 128), l2_reg_linear=1e-5,
                 l2_reg_embedding=1e-5, l2_reg_dnn=0, init_std=1e-4,
                 seed=1024, dnn_dropout=0, dnn_activation="relu",
                 dnn_use_bn=False, task="binary", device=None, gpus=None,
                 mesh=None, shard_embeddings=False):
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
                           dropout_rate=dnn_dropout, use_bn=dnn_use_bn,
                           init_std=init_std, device=device,
                           generator=generator)
            self.dnn_linear = _dense(dnn_hidden_units[-1], 1, use_bias=False,
                                     device=device, generator=generator)
        # deepctr_tpu/models/wdl.py:62-63, by JAX path
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)
        self.add_regularization_rule(r"^dnn_linear/kernel$", l2=l2_reg_dnn)

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        logit = self.linear_model(X, rows=rows)
        if self.use_dnn:
            sparse_embedding_list, dense_value_list = self.embed_columns(
                X, self.dnn_feature_columns, rows=rows)
            dnn_input = combined_dnn_input(sparse_embedding_list,
                                           dense_value_list)
            dnn_output = self.dnn(dnn_input, training)
            logit = logit + self.dnn_linear(dnn_output).to(logit.dtype)
        return self.out(logit)
