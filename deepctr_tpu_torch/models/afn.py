"""AFN (Cheng et al., 2020): adaptive factorization network, a logarithmic
transformation layer learning arbitrary-order crosses (non-ensembled AFN).

Counterpart of ``deepctr_tpu/models/afn.py``.
"""

import torch

from .basemodel import BaseModel
from .xdeepfm import _field_num
from ..layers import DNN, LogTransformLayer
from ..layers.core import _dense


class AFN(BaseModel):
    """Instantiates the AFN architecture, with the JAX package's
    constructor: ``LogTransformLayer`` over the fields' embeddings, then a
    batch-normed DNN (``use_bn=True``) and a dense head with a bias.  Runs
    on ``device`` (default ``"cuda"``; raises where CUDA is absent unless
    ``device="cpu"``).
    ``mesh`` and ``shard_embeddings`` run it over ranks (``parallel/``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 ltl_hidden_size=256, afn_dnn_hidden_units=(256, 128),
                 l2_reg_linear=1e-5, l2_reg_embedding=1e-5, l2_reg_dnn=0,
                 init_std=1e-4, seed=1024, dnn_dropout=0,
                 dnn_activation="relu", task="binary", device=None, gpus=None,
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
        embedding_size = self.embedding_size
        self.ltl = LogTransformLayer(_field_num(self.dnn_feature_columns),
                                     embedding_size, ltl_hidden_size,
                                     device=device, generator=generator)
        self.afn_dnn = DNN(embedding_size * ltl_hidden_size,
                           afn_dnn_hidden_units, activation=dnn_activation,
                           dropout_rate=dnn_dropout, use_bn=True,
                           init_std=init_std, device=device,
                           generator=generator)
        self.afn_dnn_linear = _dense(afn_dnn_hidden_units[-1], 1,
                                     device=device, generator=generator)
        # deepctr_tpu/models/afn.py:80, by JAX path
        self.add_regularization_rule(r"^afn_dnn/.*kernel$", l2=l2_reg_dnn)

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        sparse_embedding_list, _ = self.embed_columns(
            X, self.dnn_feature_columns, rows=rows)
        logit = self.linear_model(X, rows=rows)
        if len(sparse_embedding_list) == 0:
            raise ValueError("Sparse embeddings not provided. AFN only "
                             "accepts sparse embeddings as input.")
        ltl_result = self.ltl(torch.cat(sparse_embedding_list, dim=1),
                              training)
        afn_logit = self.afn_dnn_linear(self.afn_dnn(ltl_result, training))
        return self.out(logit + afn_logit.to(logit.dtype))
