"""MLR / LS-PLM (Gai et al., 2017): mixture of logistic regressions, a
softmax region gate over ``region_num`` linear models times per-region
learner scores, with an optional bias gate.

Counterpart of ``deepctr_tpu/models/mlr.py``, whose learner scores come
from the *base* linear models, as the LS-PLM paper specifies (the upstream
reference reuses the region models there).
"""

import torch

from .base_module import LinearModel
from .basemodel import BaseModel
from ..features import build_input_features
from ..layers.core import PredictionLayer


class MLR(BaseModel):
    """Instantiates the MLR architecture, with the JAX package's
    constructor.  Runs on ``device`` (default ``"cuda"``; raises where CUDA
    is absent unless ``device="cpu"``).

    As the JAX model, it holds only its linear models ``region_linear_<i>``,
    ``base_linear_<i>`` and ``bias_linear`` (each with its own width-1
    tables: one gather a forward each) and heads without a bias; the
    shared ``embedding_dict``, ``linear_model`` and ``out`` of other models
    hold nothing here.  The engine's default L2 rules name
    ``embedding_dict/`` and ``linear_model/``, which none of these paths
    match, so ``l2_reg_linear`` takes no effect, as in the JAX package
    (ROADMAP.md section 3).  ``mesh`` and ``shard_embeddings`` run it over
    ranks (``parallel/``)."""

    def __init__(self, region_feature_columns, base_feature_columns=None,
                 bias_feature_columns=None, region_num=4, l2_reg_linear=1e-5,
                 init_std=1e-4, seed=1024, task="binary", device=None,
                 gpus=None, mesh=None, shard_embeddings=False):
        self._capture_init_args(locals())
        if region_num <= 1:
            raise ValueError("region_num must > 1")
        region_feature_columns = list(region_feature_columns)
        if base_feature_columns is None or len(base_feature_columns) == 0:
            base_feature_columns = region_feature_columns
        else:
            base_feature_columns = list(base_feature_columns)
        bias_feature_columns = list(bias_feature_columns or [])
        all_columns = (region_feature_columns + base_feature_columns
                       + bias_feature_columns)
        super().__init__([], [], l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=0, init_std=init_std, seed=seed,
                         task=task, device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        # the engine's feature_index covers region, base and bias spans,
        # as the JAX model's (all columns as its linear columns)
        self.linear_feature_columns = all_columns
        self.feature_index = build_input_features(all_columns)
        self.input_dim = max(e for _, e in self.feature_index.values())
        self.out = None
        self.region_feature_columns = region_feature_columns
        self.base_feature_columns = base_feature_columns
        self.bias_feature_columns = bias_feature_columns
        generator = self._init_generator
        device = generator.device

        def linear(cols, name):
            self.add_module(name, LinearModel(
                cols, self.feature_index, init_std, device=device,
                generator=generator))
            return getattr(self, name)
        self.region_linear_model = [
            linear(region_feature_columns, "region_linear_%d" % i)
            for i in range(region_num)]
        self.base_linear_model = [
            linear(base_feature_columns, "base_linear_%d" % i)
            for i in range(region_num)]
        if bias_feature_columns:
            linear(bias_feature_columns, "bias_linear")
            self.bias_prediction = PredictionLayer("binary", use_bias=False)
        self.prediction_layer = PredictionLayer(task, use_bias=False)

    def forward(self, X, training=False):
        region_logit = torch.cat([m(X) for m in self.region_linear_model],
                                 dim=-1)
        region_score = torch.softmax(region_logit, dim=-1)
        learner_logit = torch.cat([m(X) for m in self.base_linear_model],
                                  dim=-1)
        learner_score = self.prediction_layer(learner_logit)
        final = torch.sum(region_score * learner_score, dim=-1, keepdim=True)
        if self.bias_feature_columns:
            final = final * self.bias_prediction(self.bias_linear(X))
        return final
