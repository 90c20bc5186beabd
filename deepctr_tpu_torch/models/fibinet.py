"""FiBiNET (Huang et al., 2019): SENET reweighting + bilinear interactions.

Counterpart of ``deepctr_tpu/models/fibinet.py``.  The one ``Bilinear``
module is applied to both the raw and the SENET-reweighted embeddings, so
its weights are shared (``fibinet.py:43-44``).
"""

import torch

from .basemodel import BaseModel
from .xdeepfm import _field_num
from ..features import SparseFeat, DenseFeat, VarLenSparseFeat
from ..inputs import combined_dnn_input
from ..layers import DNN, SENETLayer, BilinearInteraction
from ..layers.core import _dense


class FiBiNET(BaseModel):
    """Instantiates the FiBiNET architecture, with the JAX package's
    constructor.  Runs on ``device`` (default ``"cuda"``; raises where CUDA
    is absent unless ``device="cpu"``).  ``mesh`` and
    ``shard_embeddings`` run it over ranks (``parallel/``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 bilinear_type="interaction", reduction_ratio=3,
                 dnn_hidden_units=(128, 128), l2_reg_linear=1e-5,
                 l2_reg_embedding=1e-5, l2_reg_dnn=0, init_std=1e-4,
                 seed=1024, dnn_dropout=0, dnn_activation="relu",
                 task="binary", device=None, gpus=None, mesh=None,
                 shard_embeddings=False):
        self._capture_init_args(locals())
        super().__init__(linear_feature_columns, dnn_feature_columns,
                         l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task,
                         device=device, gpus=gpus, mesh=mesh,
                         shard_embeddings=shard_embeddings)
        generator = self._init_generator
        device = generator.device
        field_size = _field_num(self.dnn_feature_columns)
        self.SE = SENETLayer(field_size, reduction_ratio, device=device,
                             generator=generator)
        self.Bilinear = BilinearInteraction(
            field_size, self.embedding_size, bilinear_type, device=device,
            generator=generator)
        self.dnn = DNN(self.compute_input_dim(self.dnn_feature_columns),
                       dnn_hidden_units, activation=dnn_activation,
                       dropout_rate=dnn_dropout, use_bn=False,
                       init_std=init_std, device=device, generator=generator)
        self.dnn_linear = _dense(dnn_hidden_units[-1], 1, use_bias=False,
                                 device=device, generator=generator)
        # deepctr_tpu/models/fibinet.py:87, by JAX path
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)

    def compute_input_dim(self, feature_columns, include_sparse=True,
                          include_dense=True, feature_group=False):
        """FiBiNET's DNN reads 2 * F(F-1)/2 bilinear pair vectors and the
        dense values (``deepctr_tpu/models/fibinet.py:89-108``)."""
        sparse_feature_columns = [
            f for f in feature_columns
            if isinstance(f, (SparseFeat, VarLenSparseFeat))]
        dense_feature_columns = [f for f in feature_columns
                                 if isinstance(f, DenseFeat)]
        field_size = len(sparse_feature_columns)
        dense_input_dim = sum(f.dimension for f in dense_feature_columns)
        embedding_size = (sparse_feature_columns[0].embedding_dim
                          if sparse_feature_columns else 0)
        sparse_input_dim = field_size * (field_size - 1) * embedding_size
        input_dim = 0
        if include_sparse:
            input_dim += sparse_input_dim
        if include_dense:
            input_dim += dense_input_dim
        return input_dim

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        sparse_embedding_list, dense_value_list = (
            self.embed_columns(X, self.dnn_feature_columns, rows=rows))
        sparse_embedding_input = torch.cat(sparse_embedding_list, dim=1)
        senet_output = self.SE(sparse_embedding_input, training)
        senet_bilinear_out = self.Bilinear(senet_output)
        bilinear_out = self.Bilinear(sparse_embedding_input)

        linear_logit = self.linear_model(X, rows=rows)
        pair_out = torch.cat([senet_bilinear_out, bilinear_out], dim=1)
        dnn_input = combined_dnn_input([pair_out], dense_value_list)
        dnn_output = self.dnn(dnn_input, training)
        dnn_logit = self.dnn_linear(dnn_output).to(linear_logit.dtype)
        if len(self.linear_feature_columns) == 0:
            return self.out(dnn_logit)
        if len(self.dnn_feature_columns) == 0:
            return self.out(linear_logit)
        return self.out(linear_logit + dnn_logit)
