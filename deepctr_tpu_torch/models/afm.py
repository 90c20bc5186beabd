"""AFM (Xiao et al., 2017): attention-weighted pairwise interactions.

Counterpart of ``deepctr_tpu/models/afm.py``.
"""

import torch

from .basemodel import BaseModel
from ..layers import FM, AFMLayer


class AFM(BaseModel):
    """Instantiates the AFM architecture, with the JAX package's
    constructor; ``use_attention=False`` runs the plain FM.  Runs on
    ``device`` (default ``"cuda"``; raises where CUDA is absent unless
    ``device="cpu"``).  ``mesh``/``shard_embeddings`` are not ported yet
    and raise, as does ``afm_dropout > 0``."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 use_attention=True, attention_factor=8, l2_reg_linear=1e-5,
                 l2_reg_embedding=1e-5, l2_reg_att=1e-5, afm_dropout=0,
                 init_std=1e-4, seed=1024, task="binary", device=None,
                 gpus=None, mesh=None, shard_embeddings=False):
        if mesh is not None or shard_embeddings:
            raise NotImplementedError("sharded models are not ported yet")
        super().__init__(linear_feature_columns, dnn_feature_columns,
                         l2_reg_linear=l2_reg_linear,
                         l2_reg_embedding=l2_reg_embedding,
                         init_std=init_std, seed=seed, task=task,
                         device=device, gpus=gpus)
        generator = self._init_generator
        self.use_attention = use_attention
        if use_attention:
            self.fm = AFMLayer(
                self.embedding_size, attention_factor,
                dropout_rate=afm_dropout,
                field_size=self.compute_input_dim(
                    self.dnn_feature_columns, include_dense=False,
                    feature_group=True),
                device=generator.device, generator=generator)
        else:
            self.fm = FM()
        # deepctr_tpu/models/afm.py:60, by JAX path
        self.add_regularization_rule(r"^fm/attention_W$", l2=l2_reg_att)

    def forward(self, X, training=False):
        rows = self.shared_rows(X)
        sparse_embedding_list, _ = self.embed_columns(
            X, self.dnn_feature_columns, support_dense=False, rows=rows)
        logit = self.linear_model(X, rows=rows)
        if len(sparse_embedding_list) > 0:
            fm_input = torch.cat(sparse_embedding_list, dim=1)
            logit = logit + self.fm(fm_input).to(logit.dtype)
        return self.out(logit)
