"""DCN-Mix (Wang et al., 2020): mixture of low-rank cross experts + DNN.

Counterpart of ``deepctr_tpu/models/dcnmix.py``.
"""

from .basemodel import BaseModel
from .dcn import DCN
from ..layers import CrossNetMix


class DCNMix(DCN):
    """Instantiates the DCN-Mix architecture, with the JAX package's
    constructor: DCN's model with ``CrossNetMix`` as its cross network.
    Runs on ``device`` (default ``"cuda"``; raises where CUDA is absent
    unless ``device="cpu"``).  ``mesh`` and ``shard_embeddings`` run it over
    ranks (``parallel/``)."""

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 cross_num=2, dnn_hidden_units=(128, 128), l2_reg_linear=1e-5,
                 l2_reg_embedding=1e-5, l2_reg_cross=1e-5, l2_reg_dnn=0,
                 init_std=1e-4, seed=1024, dnn_dropout=0, low_rank=32,
                 num_experts=4, dnn_activation="relu", dnn_use_bn=False,
                 task="binary", device=None, gpus=None, mesh=None,
                 shard_embeddings=False):
        self._capture_init_args(locals())
        BaseModel.__init__(self, linear_feature_columns, dnn_feature_columns,
                           l2_reg_linear=l2_reg_linear,
                           l2_reg_embedding=l2_reg_embedding,
                           init_std=init_std, seed=seed, task=task,
                           device=device, gpus=gpus, mesh=mesh,
                           shard_embeddings=shard_embeddings)
        self._build_towers(
            cross_num, lambda n, **kw: CrossNetMix(
                n, low_rank, num_experts, cross_num, **kw),
            dnn_hidden_units, dnn_activation, dnn_dropout, dnn_use_bn,
            init_std)
        # deepctr_tpu/models/dcnmix.py:82-84, by JAX path
        self.add_regularization_rule(r"^dnn/.*kernel$", l2=l2_reg_dnn)
        self.add_regularization_rule(r"^dnn_linear/kernel$", l2=l2_reg_linear)
        self.add_regularization_rule(r"^crossnet/(U_list|V_list|C_list)$",
                                     l2=l2_reg_cross)
