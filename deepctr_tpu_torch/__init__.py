"""DeepCTR-TPU's PyTorch/CUDA port, for one NVIDIA Hopper GPU.

Mirrors the layout and names of ``deepctr_tpu`` module for module.  It
imports torch and numpy only, never jax and nothing of ``deepctr_tpu``.
Models run on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""

from . import config
from .config import (set_compute_dtype, compute_dtype, set_cin_dtype,
                     cin_dtype, set_adam_t)
from .features import (SparseFeat, DenseFeat, VarLenSparseFeat,
                       build_input_features, get_feature_names,
                       DEFAULT_GROUP_NAME)
from .callbacks import History, EarlyStopping, ModelCheckpoint
from .utils.serialization import load_model, save_model
from . import layers
from . import models
from . import serving
from .data import criteo_stream, criteo_columns

__version__ = "0.1.0"

from .utils.version import check_version  # noqa: E402

# does nothing unless the environment names the latest version
check_version(__version__)
