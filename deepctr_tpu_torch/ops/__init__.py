"""Hot ops: each has a plain PyTorch version and, where the JAX package has a
TPU kernel, a hand-written CUDA kernel that runs on CUDA tensors.  Launch
counts are ``ops._build.LAUNCHES``, by kernel name
(``LAUNCHES["gather_rows"]``).  The training kernels live in
``ops.scatter_add``, ``ops.row_update`` and ``ops.dense_update``
(the dense parameters' optimizer step, a kernel of the port's own with no
TPU counterpart), the sequence kernels in ``ops.gru`` and ``ops.attention``,
xDeepFM's CIN kernel in ``ops.cin``, and the row scatter of the scatter
micro-benchmark in ``ops.scatter_rows``.  The inference kernels (gather,
attention, GRU forward, CIN) run as the custom operators of ``ops.library``."""

from .reference import (fm_cross_ref, cin_layer_ref, cin_mix_ref,
                        cross_net_ref, din_attention_ref)
from .dispatch import fm_cross, cin_layer, cin_mix, cross_net, din_attention
from .gather import gather_rows, gather_rows_ref
# registers the kernels' custom operators (deepctr_tpu_torch::...), which
# the wrappers call
from . import library
