"""Hot ops: each has a plain PyTorch version and, where the JAX package has
a TPU kernel, a hand-written CUDA kernel that runs on CUDA tensors.  Read
launch counts from the kernel's own module (``ops.gather.GATHER_LAUNCHES``,
``ops.scatter_add.SCATTER_ADD_LAUNCHES``, ``ops.row_update.
ROW_UPDATE_LAUNCHES``, ``ops.gru.GRU_SCAN_LAUNCHES`` and
``GRU_SCAN_BWD_LAUNCHES``, ``ops.attention.DIN_ATTENTION_LAUNCHES``,
``ops.cin.CIN_MIX_LAUNCHES``, ``ops.scatter_rows.STATIC_SCATTER_LAUNCHES``
and ``SCATTER_ROWS_LAUNCHES``): a name imported from it is a copy taken at
import time.  The training kernels live in ``ops.scatter_add`` and
``ops.row_update``, the sequence kernels in ``ops.gru`` and
``ops.attention``, xDeepFM's CIN kernel in ``ops.cin``, and the row
scatter of the scatter micro-benchmark in ``ops.scatter_rows``."""

from .reference import (fm_cross_ref, cin_layer_ref, cin_mix_ref,
                        cross_net_ref, din_attention_ref)
from .dispatch import fm_cross, cin_layer, cin_mix, cross_net, din_attention
from .gather import gather_rows, gather_rows_ref
