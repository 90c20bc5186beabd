"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths, DeepFM, xDeepFM and the zoo (WDL, NFM, DCN,
DCNMix, AutoInt, AFM, FiBiNET, PNN) serving and training at Criteo width
and DIN/DIEN serving and training at the sequence bench's width, through
the entry points a user calls (``DeepFM(...)``, ``xDeepFM(...)``,
``DCN(...)`` and the other zoo models, ``DIN(...)``, ``DIEN(...)``,
``model.predict``, ``model.compile``, ``model.fit``, ``model.evaluate``),
and the scatter micro-benchmark (``python -m
deepctr_tpu_torch.tools.scatter_micro``), and holds every CUDA kernel of
those paths against its plain PyTorch version.
Serving first:

1. build: compile every kernel under ``deepctr_tpu_torch/csrc/`` (one
   ``nvcc`` a source, all started together) and print the build time, and
   the SASS instruction counts (``cuobjdump -sass``) of the GRU kernels,
   of the attention kernel's bfloat16 relu instances (both designs) and
   of every ``row_update`` instance (optimizer x route);
2. kernel vs plain: ``gather_rows`` at the bench shape (B=4096, the 26
   Criteo tables, row width 17) must equal ``gather_rows_ref`` bit for
   bit, ids at V-1 and out-of-range ids (NaN rows) included, and so at
   ``GATHER_CASES``: widths 1, 8, 17, 32 (16-byte rows and rows at a
   4-byte offset) and 33 over B=77 x 3 fields (no multiple of 32 pairs),
   and 300 fields (more than a block stages);
3. DeepFM predict, float32: the 26 real Criteo vocabularies (33.8M rows),
   13 dense fields, DNN 400-400-400, weights drawn at std 0.05 from a
   seed; 8 batches of 4096 requests through the kernel (its launch count
   must rise), every prediction finite and in (0, 1), and the first batch
   within 1e-5 of the same model on the CPU;
4. timing, bfloat16 compute: predict in examples/s (CUDA events, median
   of 5 runs after warm-up) beside its device busy time, and its device
   time by kernel (``torch.profiler``); the kernel (beside its earlier
   design's time), its plain version and a library gather in ms of device
   time with a cold L2 and, apart, per call with the host included; the
   kernel on the same ids sorted within each field and with a warm L2;
   the kernel's bound from this run's bytes.

Then the training path, DeepFM ``compile``/``fit`` on the same model:

5. train kernels vs plain at the bench shape (B=4096, the 26 Criteo
   tables, W=17, the real dedup of a uniform batch with adagrad's "auto"
   split: 8 sparse tables, 18 dense), and at a long-run case (a 3-row
   dense table read by every row of B=4096 in three fields, a 1000-row
   one, an id out of range): ``scatter_add_rows``' sort must equal
   ``sort_keys_ref``, its result ``scatter_add_rows_chunked_ref`` (the
   plain version of its two-level order) run on CPU copies bit for bit,
   and ``scatter_add_rows_ref`` (``index_add_`` on the CPU) bit for bit on
   every target row of at most CHUNK contributions and within 1e-6 of the
   sum of the terms' magnitudes on the others; a repeat gives the same
   bits (``index_add_`` on the card adds with atomics, so it is only
   reported); ``row_update`` must equal ``row_update_ref`` on the card bit
   for bit for sgd, adagrad, rmsprop and adam, every table and state, and
   change no row but the touched ones, the padding of each table's fixed
   capacity (row ids past the table) dropped, at three cases: the bench
   shape (W=17, the train step's touched rows), DIEN's sparse shape (the
   touched rows of a batch of 1024 in its three W=32 tables, on the route
   of 16-byte units) and 46 tables of widths 1-128 (more W=17 tables than
   a launch holds, a table one float past a 16-byte boundary, some with no
   row, some with padding), each call with the launches its plan
   (``launch_plan``) counts;
6. ``compile("adagrad")`` + ``fit`` at full width, float32, a few steps
   of 4096: the 8 tables of >= 16384 rows go sparse, each kernel
   launches once a step, the loss is finite, and in every sparse table
   exactly the rows the batches touched (with row 0) changed;
7. card vs CPU: the same steps on a copy with every vocabulary capped at
   2M rows (the same 8/18 split), started from the same weights on the
   card and on the CPU: per-step losses within 1e-4 relative, weights
   within 1e-4 but for at most 1e-5 of them and all within 2 lr a step
   (the matmuls sum in another order, and adagrad's first step is close
   to lr * sign(g), so a gradient near 0 may flip a weight by 2 lr);
8. timing, bfloat16 compute: ``fit`` in examples/s (CUDA events) and its
   device idle share (``torch.profiler``); both train kernels, their
   plain versions and a library call in device ms with a cold L2 and per
   call, ``scatter_add_rows``' sort and sums apart, and their bounds from
   this run's bytes; ``row_update`` for every optimizer, the whole call
   and the kernel alone (its argument structs built beforehand), each with
   a cold and a warm L2, beside its bytes bound and its bound in 32-byte
   sectors; and the floor of this timing, one launch of a one-element
   ``add_``.

Then the sequence models' serving path, at the columns of
``tools/seq_train_bench.py`` (user 1000, item_id 10000 and cate_id 100
rows with E=32, a dense field, the item and cate histories at maxlen 100
sharing their tables) and batches of 1024, DNN 256-128, attention 64-16:

9. kernels vs plain: ``gru_scan`` at T=100, H=64 in all three modes,
   float32 and bfloat16 storage, B=1024 and a ragged B=1000, on prefix
   masks (lengths over [0, 100]) and on masks with holes (holes inside the
   histories, trailing padding, an empty and a full-length row), and with
   holes at H=256 (the wide design, W_hh^T read through L2) and at an odd
   H=13 with a ragged B=77 (the row-blocked design); ``din_attention_fused``
   at E=64, T=100, B=1024, at a ragged B=1000 on masks with holes, at
   E=13, T=30, B=77, layers 36-10 (widths no multiple of 8), at T=300
   (histories longer than a window), at E=256, T=150, layers 32-8
   (smaller windows), at E=64, layers 64-32-16 (three hidden layers), all
   on the tensor-core design's instance of up to 8 n tiles, at E=64,
   layers 80-40 (DIN's default, also through
   ``AttentionSequencePoolingLayer``), at E=32, layers 128-64 (its widest)
   and at E=64, one layer of 100, on its instance of up to 16, and at
   E=512, T=200, layers 80-40 (the top of the layer's gate, on the FMA
   design, also through the layer), sigmoid, relu and linear, weight
   normalisation on and off, float32 and bfloat16 keys, every weight at
   std 0.3; both instances and the FMA design must be among the cases.
   float32 within 1e-5 (relative
   above 1; the attention against a float64 evaluation, relative to
   sum_t |s_t k_t| above 1, or within twice the plain version's own error
   where that is larger), bfloat16 within one bf16 ulp; padded steps and
   empty histories give exact zeros;
10. DIEN predict, float32: ``gru_type="GRU"`` (two ``gru_scan`` launches and
    one ``din_attention`` launch a batch) and ``"AUGRU"`` with negative
    sampling (two ``gru_scan`` launches, the attention scores by
    composition); 8 batches, weights at std 0.3 from a seed, every
    prediction finite and in (0, 1), the first batch within 1e-5 of the
    same model on the CPU (whose attention runs the layer composition);
11. DIN predict, float32, the same way: ``att_activation`` Dice (no fused
    attention: the composition) and sigmoid (one launch a batch);
12. timing, bfloat16 compute: predict of DIN (Dice, sigmoid) and DIEN (GRU,
    AUGRU) in examples/s (CUDA events, median of 5 after warm-up) beside
    device busy time and idle share (``torch.profiler``); both kernels and
    their plain versions in device ms with a cold L2 (each beside its
    earlier design's time; the GRU's with the steps its blocks walk),
    ``torch.nn.GRU`` as the GRU's library yardstick (timed only; the port
    never calls it), and each kernel's bound from this run's inputs (the
    attention's at the TF32 tensor rate, 2-3 products a multiply-add,
    beside the float32 FMA one); the attention at every history length 0,
    every length 100 and uniform lengths; the gather at the sequence
    shape (B=1024, DIEN's 203 predict and 403 training fields of W=32)
    beside its bytes bound.

Then the sequence models' training path, at the same columns:

13. the GRU backward kernel (``gru_scan_bwd``) against ``gru_scan_bwd_ref``
    on the carries of the carry-saving forward, at the shapes and masks of
    phase 9,
    all three modes, float32 and bfloat16 storage, with the output
    cotangents given and absent: dgi as phase 9 holds outputs; dW_hh,
    db_hh and d(att), sums over (t, b) or over the H units, within 1e-5
    of the sum of their terms' magnitudes (one bf16 ulp for d(att) at
    bfloat16),
    exact zeros on padded steps, the same bits from a repeat launch; the
    carry-saving forward gives the inference forward's bits and the plain
    version's carries;
14. ``compile("adagrad")`` + ``fit`` + ``evaluate`` at float32, full width,
    3 steps of 1024: DIEN ``AUGRU`` with negative sampling and DIN with
    Dice, the tables dense under "auto" (11,100 rows), each step's launches
    (DIEN: one gather of 403 fields, one scatter, two ``gru_scan`` and two
    ``gru_scan_bwd``; DIN: one gather, one scatter), finite losses; DIEN
    again with ``sparse_table_updates=True`` (one ``row_update`` a step,
    exactly the touched rows and row 0 change); then card against CPU from
    the same weights at batches of 256: per-step losses within 1e-4
    relative;
15. timing, bfloat16 compute: ``fit`` of both models, and of DIEN with
    ``sparse_table_updates=True``, in examples/s beside device busy time
    and idle share; ``row_update`` at DIEN's sparse shape for every
    optimizer as in phase 8; the backward kernel (beside its earlier
    time; its reverse scan and its dW_hh product apart, the product beside
    its own bound), its plain version and ``torch.nn.GRU``'s backward in
    device ms with a cold L2, and its bound; the carry-saving forward
    beside the inference forward.

Then xDeepFM at the Criteo width of ``bench.py``'s xdeepfm leg (26 fields
of 10,000 rows with E=16, 13 dense fields, DNN 400-400, CIN 256-128 with
split_half, batches of 4096), serving and training:

16. ``cin_mix`` against ``cin_mix_ref`` on the card at both layers' shapes
    (B=4096, D=16, F=26: H=26, O=256 and H=128, O=128, the latter as the
    layer gives it, the first half of a [B, D, 256] map), at a ragged
    B=1000, at the split_half=False layer-1 shape (H=256, K=6656), at O=100
    (no multiple of 8) beside H=26, at an odd small shape (D=3, H=5, F=3,
    O=7), at H=400 (bfloat16 on the tensor cores with 128-row blocks) and
    at H=1000 (bfloat16 rows too wide for the tensor-core path's shared
    memory: the FMA route), float32 and bfloat16: float32
    within 1e-5 of sum_k |w z| per element (the plain version's matmul
    without TF32), bfloat16 within one bf16 ulp; a repeat launch gives the
    same bits; ``CinMix``'s gradients (dh, dx, dwt) against autograd
    through ``cin_mix_ref`` at float32, within 1e-5 of the sums of their
    terms' magnitudes;
17. xDeepFM at float32, weights redrawn from a seed so that predictions
    spread: ``predict`` over 8 batches (2 ``cin_mix`` launches and 1
    gather a batch), every prediction finite and in (0, 1), the first
    batch within 1e-5 of the same model on the CPU; ``compile("adagrad")``
    + ``fit`` + ``evaluate``, 3 steps of 4096 (tables dense under "auto":
    a gather, a scatter and 2 ``cin_mix`` launches a step), finite losses;
    card against CPU from the same weights at batches of 512: per-step
    losses within 1e-4 relative;
18. timing, bfloat16 compute: xDeepFM ``predict`` and ``fit`` in
    examples/s (CUDA events, median of 5 after a warm-up) with the
    device's idle share and device time by kernel (``torch.profiler``);
    ``cin_mix`` at each layer's shape in device ms with a cold L2 beside
    its plain version and the library's product of a prebuilt z by the
    weight (``torch.matmul``; building z is timed apart), and its bound
    from this run's shapes.

Then the row scatter of the scatter micro-benchmark:

19. ``static_scatter`` at the shape of ``tools/scatter_issue_micro.py``
    (26 tables of 142,858 pair rows of 2 x 128 float32 in a 3.8 GB arena,
    5,120 slots a table, 4,097 valid, the rest at the dump row) at unroll
    1, 2, 4 and 8, and the dynamic variant (one launch, and one a table):
    bit-equal to the plain versions on every row but the dump row, whose
    every value is one of the padding slots'; rows no slot names
    unchanged; the rows past the arena untouched; the dynamic variant
    leaves the dump row alone.  Then the micro-benchmark's run
    (``deepctr_tpu_torch/tools/scatter_micro.py``) with a few repeats, its
    lines printed, and each variant in device ms with a cold L2 beside the
    plain version and the library's ``index_copy_`` of every slot (the
    padding slots onto the dump row: the function the kernel computes) and,
    a smaller function, of the valid rows alone.

Then the device-resident loops (``fit`` on a device tensor, each step a
replay of one captured CUDA graph; ``predict``, each batch a replay), for
DeepFM at Criteo width (8 x 4096, the 8 sparse tables), DIEN AUGRU with
negative sampling and its tables sparse (8 x 1024), DIN sigmoid and
xDeepFM (2 batches each):

20. float32: ``predict`` graphed against the eager forward bit for bit,
    before and after a ``fit``; ``fit(assemble_device_input(x))``
    graphed (the first step the capture's warm-up, the rest replays)
    against the same steps run through ``_train_step`` on a twin from the
    same seed, bit for bit in per-step losses, every weight, every dense
    and sparse optimizer state; every step, warm-up and replay under
    ``torch.cuda.set_sync_debug_mode("error")``, so that any host read
    fails the run; each kernel launched its count a step or batch; for
    DIEN, the loop re-captured after ``set_weights`` and after
    ``compile`` gives the first fit's bits;
21. timing, bfloat16: each loop against the host-array ``fit`` on the
    same data, alternating, in examples/s (median of 5 with the spread),
    device busy and idle share (``torch.profiler``), device operations a
    step, graph replays and port kernels a step, host ms a step; DeepFM's
    and DIEN's graphed ``predict`` against the eager forward.

Then the zoo: WDL, NFM, DCN, DCNMix, AutoInt, AFM, FiBiNET and PNN at
``bench.py``'s Criteo layout (26 fields of 10,000 rows with E=16, 13 dense
fields, batches of 4096, adagrad; each at its constructor's defaults, PNN
with both product layers), and DCN at the 26 Criteo Kaggle cardinalities
(33.8M rows; 8 tables on the sparse path), tables drawn at std 0.3 and
DNN kernels at 1/sqrt(fan_in) from a seed:

22. float32: graphed ``predict`` of 8 batches (one gather a batch), every
    prediction finite and in (0, 1), the first batch within 1e-5 of the
    same model on the CPU;
23. float32: phase 20's checks, 3 steps each: graphed ``predict`` and the
    device-resident ``fit`` bit-equal to the eager forward and to the same
    steps on a twin (losses, weights, every optimizer and table state),
    no host sync in any step or replay, one gather and one scatter a step
    and, for DCN Kaggle only, one ``row_update``;
24. timing, bfloat16: the device-resident ``fit`` (8 x 4096) and graphed
    ``predict`` in examples/s (median of 5, alternating, with the
    spread), device busy and idle share, and the device time by kernel of
    one replayed train step (``torch.profiler``).

The command's total seconds are printed before the kernels line.

Launches in the kernels line are those of the main-path runs (phases 3,
6, 10, 11, 14, 17, 20, 22 and 23; for ``static_scatter``, the
micro-benchmark's run in phase 19), each counted from 0 just before the run and read just
after; the runs that compare a kernel with its plain version, time it or
check the card against the CPU are not counted.  A graph replay adds the
launches its capture recorded.

Any failure exits non-zero.  Without a CUDA device it fails at once and
runs nothing on the CPU.  The last two lines before the final one are the
card (``nvidia-smi`` name and power limit) and a JSON line describing each
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import deepctr_tpu_torch as pt  # noqa: E402
from deepctr_tpu_torch.models import (  # noqa: E402
    AFM, DCN, DIEN, DIN, NFM, PNN, WDL, AutoInt, DCNMix, DeepFM, FiBiNET,
    xDeepFM)
from deepctr_tpu_torch.models import graphs  # noqa: E402
from deepctr_tpu_torch.layers.sequence import (  # noqa: E402
    AttentionSequencePoolingLayer)
from deepctr_tpu_torch.ops import _build  # noqa: E402
from deepctr_tpu_torch.ops import attention  # noqa: E402
from deepctr_tpu_torch.ops import cin  # noqa: E402
from deepctr_tpu_torch.ops import gather  # noqa: E402
from deepctr_tpu_torch.ops import gru  # noqa: E402
from deepctr_tpu_torch.ops import row_update as rowup  # noqa: E402
from deepctr_tpu_torch.ops import scatter_add  # noqa: E402
from deepctr_tpu_torch.ops import scatter_rows  # noqa: E402
from deepctr_tpu_torch.tools import scatter_micro  # noqa: E402

# Criteo Kaggle display-advertising layout, as bench.py runs it
CRITEO_KAGGLE_VOCABS = [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
    15, 286181, 105, 142572]
N_DENSE = 13
EMB_DIM = 16
HIDDEN = (400, 400, 400)
BATCH = 4096
N_BATCHES = 8
INIT_STD = 0.05
SEED = 1024
ATOL_CPU = 1e-5

# H100 SXM device-memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12

TRAIN_STEPS = 4
CAP_VOCAB = 2_000_000
LOSS_RTOL = 1e-4
WEIGHT_ATOL = 1e-4
WEIGHT_OUTLIER_SHARE = 1e-5
# the tables of >= 16384 rows, which adagrad's "auto" puts on the sparse
# path at this width
EXPECTED_SPARSE = sorted("embedding_dict/C%d" % i
                         for i, v in enumerate(CRITEO_KAGGLE_VOCABS)
                         if v >= 16384)

# the sequence models: tools/seq_train_bench.py:40-64 at maxlen 100, the
# serving batch of tools/predict_bench.py:37
SEQ_VOCABS = {"user": 1000, "item_id": 10000, "cate_id": 100}
SEQ_EMB = 32
SEQ_MAXLEN = 100
SEQ_BATCH = 1024
SEQ_BATCHES = 8
SEQ_HIDDEN = (256, 128)
SEQ_ATT = (64, 16)
SEQ_STD = 0.3
# the top of the fused attention's gate (E <= 512) at twice the bench's
# maxlen, with DIN's default attention 80-40; and a GRU too wide for
# W_hh^T to sit in shared memory
WIDE_ATT = dict(B=256, T=200, E=512, hidden=(80, 40))
WIDE_GRU = dict(B=300, T=50, H=256)
# widths no multiple of 8 (E padded to 16, the layers to 40 and 16), a
# ragged B and masks with holes; histories longer than the tensor-core
# design's window of 128 steps; and E=256 with layers 32-8, whose key rows
# take windows of 64 (bfloat16) and 32 (float32) steps
ODD_ATT = dict(B=77, T=30, E=13, hidden=(36, 10), masks="holes")
LONG_ATT = dict(B=256, T=300, masks="holes")
WINDOW_ATT = dict(B=128, T=150, E=256, hidden=(32, 8), masks="holes")
# the tensor-core design's instance of up to 16 n tiles (hidden widths 72
# to 128): DIN's default attention 80-40 at the slice's E, the widest
# layers it takes, and one hidden layer; and three hidden layers on the
# instance of up to 8
DEFAULT_ATT = dict(B=512, T=100, hidden=(80, 40), masks="holes")
TOP_ATT = dict(B=128, T=60, E=32, hidden=(128, 64))
ONE_ATT = dict(B=256, T=50, hidden=(100,), masks="holes")
THREE_ATT = dict(B=256, T=50, hidden=(64, 32, 16), masks="holes")
# an odd width below the row-blocked design's top (H <= 64), a ragged B
ODD_GRU = dict(B=77, T=30, H=13)
# the GRU kernels' masks (gru_mask): prefixes, and histories with holes
GRU_MASKS = ("prefix", "holes")
# the GRU and attention kernels at the slice's shapes: H and E are the
# item and cate embeddings side by side
SEQ_H = 2 * SEQ_EMB
# f32: the card's expf/tanhf and another order of sums than the plain
# version's matmuls, relative to values above 1; for the attention, held
# to a float64 evaluation and relative to sum_t |s_t * k_t| above 1, the
# magnitude of the terms its readout sums (an unnormalised readout sums
# 100 scores times keys, which cancel), or within twice the plain float32
# version's own error where that is larger (under a softmax of large
# scores the scores' rounding, not the sum's, sets the error); bf16: one
# bf16 ulp of the value (the two round float32 results that differ by
# about 1e-7), or that float32 tolerance
KERNEL_F32_ATOL = 1e-5
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12
# H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet); the GRU kernels
# at H <= 64 run each float32 multiply-add as three TF32 products
TF32_FLOP_PER_S = 495e12
GRU_TF32_PRODUCTS = 3

# the sequence models' training: steps of SEQ_BATCH on the card, and the
# card-vs-CPU steps at a batch the CPU run takes in seconds
SEQ_TRAIN_STEPS = 3
SEQ_CPU_BATCH = 256
SEQ_CPU_STEPS = 3
# the launches of one train step (tables dense under "auto": no row_update)
SEQ_TRAIN_LAUNCHES = {
    ("dien", "AUGRU"): {"gather_rows": 1, "scatter_add_rows": 1,
                        "gru_scan": 2, "gru_scan_bwd": 2, "row_update": 0,
                        "din_attention": 0},
    ("din", "dice"): {"gather_rows": 1, "scatter_add_rows": 1, "gru_scan": 0,
                      "gru_scan_bwd": 0, "row_update": 0,
                      "din_attention": 0},
}

# xDeepFM: bench.py:271-273 at its defaults (bench.py:29-36)
XD_VOCAB = 10000
XD_FIELDS = 26
XD_HIDDEN = (400, 400)
XD_CIN = (256, 128)
XD_EMB_STD = 0.3
XD_TRAIN_STEPS = 3
XD_CPU_BATCH = 512
XD_CPU_STEPS = 3
# the CIN layers' (H, O) at split_half, D = EMB_DIM, F = XD_FIELDS
XD_LAYERS = ((XD_FIELDS, XD_CIN[0]), (XD_CIN[0] // 2, XD_CIN[1]))
# H100 SXM bf16 dense tensor-core rate (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12
# the launches of one xDeepFM train step (tables dense under "auto")
XD_TRAIN_LAUNCHES = {"gather_rows": 1, "scatter_add_rows": 1, "cin_mix": 2,
                     "row_update": 0}
# phase 19: the micro-benchmark's repeats, and rows of a sentinel past the
# arena
SCATTER_REPEATS = 5
GUARD_ROWS = 64

# the earlier designs' times (PERF.md section 6; NVIDIA H100 80GB HBM3,
# 700 W), printed in brackets beside this run's: K3 and K5 at bf16,
# B=1024, T=100, H=64; K4 at bf16 keys, relu with softmax, B=1024, T=100,
# E=64; the gather at B=4096, the 26 Criteo tables, W=17, and at the
# sequence shape, B=1024, 203 and 403 fields of W=32; K2, adagrad, over
# the touched rows of a batch of 4096 in the 8 sparse Criteo tables (W=17),
# the whole call over the touched rows alone, before the fixed capacity
EARLIER_MS = {"gru_scan": 0.3064, "gru_scan_bwd": 0.7126,
              "din_attention": 0.1388, "gather_rows": 0.01726,
              "gather_rows_seq_203": 0.03406,
              "gather_rows_seq_403": 0.06024, "row_update": 0.01568}

KERNELS = {
    "gather_rows": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/gather_rows.cu",
        "replaces": "deepctr_tpu/ops/pallas_gather.py:33",
    },
    "scatter_add_rows": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/scatter_add_rows.cu",
        "replaces": "deepctr_tpu/ops/pallas_gather.py:163",
    },
    "row_update": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/row_update.cu",
        "replaces": "deepctr_tpu/ops/pallas_update.py:146; "
                    "deepctr_tpu/ops/pallas_update.py:357; "
                    "deepctr_tpu/ops/pallas_update.py:455; "
                    "deepctr_tpu/ops/pallas_update.py:520; "
                    "deepctr_tpu/ops/pallas_update.py:571",
    },
    "gru_scan": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/gru_scan.cu",
        "replaces": "deepctr_tpu/ops/pallas_gru.py:213",
    },
    "gru_scan_bwd": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/gru_scan_bwd.cu",
        "replaces": "deepctr_tpu/ops/pallas_gru.py:264",
    },
    "din_attention": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/din_attention.cu",
        "replaces": "deepctr_tpu/ops/pallas_attention.py:73",
    },
    "cin_mix": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/cin_mix.cu",
        "replaces": "deepctr_tpu/ops/pallas.py:68",
    },
    "static_scatter": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/static_scatter.cu",
        "replaces": "tools/scatter_issue_micro.py:85",
    },
}

# each kernel's launch counter: (module, attribute)
COUNTERS = {
    "gather_rows": (gather, "GATHER_LAUNCHES"),
    "scatter_add_rows": (scatter_add, "SCATTER_ADD_LAUNCHES"),
    "row_update": (rowup, "ROW_UPDATE_LAUNCHES"),
    "gru_scan": (gru, "GRU_SCAN_LAUNCHES"),
    "gru_scan_bwd": (gru, "GRU_SCAN_BWD_LAUNCHES"),
    "din_attention": (attention, "DIN_ATTENTION_LAUNCHES"),
    "cin_mix": (cin, "CIN_MIX_LAUNCHES"),
    "static_scatter": (scatter_rows, "STATIC_SCATTER_LAUNCHES"),
}
# the launches of every main-path run, summed (read_counts adds to it)
MAIN_PATH_LAUNCHES = dict.fromkeys(COUNTERS, 0)


def log(msg):
    print(msg, flush=True)


def reset_counts():
    """Every kernel's launch count to 0, just before a main-path run."""
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counts():
    """The launches since reset_counts(), just after a main-path run;
    added to MAIN_PATH_LAUNCHES."""
    counts = {name: getattr(module, attr)
              for name, (module, attr) in COUNTERS.items()}
    for name, count in counts.items():
        MAIN_PATH_LAUNCHES[name] += count
    return counts


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, runs=5):
    """Median over ``runs`` of the mean time of ``reps`` calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def criteo_columns():
    sparse = [pt.SparseFeat("C%d" % i, v, EMB_DIM)
              for i, v in enumerate(CRITEO_KAGGLE_VOCABS)]
    dense = [pt.DenseFeat("I%d" % i, 1) for i in range(N_DENSE)]
    return sparse + dense


def criteo_requests(n, generator, device):
    """A flat [n, 39] float32 batch: uniform ids in every field, dense
    values in [0, 1)."""
    vocabs = torch.tensor(CRITEO_KAGGLE_VOCABS, dtype=torch.float64,
                          device=device)
    u = torch.rand(n, len(vocabs), generator=generator, device=device,
                   dtype=torch.float64)
    ids = torch.floor(u * vocabs).clamp_max(vocabs - 1)
    dense = torch.rand(n, N_DENSE, generator=generator, device=device)
    return torch.cat([ids.float(), dense], dim=1).contiguous()


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def check_predictions(pred, n):
    check(pred.shape == (n, 1), "predictions of shape %s" % (pred.shape,))
    check(np.isfinite(pred).all(), "non-finite predictions")
    check(((pred > 0) & (pred < 1)).all(), "predictions outside (0, 1)")


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    for name, text in sorted(logs.items()):
        log("nvcc %s:\n%s" % (name, text.strip()))
    log("build: %d kernel source(s) compiled in %.2f s"
        % (len(logs), seconds))
    log_sass()


# phase 2's other gather cases: (row width, fields, rows, tables cut at a
# 4-byte offset): every instance of the kernel (W = 1 and 17 as templates,
# 32 as 8 16-byte units, 8 as generic 16-byte units, 33 and an unaligned
# 32 generic), a pair count no multiple of 32 (77 x 3), and more fields
# than a block stages
GATHER_CASES = ((1, 3, 77, False), (8, 3, 77, False), (17, 3, 77, False),
                (32, 3, 77, False), (32, 3, 77, True), (33, 3, 77, False),
                (32, 300, 5, False))


def check_gather_case(width, n_fields, B, shifted, device, seed):
    """gather_rows against gather_rows_ref, bit for bit, on ids uniform
    over [-2, V + 2) (out-of-range ids give NaN rows) with V - 1, V, -1
    and 0.9 in the first rows, tables of 50, 1000 and 7 rows in turn."""
    gen = torch.Generator(device=device).manual_seed(seed)
    vocabs = [(50, 1000, 7)[f % 3] for f in range(n_fields)]
    tables = []
    for v in vocabs:
        t = torch.randn(v * width + 1, generator=gen, device=device)
        tables.append((t[1:] if shifted else t[:-1]).view(v, width))
    V = torch.tensor(vocabs, dtype=torch.float32, device=device)
    X = torch.floor(torch.rand(B, n_fields, generator=gen, device=device)
                    * (V + 4) - 2)
    X[0], X[1], X[2], X[3] = V - 1, V, -1.0, 0.9
    X = torch.cat([torch.rand(B, 1, generator=gen, device=device), X], 1)
    cols = list(range(1, n_fields + 1))
    got = gather.gather_rows(X, tables, cols)
    want = gather.gather_rows_ref(X, tables, cols)
    torch.cuda.synchronize()
    what = ("gather_rows B=%d F=%d W=%d (%s rows)" % (
        B, n_fields, width, "16-byte" if gather.vector_rows(tables)
        else "float"))
    check(same_bits(got, want), what + " differs from its plain version")
    for f, t in enumerate(tables):
        check(torch.equal(got[0, f], t[-1]), what + ": id V-1 of field %d"
              % f)
        check(torch.equal(got[3, f], t[0]), what + ": id 0.9 of field %d"
              % f)
    check(bool(torch.isnan(got[1:3]).all()), what + ": out-of-range ids "
          "must give NaN rows")
    return what


def phase_kernel_vs_plain(model, X):
    """gather_rows against gather_rows_ref at the main path's shapes, and
    at GATHER_CASES."""
    tables = [model.embedding_dict.tables["C%d" % i]
              for i in range(len(CRITEO_KAGGLE_VOCABS))]
    cols = list(range(len(tables)))
    with torch.no_grad():
        got = gather.gather_rows(X, tables, cols)
        want = gather.gather_rows_ref(X, tables, cols)
        torch.cuda.synchronize()
        check(same_bits(got, want), "gather_rows differs from its plain "
              "version at the bench shape")
        check(not torch.isnan(got).any(), "in-range ids gave NaN rows")

        edge = X[:8].clone()
        vocabs = torch.tensor(CRITEO_KAGGLE_VOCABS, dtype=torch.float32,
                              device=X.device)
        edge[0, :len(tables)] = vocabs - 1          # last row of each table
        edge[1, :len(tables)] = vocabs              # == V: out of range
        edge[2, :len(tables)] = -1.0                # negative: out of range
        edge[3, :len(tables)] = 0.9                 # truncates to row 0
        got_e = gather.gather_rows(edge, tables, cols)
        want_e = gather.gather_rows_ref(edge, tables, cols)
        torch.cuda.synchronize()
        check(same_bits(got_e, want_e), "gather_rows differs from its "
              "plain version on edge ids")
        for f, t in enumerate(tables):
            check(torch.equal(got_e[0, f], t[-1]), "id V-1 of field %d" % f)
            check(torch.equal(got_e[3, f], t[0]), "id 0.9 of field %d" % f)
        check(torch.isnan(got_e[1:3]).all(), "out-of-range ids must give "
              "NaN rows")
        cases = [check_gather_case(*case, X.device, SEED + 80 + i)
                 for i, case in enumerate(GATHER_CASES)]
    log("kernel vs plain: bit-equal, NaN rows and edge ids included: %s"
        % "; ".join(cases))
    finite = ~torch.isnan(want)
    err = (got[finite] - want[finite]).abs().max().item()
    log("kernel vs plain: gather_rows bit-equal at B=%d F=%d W=%d "
        "(max_abs_err %r), edge ids ok" % (X.shape[0], len(tables),
                                           tables[0].shape[1], err))
    return err


def phase_predict_f32(model, X_all):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_compute_dtype("float32")
    reset_counts()
    pred = model.predict(X_all, batch_size=BATCH)
    launches = read_counts()["gather_rows"]
    check(launches >= N_BATCHES, "the kernel launched %d times over %d "
          "batches" % (launches, N_BATCHES))
    check_predictions(pred, X_all.shape[0])
    log("predict f32: %d requests in %d batches, %d gather launches, "
        "predictions in [%.6f, %.6f], std %.6f"
        % (pred.shape[0], N_BATCHES, launches, pred.min(), pred.max(),
           pred.std()))

    first = X_all[:BATCH].cpu()
    model.to("cpu")
    try:
        pred_cpu = model.predict(first, batch_size=BATCH)
    finally:
        model.to("cuda")
    diff = float(np.abs(pred[:BATCH] - pred_cpu).max())
    check(diff <= ATOL_CPU, "card vs CPU: max |dp| %r > %r"
          % (diff, ATOL_CPU))
    log("predict f32: first batch vs CPU max |dp| = %r (atol %r)"
        % (diff, ATOL_CPU))
    return launches


def device_ms(fn, runs=20, cold=True):
    """Device time of ``fn``'s kernels with a cold L2, median of ``runs``.

    Before each run the stream is stalled (``torch.cuda._sleep``) for
    longer than the host takes to enqueue ``fn``, so host overhead is not
    timed, and a 128 MB write evicts the 50 MB L2, as a new batch finds
    the rows of 2.3 GB of tables cold.  With ``cold=False`` nothing is
    evicted: the run finds in L2 what the run before it left there."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    stall_cycles = int((4 * host_s + 2e-4) * 2e9)
    events = []
    for _ in range(runs):
        torch.cuda._sleep(stall_cycles)
        if cold:
            flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_timing_bf16(model, X_all):
    log("timing on: %s" % card_line())
    pt.set_compute_dtype("bfloat16")
    n = X_all.shape[0]
    pred = model.predict(X_all, batch_size=BATCH)
    check_predictions(pred, n)

    dev_ms = time_ms(lambda: model.predict(X_all, batch_size=BATCH),
                     reps=3)
    host = X_all.cpu().numpy()
    host_ms = time_ms(lambda: model.predict(host, batch_size=BATCH),
                      reps=3)
    busy_ms = profile_ms(lambda: model.predict(X_all, batch_size=BATCH),
                         "predict", top=6)
    log("predict bf16, device input: %r examples/s (%r ms for %d); device "
        "busy %s" % (n / dev_ms * 1e3, dev_ms, n, busy_line(busy_ms, dev_ms)))
    log("predict bf16, host numpy input: %r examples/s (%r ms for %d)"
        % (n / host_ms * 1e3, host_ms, n))

    X = X_all[:BATCH].contiguous()
    tables = [model.embedding_dict.tables["C%d" % i]
              for i in range(len(CRITEO_KAGGLE_VOCABS))]
    cols = list(range(len(tables)))
    args = gather.GatherArgs()
    ids = [X[:, c].to(torch.int32).to(torch.int64) for c in cols]
    timed = {
        "kernel": lambda: gather.gather_rows(X, tables, cols, args=args),
        "plain": lambda: gather.gather_rows_ref(X, tables, cols),
        # the library's row gather, one call per table, ids cast beforehand
        "library": lambda: [torch.index_select(t, 0, i)
                            for t, i in zip(tables, ids)],
    }
    ms, call_ms = {}, {}
    with torch.no_grad():
        for name, fn in timed.items():
            ms[name] = device_ms(fn)
            call_ms[name] = time_ms(fn, reps=20)

    # bytes the function must move: the id of every (b, f), every row the
    # ids touch (once), the [B, F, W] output
    width = tables[0].shape[1]
    unique_rows = sum(int(torch.unique(i).numel()) for i in ids)
    n_bytes = (4 * X.shape[0] * len(tables) + 4 * width * unique_rows
               + 4 * X.shape[0] * len(tables) * width)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log("gather_rows at B=%d F=%d W=%d, device time, cold L2: kernel %r ms "
        "(earlier design: %r ms), plain %r ms, library (index_select per "
        "table) %r ms; bound %r ms (%d bytes: %d unique rows, at %.3g B/s)"
        % (X.shape[0], len(tables), width, ms["kernel"],
           EARLIER_MS["gather_rows"], ms["plain"], ms["library"], bound_ms,
           n_bytes, unique_rows, HBM_BYTES_PER_S))
    log("gather_rows at B=%d F=%d W=%d, back-to-back calls, host included: "
        "kernel %r ms, plain %r ms, library %r ms a call"
        % (X.shape[0], len(tables), width, call_ms["kernel"],
           call_ms["plain"], call_ms["library"]))
    # the same ids sorted within each field (neighbouring pairs of a field
    # read neighbouring rows), and the uniform ids with a warm L2: what the
    # cost of random rows in device memory adds to the kernel's own
    X_sorted = X.clone()
    X_sorted[:, cols] = torch.sort(X[:, cols], dim=0).values
    with torch.no_grad():
        sorted_ms = device_ms(lambda: gather.gather_rows(
            X_sorted, tables, cols, args=args))
        warm_ms = device_ms(lambda: gather.gather_rows(
            X, tables, cols, args=args), cold=False)
    log("gather_rows at B=%d F=%d W=%d, device time: kernel %r ms on "
        "uniform ids with a cold L2, %r ms on the same ids sorted within "
        "each field, cold L2, %r ms on the uniform ids with a warm L2"
        % (X.shape[0], len(tables), width, ms["kernel"], sorted_ms,
           warm_ms))
    return {"ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "bound_ms": bound_ms,
            "bound_by": "bytes"}

# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def criteo_labels(n, seed):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.float32)


def train_kernel_args(model, X, seed):
    """Both train kernels' arguments as a train step of ``model`` builds
    them for the batch ``X``: the touched rows of its sparse tables, a
    cotangent of the gather ([B, F, W], normal from ``seed``), and each
    field's target (a zero dense gradient, or the touched rows') and
    row."""
    tables = model._tables()
    touched = model._touched_rows(X)
    plan = model._step_plan(X.shape[0])
    for g in plan.dense_grads.values():
        g.zero_()
    fcs = model._shared_columns
    gen = torch.Generator(device=X.device).manual_seed(seed)
    grad = torch.randn(X.shape[0], len(fcs), tables[EXPECTED_SPARSE[0]]
                       .shape[1], generator=gen, device=X.device)
    targets, idx, _ = model._scatter_targets(X, "embedding_dict/", fcs,
                                             touched, plan)
    return touched, grad, targets, idx


def valid_counts(rows, tables):
    """The touched rows of each table among its fixed-capacity row list
    (the rest is padding past the table)."""
    return [int((r < w.shape[0]).sum()) for r, w in zip(rows, tables)]


def distinct_copies(targets, device=None, fn=None):
    """A copy of each distinct target (of ``fn`` of it, where given), on
    ``device`` (theirs by default), shared by the fields that share the
    target."""
    copies = {}
    for t in targets:
        if t.data_ptr() not in copies:
            v = fn(t.detach()) if fn else t.detach()
            copies[t.data_ptr()] = v.to(device or t.device, copy=True)
    return [copies[t.data_ptr()] for t in targets]


def long_run_case(device, seed, B=BATCH, W=EMB_DIM + 1):
    """scatter_add_rows' arguments with long runs: a 3-row dense table read
    by every row in three fields (runs of ~4096), a 1000-row table, an id
    out of range and a negative one; targets and cotangent normal."""
    gen = torch.Generator(device=device).manual_seed(seed)
    small = torch.randn(3, W, generator=gen, device=device)
    big = torch.randn(1000, W, generator=gen, device=device)
    targets = [small, big, small, small]
    rows = torch.stack([torch.randint(0, t.shape[0], (B,), generator=gen,
                                      device=device) for t in targets], 1)
    rows[5, 1] = 1000
    rows[9, 0] = -1
    grad = torch.randn(B, len(targets), W, generator=gen, device=device)
    return grad, targets, rows


def check_scatter_case(grad, targets, idx, what):
    """scatter_add_rows on copies of ``targets`` against its plain
    versions (see phase 5); returns max |kernel - index_add_ on the CPU|."""
    C = scatter_add.CHUNK
    check(_build.load("scatter_add_rows").scatter_add_rows_chunk() == C,
          "scatter_add.CHUNK differs from the kernels' chunk length")
    got = distinct_copies(targets)
    again = distinct_copies(targets)
    scatter_add.scatter_add_rows(grad, got, idx)
    scatter_add.scatter_add_rows(grad, again, idx)
    # the kernels' sort, left in a workspace by a sort-only call
    meta = scatter_add.kernel_args(targets, grad.device)
    total = scatter_add.total_rows(targets)
    ws = scatter_add.workspace(idx.numel(), grad.shape[2], grad.device)
    scatter_add.launch(grad, idx, meta, total, ws, part=1)
    keys, order = scatter_add.kernel_sorted(ws, idx.numel(), grad.shape[2],
                                            total)
    cpu_grad, cpu_idx = grad.cpu(), idx.cpu()
    chunked = distinct_copies(targets, "cpu")
    scatter_add.scatter_add_rows_chunked_ref(cpu_grad, chunked, cpu_idx)
    plain = distinct_copies(targets, "cpu")
    scatter_add.scatter_add_rows_ref(cpu_grad, plain, cpu_idx)
    scale = distinct_copies(targets, "cpu", torch.abs)
    scatter_add.scatter_add_rows_ref(cpu_grad.abs(), scale, cpu_idx)
    counts = distinct_copies(targets, "cpu",
                             lambda t: torch.zeros(t.shape[0], 1))
    scatter_add.scatter_add_rows_ref(torch.ones(*cpu_idx.shape, 1), counts,
                                     cpu_idx)
    want_keys, want_order = scatter_add.sort_keys_ref(
        chunked, cpu_idx, scatter_add.kernel_args(chunked, "cpu"))
    torch.cuda.synchronize()
    check(torch.equal(keys.cpu().long(), want_keys)
          and torch.equal(order.cpu().long(), want_order),
          "scatter_add_rows' sort differs from sort_keys_ref at " + what)
    err, rel, long_rows = 0.0, 0.0, 0
    firsts = {}
    for i, t in enumerate(targets):
        firsts.setdefault(t.data_ptr(), i)
    for i in firsts.values():
        a, c, p, s, n = got[i], chunked[i], plain[i], scale[i], counts[i]
        check(same_bits(a, again[i]), "scatter_add_rows: a repeat gave "
              "other bits at " + what)
        a = a.cpu()
        check(same_bits(a, c), "scatter_add_rows differs from its plain "
              "two-level version at " + what)
        short = n[:, 0] <= C
        check(same_bits(a[short], p[short]), "scatter_add_rows differs from "
              "index_add_ on a row of at most %d contributions at %s"
              % (C, what))
        d = (a - p).abs()
        rel = max(rel, (d / s.clamp_min(1e-30)).max().item())
        check(bool((d <= 1e-6 * s).all()), "scatter_add_rows: a long run "
              "differs from index_add_ by more than 1e-6 of the sum of its "
              "terms' magnitudes at " + what)
        err = max(err, d.max().item())
        long_rows += int((~short).sum())
    log("kernel vs plain: scatter_add_rows at %s (B=%d F=%d W=%d): sort "
        "equal to sort_keys_ref, bit-equal to the two-level plain version, "
        "bit-equal to index_add_ on the CPU on rows of at most %d "
        "contributions, %d longer rows within %r of the sum of their terms' "
        "magnitudes (max |err| %r); repeat bit-equal"
        % (what, grad.shape[0], grad.shape[1], grad.shape[2], C, long_rows,
           rel, err))
    return err


# row_update's optimizers, each timed and checked
OPTIMIZERS = ("sgd", "adagrad", "rmsprop", "adam")


def k2_states(opt, tables, gen):
    """Uniform [0, 1) state tensors for ``opt``, shaped like ``tables``."""
    return [tuple(torch.rand(t.shape, generator=gen, device=t.device)
                  for _ in range(rowup.MODES[opt][1])) for t in tables]


def k2_bias(opt, n_tables, device):
    """adam's (1 - b1^3, 1 - b2^3) on the device for every table, else
    None."""
    if opt != "adam":
        return None
    return [torch.tensor(rowup.adam_bias_corrections(3),
                         device=device)] * n_tables


def k2_bounds(opt, tables, states, rows):
    """row_update's least times: ``(bytes ms, sectors ms, bytes, sector
    bytes)``.  Bytes: every touched element's table and state read and
    written once, its gradient read once, each row id of the fixed
    capacity once (the padding past the table needs nothing else).
    Sectors: the same, but each touched row of a table or state array
    counted as the 32-byte sectors its span covers at its address in this
    run (a 68-byte row at a 4-byte offset always covers three)."""
    n_bytes = sec_bytes = 0
    for w, st, r in zip(tables, states, rows):
        width = w.shape[1]
        arrays = (w,) + tuple(st)
        valid = r[r < w.shape[0]]
        n = valid.numel()
        n_bytes += (n * width * 4 * (2 * len(arrays) + 1)
                    + r.numel() * 8)
        sec_bytes += n * width * 4 + r.numel() * 8
        for a in arrays:
            start = a.data_ptr() % 32 + valid * (width * 4)
            sectors = (start + width * 4 - 1) // 32 - start // 32 + 1
            sec_bytes += 2 * 32 * int(sectors.sum())
    return (n_bytes / HBM_BYTES_PER_S * 1e3,
            sec_bytes / HBM_BYTES_PER_S * 1e3, n_bytes, sec_bytes)


def k2_times(opt, upd, bias):
    """row_update's device ms (median of 20): the whole call and the
    kernel alone (its argument structs built beforehand), each with a cold
    and a warm L2."""
    device = upd[0][0].device
    launches = rowup.kernel_args(opt, *upd, bias)
    timed = {"call": lambda: rowup.row_update(opt, *upd, bias),
             "alone": lambda: rowup.launch(launches, device)}
    with torch.no_grad():
        return {"%s %s" % (k, heat): device_ms(fn, cold=heat == "cold")
                for k, fn in timed.items() for heat in ("cold", "warm")}


def k2_line(opt, what, times, bounds):
    return ("row_update (%s) at %s, device time: whole call %r ms cold L2, "
            "%r ms warm; the kernel alone %r ms cold, %r ms warm; bounds "
            "%r ms (bytes, %d) and %r ms (sectors, %d)"
            % (opt, what, times["call cold"], times["call warm"],
               times["alone cold"], times["alone warm"], bounds[0],
               bounds[2], bounds[1], bounds[3]))


def dien_sparse_args(device, seed=SEED + 85):
    """row_update's tables, touched rows and l2 vectors at DIEN AUGRU's
    ``sparse_table_updates=True`` shape: the three tables (user, item_id,
    cate_id; W=32) and the rows one batch of SEQ_BATCH touches, histories
    and negative samples included, as phase 14's fit builds them; the
    gradients normal from ``seed``.  Returns (model, tables, touched, l2
    vectors)."""
    pt.set_compute_dtype("float32")
    model = seq_model("dien", "AUGRU", device)
    model.compile("adagrad", "binary_crossentropy",
                  sparse_table_updates=True)
    x, _ = seq_train_data(model, SEQ_BATCH, seed)
    X = torch.from_numpy(x).to(device)
    tables = model._tables()
    paths = [p for p, _, _ in model._sparse_specs]
    touched = model._touched_rows(X)
    gen = torch.Generator(device=device).manual_seed(seed)
    for g in touched.grads:
        g.normal_(generator=gen)
    return (model, [tables[p].detach() for p in paths], touched,
            [model._table_l2_vec(p) for p in paths])


def check_row_update_case(base, grads, rows, l2s, what, seed):
    """row_update against row_update_ref on copies of ``base``, for every
    optimizer with states uniform from ``seed``: every table and state bit
    for bit, no row changed in any table or state but those ``rows[t]``
    lists inside the table (its padding past the table is dropped), one
    launch for each of launch_plan's.  Returns max |err|."""
    gen = torch.Generator(device=base[0].device).manual_seed(seed)
    untouched = []
    for w, r in zip(base, rows):
        u = torch.ones(w.shape[0], dtype=torch.bool, device=w.device)
        u[r[r < w.shape[0]]] = False
        untouched.append(u)
    err = 0.0
    for opt in OPTIMIZERS:
        plain_w = [t.clone() for t in base]
        plain_s = k2_states(opt, base, gen)
        kern_w = [same_offset_copy(t) for t in base]
        kern_s = [tuple(s.clone() for s in st) for st in plain_s]
        first_s = [tuple(s.clone() for s in st) for st in plain_s]
        want_launches = len(rowup.launch_plan(
            [len(r) for r in rows],
            rowup.table_routes(kern_w, kern_s, grads, rows, l2s)))
        args = (grads, rows, l2s, 0.01,
                k2_bias(opt, len(base), base[0].device))
        before = rowup.ROW_UPDATE_LAUNCHES
        rowup.row_update(opt, kern_w, kern_s, *args)
        launches = rowup.ROW_UPDATE_LAUNCHES - before
        check(launches == want_launches, "row_update (%s) launched %d times "
              "at %s, its plan %d" % (opt, launches, what, want_launches))
        rowup.row_update_ref(opt, plain_w, plain_s, *args)
        torch.cuda.synchronize()
        for a, b in zip(kern_w + [s for st in kern_s for s in st],
                        plain_w + [s for st in plain_s for s in st]):
            check(same_bits(a, b), "row_update (%s) differs from its plain "
                  "version at %s" % (opt, what))
            err = max(err, (a - b).abs().max().item())
        for w, w0, st, st0, u in zip(kern_w, base, kern_s, first_s,
                                     untouched):
            for a, a0 in ((w, w0),) + tuple(zip(st, st0)):
                check(same_bits(a[u], a0[u]), "row_update (%s) changed "
                      "other rows than the touched ones at %s" % (opt, what))
        del plain_w, plain_s, kern_w, kern_s, first_s
    n_pad = sum(len(r) for r in rows) - sum(valid_counts(rows, base))
    log("kernel vs plain: row_update bit-equal for %s at %s (max_abs_err "
        "%r), only the touched rows changed (%d padding slots past their "
        "tables dropped), %d launch(es) a call as planned"
        % (", ".join(OPTIMIZERS), what, err, n_pad, want_launches))
    return err


def same_offset_copy(t):
    """A copy of ``t`` at the same offset from a 16-byte boundary (a clone
    would start on one), so that it takes the same route."""
    off = (t.data_ptr() % 16) // t.element_size()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    return buf[off:].view(t.shape).copy_(t)


# the many-table case after its CAPACITY + 6 W=17 tables, more than a
# launch holds: a table on each other route, W=32, 128, 8 and 4 in 16-byte
# units, 1 and 33 in floats, and a W=32 table one float past a 16-byte
# boundary in floats
MANY_OTHER_WIDTHS = (32, 1, 128, 8, 33, 4, "32+1", 32)


def many_tables_case(device, seed):
    """row_update's arguments over 46 tables of 300-2,000 rows (W=17, then
    MANY_OTHER_WIDTHS), each with some of its rows touched (padding past
    the table at the end of the rows given for some, no row for every
    ninth), tables and gradients normal from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tables, grads, rows, l2s = [], [], [], []
    widths = (17,) * (rowup.CAPACITY + 6) + MANY_OTHER_WIDTHS
    for i, kind in enumerate(widths):
        width = 32 if kind == "32+1" else kind
        V = 300 + 37 * i
        if kind == "32+1":
            t = torch.randn(V * width + 1, generator=gen,
                            device=device)[1:].view(V, width)
        else:
            t = torch.randn(V, width, generator=gen, device=device)
        n = int(torch.randint(1, V // 3, (1,), generator=gen,
                              device=device))
        tables.append(t)
        r = torch.randperm(V, generator=gen, device=device)[:n]
        g = torch.randn(n, width, generator=gen, device=device)
        count = 0 if i % 9 == 5 else n - (i % 3) * (n // 4)
        rows.append(torch.cat([r[:count], V + torch.arange(
            n - count, device=device)]) if count else r[:0])
        grads.append(g if count else g[:0])
        l2s.append(torch.rand(width, generator=gen, device=device) * 1e-3)
    return tables, grads, rows, l2s


def phase_train_kernels_vs_plain(model, X):
    """scatter_add_rows and row_update against their plain versions at the
    main path's shapes."""
    model.compile("adagrad", "binary_crossentropy")
    sparse = sorted(p for p, _, _ in model._sparse_specs)
    check(sparse == EXPECTED_SPARSE, "sparse tables %s, want %s"
          % (sparse, EXPECTED_SPARSE))
    with torch.no_grad():
        touched, grad, targets, idx = train_kernel_args(model, X, SEED + 5)
        copies = {}
        k1_err = check_scatter_case(grad, targets, idx, "the bench shape")
        on_card = [copies.setdefault(("card", t.data_ptr()),
                                     torch.zeros_like(t)) for t in targets]
        scatter_add.scatter_add_rows_ref(grad, on_card, idx)
        atomics_err = max((t - c).abs().max().item()
                          for t, c in zip(targets, on_card))
        n_pairs = sum(int(torch.unique(idx[:, f]).numel())
                      for f in range(idx.shape[1]))
        tables = model._tables()
        paths = [p for p, _, _ in model._sparse_specs]
        log("kernel vs plain: scatter_add_rows at B=%d F=%d W=%d (%d target "
            "rows, sparse tables %s touched rows of capacities %s); "
            "index_add_ on the card (atomics) differs by at most %r"
            % (grad.shape[0], grad.shape[1], grad.shape[2], n_pairs,
               valid_counts(touched.rows, [tables[p] for p in paths]),
               [len(r) for r in touched.rows], atomics_err))
        check_scatter_case(*long_run_case(X.device, SEED + 8),
                           "the long-run case")

        k2_err = check_row_update_case(
            [tables[p].detach() for p in paths], touched.grads,
            touched.rows, [model._table_l2_vec(p) for p in paths],
            "the bench shape", SEED + 6)
        dien, w, dtouched, l2s = dien_sparse_args(X.device)
        check(rowup.table_routes(w, [(t,) for t in w], dtouched.grads,
                                 dtouched.rows, l2s) == [rowup.VEC] * len(w),
              "DIEN's sparse tables are not on the route of 16-byte units")
        k2_err = max(k2_err, check_row_update_case(
            w, dtouched.grads, dtouched.rows, l2s, "DIEN's sparse shape",
            SEED + 11))
        del dien, w, dtouched
        case = many_tables_case(X.device, SEED + 12)
        routes = rowup.table_routes(case[0], [()] * len(case[0]), case[1],
                                    case[2], case[3])
        check(len(rowup.launch_plan([len(r) for r in case[2]], routes))
              > len(set(routes)),
              "the many-table case should take two launches on a route")
        k2_err = max(k2_err, check_row_update_case(
            *case, "%d tables (%d touched), widths %s" % (
                len(case[0]), sum(len(r) > 0 for r in case[2]),
                sorted({t.shape[1] for t in case[0]})), SEED + 13))
    return k1_err, k2_err


def phase_fit_f32(model, X_all):
    """compile("adagrad") + fit at full width: launches, loss, and which
    rows of the sparse tables changed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_compute_dtype("float32")
    model.compile("adagrad", "binary_crossentropy")
    sparse = sorted(p for p, _, _ in model._sparse_specs)
    check(sparse == EXPECTED_SPARSE, "sparse tables %s" % sparse)
    n = BATCH * TRAIN_STEPS
    x_host = X_all[:n].cpu().numpy()
    y_host = criteo_labels(n, SEED)
    tables = model._tables()
    before = {p: tables[p].detach().clone() for p in sparse}
    reset_counts()
    hist = model.fit(x_host, y_host, batch_size=BATCH, epochs=1, verbose=0)
    counts = read_counts()
    launches = {name: counts[name]
                for name in ("gather_rows", "scatter_add_rows", "row_update")}
    for name, count in launches.items():
        check(count == TRAIN_STEPS, "%s launched %d times in %d train steps"
              % (name, count, TRAIN_STEPS))
    loss = hist.history["loss"][-1]
    check(np.isfinite(loss), "train loss %r" % loss)
    with torch.no_grad():
        for p in sparse:
            col = model.feature_index[p.split("/")[-1]][0]
            touched = torch.zeros(tables[p].shape[0], dtype=torch.bool,
                                  device=X_all.device)
            touched[X_all[:n, col].long()] = True
            touched[0] = True
            changed = (tables[p] != before[p]).any(dim=1)
            check(torch.equal(changed, touched), "%s: the rows that changed "
                  "are not the rows the batches touched" % p)
    del before
    log("fit f32: %d steps of %d, sparse tables %s, launches %s, loss %r; "
        "in every sparse table exactly the touched rows (and row 0) "
        "changed" % (TRAIN_STEPS, BATCH, [p.split("/")[-1] for p in sparse],
                     launches, loss))
    return launches


def record_losses(model):
    """Per-step total losses of ``model``'s train steps, appended to the
    returned list."""
    losses = []
    step = model._train_step

    def recorded(X, y, sw):
        out = step(X, y, sw)
        losses.append(float(out[1]))
        return out
    model._train_step = recorded
    return losses


def phase_fit_card_vs_cpu(X_all):
    """The same train steps on the card and on the CPU, vocabularies
    capped so that the CPU run takes seconds."""
    pt.set_compute_dtype("float32")
    vocabs = [min(v, CAP_VOCAB) for v in CRITEO_KAGGLE_VOCABS]
    cols = ([pt.SparseFeat("C%d" % i, v, EMB_DIM)
             for i, v in enumerate(vocabs)]
            + [pt.DenseFeat("I%d" % i, 1) for i in range(N_DENSE)])
    n = BATCH * TRAIN_STEPS
    X = X_all[:n].clone()
    caps = torch.tensor(vocabs, dtype=torch.float32, device=X.device)
    X[:, :len(vocabs)] = torch.remainder(X[:, :len(vocabs)], caps)
    x_host = X.cpu().numpy()
    y_host = criteo_labels(n, SEED + 1)
    card = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                  seed=SEED, device=X_all.device)
    cpu = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                 seed=SEED, device="cpu")
    cpu.set_weights(card.get_weights())
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        model.compile("adagrad", "binary_crossentropy")
        sparse = sorted(p for p, _, _ in model._sparse_specs)
        check(sparse == EXPECTED_SPARSE, "%s: sparse tables %s"
              % (name, sparse))
        losses = record_losses(model)
        t0 = time.perf_counter()
        model.fit(x_host, y_host, batch_size=BATCH, epochs=1, verbose=0)
        runs[name] = (losses, model.get_weights(), time.perf_counter() - t0)
    (lc, wc, tc), (lp, wp, tp) = runs["card"], runs["cpu"]
    check(len(lc) == len(lp) == TRAIN_STEPS, "losses %s %s" % (lc, lp))
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    check(rel <= LOSS_RTOL, "card vs CPU: losses %s vs %s" % (lc, lp))
    worst, n_out, n_all = 0.0, 0, 0
    for k in wp:
        d = np.abs(wc[k] - wp[k])
        worst = max(worst, float(d.max()))
        n_out += int((d > WEIGHT_ATOL).sum())
        n_all += d.size
    lr = card._learning_rate
    check(worst <= 2 * lr * TRAIN_STEPS, "card vs CPU: a weight differs by "
          "%r" % worst)
    check(n_out <= WEIGHT_OUTLIER_SHARE * n_all, "card vs CPU: %d of %d "
          "weights differ by more than %r" % (n_out, n_all, WEIGHT_ATOL))
    log("fit card vs CPU (vocabularies capped at %d, %d steps): losses "
        "card %s cpu %s, max rel diff %r; weights max |dw| %r, %d of %d "
        "over %r; fit took %.2f s on the card, %.2f s on the CPU"
        % (CAP_VOCAB, TRAIN_STEPS, lc, lp, rel, worst, n_out, n_all,
           WEIGHT_ATOL, tc, tp))


def profile_ms(fn, label, top=8):
    """Device time of ``fn`` (torch.profiler, kernels only) in ms, or None
    where the profiler saw no kernel; logs the biggest kernels, the port's
    own, and the host's biggest ops, each line headed by ``label``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    total = sum(us for us, _, _ in rows)
    if total <= 0:
        log("%s profile: device time not measured (the profiler saw no "
            "kernel)" % label)
        return None
    for us, count, key in rows[:top] + [r for r in rows[top:]
                                        if any(k in r[2] for k in KERNELS)]:
        log("%s profile: %r ms in %d launches (%.1f%%) %s"
            % (label, us / 1e3, count, 100 * us / total, key[:90]))
    log("%s profile: %d kernel launches in all"
        % (label, sum(c for _, c, _ in rows)))
    host = sorted(((ev.self_cpu_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CPU), reverse=True)
    for us, count, key in host[:top]:
        log("%s profile, host: %r ms self time in %d calls %s"
            % (label, us / 1e3, count, key[:60]))
    return total / 1e3


def busy_line(busy_ms, wall_ms):
    """``device busy`` text for a run's profile: its busy ms beside the
    wall time and the idle share, or "not measured"."""
    if busy_ms is None:
        return "not measured (the profiler saw no kernel)"
    return "%r ms of %r ms, idle share %r" % (busy_ms, wall_ms,
                                              1 - busy_ms / wall_ms)


def k2_criteo_times(model, touched):
    """row_update at the Criteo shape (the touched rows of a batch of 4096
    in the 8 sparse tables, W=17), every optimizer: device ms and bounds;
    adagrad's plain version and per-call times too.  Returns adagrad's
    entry of the kernels line."""
    tables = model._tables()
    paths = [p for p, _, _ in model._sparse_specs]
    w = [tables[p].detach() for p in paths]
    l2s = [model._table_l2_vec(p) for p in paths]
    what = "Criteo (%d touched rows in %d slots of %d tables, W=%d)" % (
        sum(valid_counts(touched.rows, w)),
        sum(len(r) for r in touched.rows), len(paths), w[0].shape[1])
    one = torch.zeros(1, device=w[0].device)
    log("device_ms' floor: one launch of a one-element add_, %r ms with a "
        "cold L2, %r ms warm" % (device_ms(lambda: one.add_(1.0)),
                                 device_ms(lambda: one.add_(1.0),
                                           cold=False)))
    gen = torch.Generator(device=w[0].device).manual_seed(SEED + 9)
    for opt in OPTIMIZERS:
        states = ([model._table_state[p] for p in paths]
                  if opt == "adagrad" else k2_states(opt, w, gen))
        upd = (w, states, touched.grads, touched.rows, l2s, 0.01)
        times = k2_times(opt, upd, k2_bias(opt, len(paths), w[0].device))
        bounds = k2_bounds(opt, w, states, touched.rows)
        log(k2_line(opt, what, times, bounds))
        if opt != "adagrad":
            continue
        with torch.no_grad():
            plain_ms = device_ms(lambda: rowup.row_update_ref(opt, *upd))
            call_ms = {"kernel": time_ms(lambda: rowup.row_update(
                opt, *upd), reps=20), "plain": time_ms(
                lambda: rowup.row_update_ref(opt, *upd), reps=20)}
        entry = dict(ms=times["call cold"], plain_ms=plain_ms,
                     library_ms=None, bound_ms=bounds[0], bound_by="bytes",
                     sector_bound_ms=bounds[1])
        log("row_update (adagrad) at %s, device time, cold L2: kernel %r ms "
            "(earlier design: %r ms), plain %r ms, no library call; bound "
            "%r ms (bytes), %r ms (sectors); per call, host included: "
            "kernel %r, plain %r ms"
            % (what, times["call cold"], EARLIER_MS["row_update"], plain_ms,
               bounds[0], bounds[1], call_ms["kernel"], call_ms["plain"]))
    return entry


def phase_train_timing_bf16(model, X_all):
    log("timing on: %s" % card_line())
    pt.set_compute_dtype("bfloat16")
    model.compile("adagrad", "binary_crossentropy")
    n = BATCH * TRAIN_STEPS
    x_host = X_all[:n].cpu().numpy()
    y_host = criteo_labels(n, SEED + 2)

    def fit():
        model.fit(x_host, y_host, batch_size=BATCH, epochs=1, verbose=0)
    fit_ms = time_ms(fit, reps=1, runs=3)
    log("fit bf16, host numpy input: %r examples/s (%r ms for %d steps of "
        "%d)" % (n / fit_ms * 1e3, fit_ms, TRAIN_STEPS, BATCH))
    busy_ms = profile_ms(fit, "fit")
    if busy_ms is not None:
        log("fit bf16: device busy %r ms of %r ms, idle share %r"
            % (busy_ms, fit_ms, 1 - busy_ms / fit_ms))

    X = X_all[:BATCH].contiguous()
    out = {}
    with torch.no_grad():
        touched, grad, targets, idx = train_kernel_args(model, X, SEED + 7)
        width = grad.shape[2]
        groups = scatter_add._groups(targets)
        lib_args = [(t, idx[:, fs].reshape(-1).contiguous(),
                     grad[:, fs].reshape(-1, width).contiguous())
                    for t, fs in groups]
        timed = {
            "kernel": lambda: scatter_add.scatter_add_rows(
                grad, targets, idx),
            "plain": lambda: scatter_add.scatter_add_rows_ref(
                grad, targets, idx),
            # the library's scatter-add, one call per target
            "library": lambda: [t.index_add_(0, i, s)
                                for t, i, s in lib_args],
        }
        ms = {k: device_ms(fn) for k, fn in timed.items()}
        call_ms = {k: time_ms(fn, reps=20) for k, fn in timed.items()}
        # the sort and the two-level sums apart, each on its own launch
        meta = scatter_add.kernel_args(targets, X.device)
        total_rows = scatter_add.total_rows(targets)
        ws = scatter_add.workspace(idx.numel(), width, X.device)
        sort_ms = device_ms(lambda: scatter_add.launch(
            grad, idx, meta, total_rows, ws, part=1))
        alone_ms = device_ms(lambda: scatter_add.launch(
            grad, idx, meta, total_rows, ws, part=2))
        # bytes: the cotangent and the rows once, each target row read and
        # written once
        n_pairs = sum(int(torch.unique(i).numel()) for _, i, _ in lib_args)
        n_bytes = (grad.numel() * 4 + idx.numel() * 8
                   + 2 * n_pairs * width * 4)
        out["scatter_add_rows"] = dict(
            ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
            bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        log("scatter_add_rows at B=%d F=%d W=%d, device time, cold L2 "
            "(its sort included): kernel %r ms, plain %r ms, library "
            "(index_add_ per target) %r ms; bound %r ms (%d bytes: %d "
            "target rows); per call, host included: kernel %r, plain %r, "
            "library %r ms; apart: the sort %r ms, the two-level sums %r "
            "ms"
            % (grad.shape[0], grad.shape[1], width, ms["kernel"],
               ms["plain"], ms["library"], out["scatter_add_rows"]["bound_ms"],
               n_bytes, n_pairs, call_ms["kernel"], call_ms["plain"],
               call_ms["library"], sort_ms, alone_ms))

        out["row_update"] = k2_criteo_times(model, touched)
    return out


# ---------------------------------------------------------------------------
# the sequence models' serving path
# ---------------------------------------------------------------------------

def seq_lengths(n, gen, device, T=SEQ_MAXLEN):
    """History lengths uniform over [0, T], with 0, 1 and T among the
    first rows."""
    lengths = torch.randint(0, T + 1, (n,), generator=gen, device=device)
    lengths[:3] = torch.tensor([0, 1, T], device=device)
    return lengths


def gru_mask(B, T, masks, gen, device):
    """A [B, T] bool mask: ``"prefix"``, histories of lengths over [0, T]
    (0, 1 and T among the first rows), as DIEN's GRUs get them; ``"holes"``,
    the same histories with about 30% of their steps dropped inside them,
    row 3 valid at every step and row 0 at none, so that one batch holds
    holes, trailing padding, an empty row and a full-length row."""
    lengths = seq_lengths(B, gen, device, T)
    mask = torch.arange(T, device=device)[None, :] < lengths[:, None]
    if masks == "holes":
        mask &= torch.rand(B, T, generator=gen, device=device) < 0.7
        mask[min(3, B - 1)] = True
        mask[0] = False
    return mask


def gru_inputs(B, mode, dtype, seed, device, T=SEQ_MAXLEN, H=SEQ_H,
               masks="prefix"):
    """``gru_scan``'s arguments as DIEN's GRUs give them (at maxlen 100 and
    H=64 by default): gi a [T, B, 3H] view of a [B, T, 3H] product,
    weights rounded to ``dtype`` and held in float32, a bool mask
    (``gru_mask``).  The weights are at std 0.3 at H=64 and at
    0.3 * sqrt(64 / H) otherwise, the same scale of h @ W_hh^T: at std 0.3
    and H=256 the recurrence is chaotic, and the float32 plain version
    itself ends 0.22 away from a float64 one after 50 steps."""
    gen = torch.Generator(device=device).manual_seed(seed)
    std = SEQ_STD * (SEQ_H / H) ** 0.5
    gi = torch.randn(B, T, 3 * H, generator=gen, device=device).to(
        dtype).transpose(0, 1)
    whh_t = (std * torch.randn(H, 3 * H, generator=gen,
                               device=device)).to(dtype).float()
    bhh = (std * torch.randn(3 * H, generator=gen,
                             device=device)).to(dtype).float()
    mask = gru_mask(B, T, masks, gen, device)
    att = (None if mode == "gru" else
           torch.rand(B, T, generator=gen, device=device).to(dtype))
    return gi, whh_t, bhh, mask, att


def attention_inputs(B, dtype, seed, device, T=SEQ_MAXLEN, E=SEQ_H,
                     hidden=SEQ_ATT, masks="prefix"):
    """``din_attention_fused``'s arguments (at E=64, T=100 and layers
    256-64-16-1 by default), the mask as ``gru_mask`` draws it (lengths
    over [0, T], an empty and a full row; with ``"holes"`` steps dropped
    inside the histories), and each row's count of valid steps; the query,
    the keys and every weight and bias at std 0.3."""
    gen = torch.Generator(device=device).manual_seed(seed)
    query = SEQ_STD * torch.randn(B, 1, E, generator=gen, device=device)
    keys = (SEQ_STD * torch.randn(B, T, E, generator=gen,
                                  device=device)).to(dtype)
    mask = gru_mask(B, T, masks, gen, device)
    lengths = mask.sum(dim=1)
    widths = (4 * E,) + tuple(hidden) + (1,)
    layers = [(SEQ_STD * torch.randn(i, o, generator=gen, device=device),
               SEQ_STD * torch.randn(o, generator=gen, device=device))
              for i, o in zip(widths[:-1], widths[1:])]
    return query, keys, mask, layers, lengths


def attention_f64(q, k, m, layers, act, wnorm):
    """The attention readout evaluated in float64, and sum_t |s_t| * |k_t|
    [B, 1, E], the magnitude of the terms it sums."""
    f64 = torch.float64
    B, T, E = k.shape
    qb, kk = q.to(f64).expand(B, T, E), k.to(f64)
    x = torch.cat([qb, kk, qb - kk, qb * kk], dim=-1)
    fn = {"sigmoid": torch.sigmoid, "relu": torch.relu,
          "linear": lambda v: v}[act]
    for w, b in layers[:-1]:
        x = fn(x @ w.to(f64) + b.to(f64))
    s = (x @ layers[-1][0].to(f64) + layers[-1][1].to(f64))[..., 0]
    mm = m.to(f64)
    s = (torch.softmax(s * mm + (1.0 - mm) * attention.NEG, dim=-1)
         if wnorm else s * mm)
    out = torch.einsum("bt,bte->be", s, kk)[:, None, :]
    return out, torch.einsum("bt,bte->be", s.abs(), kk.abs())[:, None, :]


def check_attention_f32(got, want, truth, scale, what):
    """The float32 kernel and plain version against the float64 truth,
    relative to max(1, scale): the kernel within KERNEL_F32_ATOL, or within
    twice the plain version's error where that is larger.  Returns the
    kernel's relative error and max |got - want|."""
    scale = scale.clamp_min(1.0)
    err = ((got.double() - truth).abs() / scale).max().item()
    plain = ((want.double() - truth).abs() / scale).max().item()
    tol = max(KERNEL_F32_ATOL, 2.0 * plain)
    check(bool(torch.isfinite(got).all()), "%s: non-finite output" % what)
    check(err <= tol, "%s: max |kernel - float64| / max(1, sum_t |s_t k_t|)"
          " = %r > %r (the plain version's: %r)" % (what, err, tol, plain))
    return err, plain, (got - want).abs().max().item()


def compare(got, want, what, scale=None):
    """A float32 pair: max |got - want| / max(1, scale), checked against
    KERNEL_F32_ATOL, and max |got - want|; ``scale`` is |want| unless
    given.  A bfloat16 pair: the max in bf16 ulps of the larger magnitude
    over the elements outside that float32 tolerance, checked to one ulp,
    and max |got - want|."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          "%s: %s %s vs plain %s %s" % (what, got.dtype, tuple(got.shape),
                                        want.dtype, tuple(want.shape)))
    a, b = got.float(), want.float()
    check(bool(torch.isfinite(a).all()), "%s: non-finite output" % what)
    diff = (a - b).abs()
    scaled = diff / (b.abs() if scale is None else scale).clamp_min(1.0)
    if got.dtype == torch.float32:
        err = scaled.max().item()
        check(err <= KERNEL_F32_ATOL, "%s: max |kernel - plain| / max(1, "
              "scale) = %r > %r" % (what, err, KERNEL_F32_ATOL))
        return err, diff.max().item()
    mag = torch.maximum(a.abs(), b.abs())
    ulps = diff / torch.exp2(torch.floor(torch.log2(
        mag.clamp_min(2.0 ** -126))) - 7)
    ulps = torch.where(scaled <= KERNEL_F32_ATOL, torch.zeros_like(ulps),
                       ulps)
    worst = ulps.max().item()
    check(worst <= 1.0, "%s: %d outputs more than one bf16 ulp from the "
          "plain version (max %r ulps)" % (what, int((ulps > 1).sum()),
                                           worst))
    return worst, diff.max().item()


def check_gru_case(B, mode, dtype, seed, device, T=SEQ_MAXLEN, H=SEQ_H,
                   masks="prefix"):
    """One gru_scan case against its plain version; returns the largest
    |kernel - plain|."""
    args = gru_inputs(B, mode, dtype, seed, device, T, H, masks)
    outs, h_last = gru.gru_scan(*args[:4], att=args[4], mode=mode)
    ref_outs, ref_h = gru.gru_scan_ref(*args[:4], att=args[4], mode=mode)
    torch.cuda.synchronize()
    what = "gru_scan %s %s B=%d T=%d H=%d %s masks" % (mode, dtype, B, T, H,
                                                     masks)
    e1, a1 = compare(outs, ref_outs, what + " outs")
    e2, a2 = compare(h_last, ref_h, what + " h_last")
    mask = args[3]
    check(bool((outs[~mask.t()] == 0).all()), what + ": a padded step "
          "emitted a non-zero row")
    check(bool((h_last[gru.last_valid_steps(mask) < 0] == 0).all()),
          what + ": an empty history left a non-zero state")
    log("kernel vs plain: %s: outs %s %r, h_last %r; max |err| %r, %r"
        % (what, "max |err| / max(1, |plain|)" if dtype == torch.float32
           else "max bf16 ulps", e1, e2, a1, a2))
    return max(a1, a2)


def check_attention_case(act, wnorm, dtype, seed, device, B=SEQ_BATCH,
                         T=SEQ_MAXLEN, E=SEQ_H, hidden=SEQ_ATT,
                         masks="prefix"):
    """One din_attention_fused case against its plain version; returns the
    largest |kernel - plain|."""
    q, k, m, layers, lengths = attention_inputs(B, dtype, seed, device, T, E,
                                                hidden, masks)
    got = attention.din_attention_fused(q, k, m, layers, act, wnorm)
    want = attention.din_attention_fused_ref(q, k, m, layers, act, wnorm)
    torch.cuda.synchronize()
    what = ("din_attention (%s design) %s wnorm=%s %s B=%d T=%d E=%d layers "
            "%s, %s masks" % (attention.route(E, tuple(hidden) + (1,), dtype),
                              act,
                              wnorm, dtype, B, T, E, hidden, masks))
    if not wnorm:
        check(bool((got[lengths == 0] == 0).all()),
              what + ": an empty history gave a non-zero readout")
    truth, scale = attention_f64(q, k, m, layers, act, wnorm)
    if dtype == torch.float32:
        e, p, a = check_attention_f32(got, want, truth, scale, what)
        log("kernel vs plain: %s: max |err vs float64| / max(1, sum_t "
            "|s_t k_t|) %r (plain version %r); max |kernel - plain| %r"
            % (what, e, p, a))
    else:
        # the bf16 pair are float32 results each within the float32
        # tolerance of sum_t |s_t k_t|, rounded once
        e, a = compare(got, want, what, scale)
        log("kernel vs plain: %s: max bf16 ulps %r; max |err| %r"
            % (what, e, a))
    return a


def check_attention_layer(device, shape, seed):
    """AttentionSequencePoolingLayer at ``shape`` on the card: inference
    takes the fused kernel (one launch), which agrees with the plain
    version of the layer's readout."""
    w = dict(dict(B=SEQ_BATCH, T=SEQ_MAXLEN, E=SEQ_H), **shape)
    layer = AttentionSequencePoolingLayer(
        att_hidden_units=w["hidden"], att_activation="relu",
        weight_normalization=True, embedding_dim=w["E"], device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, m, _, lengths = attention_inputs(w["B"], torch.float32, seed + 1,
                                           device, w["T"], w["E"],
                                           w["hidden"])
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, SEQ_STD, generator=gen)
        attention.DIN_ATTENTION_LAUNCHES = 0
        got = layer(q, k, keys_length=lengths)
        launches = attention.DIN_ATTENTION_LAUNCHES
        lau = layer.local_att
        dense = [getattr(lau.dnn, "dense_%d" % i)
                 for i in range(len(w["hidden"]))] + [lau.dense]
        params = [(d.weight.t(), d.bias) for d in dense]
        want = attention.din_attention_fused_ref(q, k, m, params, "relu",
                                                 True)
        truth, scale = attention_f64(q, k, m, params, "relu", True)
    what = ("AttentionSequencePoolingLayer (%s design) relu, softmax, B=%d "
            "T=%d E=%d layers %s" % (
                attention.route(w["E"], tuple(w["hidden"]) + (1,)), w["B"],
                w["T"], w["E"], w["hidden"]))
    check(launches == 1, "%s: the fused kernel launched %d times, want 1"
          % (what, launches))
    e, p, a = check_attention_f32(got, want, truth, scale, what)
    log("kernel vs plain: %s through the layer's dispatch (1 launch): max "
        "|err vs float64| / max(1, sum_t |s_t k_t|) %r (plain version %r); "
        "max |kernel - plain| %r" % (what, e, p, a))


def phase_seq_kernels_vs_plain(device):
    """gru_scan and din_attention_fused against their plain versions at
    the slice's shapes, and at the wide shapes (WIDE_GRU, WIDE_ATT) that
    take the kernels' other sizes; returns the largest float32 |kernel -
    plain| of each at the slice's shapes."""
    errs = {"gru_scan": 0.0, "din_attention": 0.0}
    seed = SEED + 20
    dtypes = (torch.float32, torch.bfloat16)
    att_shapes = ({}, dict(B=1000, masks="holes"), ODD_ATT, LONG_ATT,
                  WINDOW_ATT, DEFAULT_ATT, TOP_ATT, ONE_ATT, THREE_ATT,
                  WIDE_ATT)
    with torch.no_grad():
        for B in (SEQ_BATCH, 1000):
            for masks in GRU_MASKS:
                for mode in gru.MODES:
                    for dtype in dtypes:
                        seed += 1
                        a = check_gru_case(B, mode, dtype, seed, device,
                                           masks=masks)
                        if dtype == torch.float32:
                            errs["gru_scan"] = max(errs["gru_scan"], a)
        for shape in (WIDE_GRU, ODD_GRU):
            for mode in gru.MODES:
                for dtype in dtypes:
                    seed += 1
                    check_gru_case(shape["B"], mode, dtype, seed, device,
                                   T=shape["T"], H=shape["H"],
                                   masks="holes")
        for shape in att_shapes:
            for act in attention.ACTIVATIONS:
                for wnorm in (False, True):
                    for dtype in dtypes:
                        seed += 1
                        a = check_attention_case(act, wnorm, dtype, seed,
                                                 device, **shape)
                        if dtype == torch.float32 and not shape:
                            errs["din_attention"] = max(
                                errs["din_attention"], a)
    routes = {attention.route(shape.get("E", SEQ_H),
                              tuple(shape.get("hidden", SEQ_ATT)) + (1,),
                              dtype)
              for shape in att_shapes for dtype in dtypes}
    check(routes == {"mma8", "mma16", "fma"}, "phase 9's attention shapes "
          "took the designs %s, want both tensor-core instances and the "
          "FMA design" % sorted(routes))
    check_attention_layer(device, WIDE_ATT, SEED + 70)
    check_attention_layer(device, DEFAULT_ATT, SEED + 72)
    return errs


def seq_columns(use_neg):
    """The sequence bench's columns (tools/seq_train_bench.py:40-64)."""
    feat = pt.SparseFeat
    cols = [feat(name, vocab, SEQ_EMB) for name, vocab in SEQ_VOCABS.items()]
    cols.append(pt.DenseFeat("pay_score", 1))
    prefixes = ("hist_", "neg_hist_") if use_neg else ("hist_",)
    for prefix in prefixes:
        for name in ("item_id", "cate_id"):
            cols.append(pt.VarLenSparseFeat(
                feat(prefix + name, SEQ_VOCABS[name], SEQ_EMB,
                     embedding_name=name),
                maxlen=SEQ_MAXLEN, length_name="seq_length"))
    return cols


def seq_requests(model, n, seed, device):
    """A flat [n, input_dim] float32 batch of the bench's data
    (tools/seq_train_bench.py:67-80) with history lengths over [0, 100]."""
    rng = np.random.default_rng(seed)
    T = SEQ_MAXLEN
    x = {"user": rng.integers(0, SEQ_VOCABS["user"], n),
         "pay_score": rng.random(n),
         "seq_length": rng.integers(0, T + 1, n)}
    x["seq_length"][:3] = [0, 1, T]
    for name in ("item_id", "cate_id"):
        x[name] = rng.integers(1, SEQ_VOCABS[name], n)
        for prefix in ("hist_", "neg_hist_"):
            x[prefix + name] = rng.integers(1, SEQ_VOCABS[name], (n, T))
    return torch.from_numpy(model._assemble_x(x)).to(device)


def seq_model(kind, variant, device):
    """DIEN (``variant`` its gru_type; AUGRU with negative sampling, as
    bench.py runs it) or DIN (``variant`` its att_activation) at the bench
    width.  Every weight is redrawn from normal(0.3), seeded, but the
    prediction tower's (``dnn``, ``dnn_linear``) at 1/sqrt(fan_in), so that
    no float32 sigmoid saturates to exactly 1; Dice's running mean from
    normal(0.3), its variance from uniform[0.5, 1.5)."""
    if kind == "dien":
        neg = variant == "AUGRU"
        model = DIEN(seq_columns(neg), ["item_id", "cate_id"],
                     gru_type=variant, use_negsampling=neg,
                     dnn_hidden_units=SEQ_HIDDEN, att_hidden_units=SEQ_ATT,
                     seed=SEED, device=device)
    else:
        model = DIN(seq_columns(False), ["item_id", "cate_id"],
                    dnn_hidden_units=SEQ_HIDDEN, att_hidden_size=SEQ_ATT,
                    att_activation=variant, seed=SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    with torch.no_grad():
        for name, p in model.named_parameters():
            tower = name.startswith(("dnn.", "dnn_linear.")) and p.dim() == 2
            p.normal_(0.0, p.shape[1] ** -0.5 if tower else SEQ_STD,
                      generator=gen)
        for name, b in model.named_buffers():
            if name.endswith("bn.mean"):
                b.normal_(0.0, SEQ_STD, generator=gen)
            elif name.endswith("bn.var"):
                b.uniform_(0.5, 1.5, generator=gen)
    return model


def phase_seq_predict_f32(kind, variant, per_batch, device):
    """predict at float32 over SEQ_BATCHES batches: the launches of each
    kernel a batch (``per_batch``), the predictions, and the first batch
    against the same model on the CPU.  Returns the launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_compute_dtype("float32")
    model = seq_model(kind, variant, device)
    n = SEQ_BATCH * SEQ_BATCHES
    X = seq_requests(model, n, SEED + 40, device)
    reset_counts()
    pred = model.predict(X, batch_size=SEQ_BATCH)
    launches = read_counts()
    label = "%s %s" % (kind.upper(), variant)
    for name, count in dict(per_batch, gather_rows=1).items():
        check(launches[name] == count * SEQ_BATCHES, "%s: %s launched %d "
              "times in %d batches, want %d a batch" % (
                  label, name, launches[name], SEQ_BATCHES, count))
    check_predictions(pred, n)
    model.to("cpu")
    try:
        pred_cpu = model.predict(X[:SEQ_BATCH].cpu(), batch_size=SEQ_BATCH)
    finally:
        model.to(device)
    diff = float(np.abs(pred[:SEQ_BATCH] - pred_cpu).max())
    check(diff <= ATOL_CPU, "%s: card vs CPU max |dp| %r > %r"
          % (label, diff, ATOL_CPU))
    log("predict f32 %s: %d requests in %d batches, launches %s, "
        "predictions in [%.6f, %.6f], std %.6f; first batch vs CPU max |dp| "
        "= %r (atol %r)" % (label, n, SEQ_BATCHES, launches, pred.min(),
                            pred.max(), pred.std(), diff, ATOL_CPU))
    return launches


def block_steps_line(mask):
    """The steps the GRU kernels' blocks of 8 rows walk (H <= 64): each
    block's largest last valid step + 1, its mean and its most (the
    kernel's serial length), over the rows of ``mask``."""
    last = gru.last_valid_steps(mask)
    pad = (-last.numel()) % 8
    last = torch.cat([last, last.new_full((pad,), -1)])
    steps = last.reshape(-1, 8).amax(dim=1) + 1
    return "blocks of 8 rows walk %r steps on average, %d at most" % (
        steps.float().mean().item(), int(steps.max()))


def gru_bound(args, flop_rate):
    """(ms, "operations" or "bytes") for gru_scan on ``args``: the h @ W_hh
    products of the steps inside each history (the steps past it need no
    arithmetic) at ``flop_rate``, against their gates read once, the
    [T, B, H] outputs and h_last written once, the mask, W_hh and b_hh."""
    gi, whh_t, bhh, mask, att = args
    T, B, H3 = gi.shape
    H = H3 // 3
    valid = int(mask.sum())
    size = gi.element_size()
    flops = 2 * valid * H * H3
    n_bytes = (valid * H3 * size + T * B * H * size + B * H * size
               + mask.numel() * mask.element_size() + 4 * (H * H3 + H3)
               + (0 if att is None else att.numel() * att.element_size()))
    return bound(n_bytes, flops, flop_rate)


def attention_bound(q, k, m, layers, lengths, wnorm,
                    flop_rate=F32_FLOP_PER_S, products=(1, 1)):
    """(ms, bound) for din_attention_fused, counting what the function
    needs, at ``flop_rate``, each multiply-add of the first layer's key
    product counted ``products[0]`` times and every other one
    ``products[1]`` times (the TF32 split of the tensor-core design: 2 and
    3 at bfloat16 keys, 3 and 3 at float32).  Operations: per sample
    with a valid step, the query's part of the first layer and the fold
    of q into its key weights (2 E n1 multiply-adds, since [q, k, q - k, q * k] W_0 = q (A + C) + k (B - C +
    diag(q) D)); per valid step, E n1 for the first layer, the later layers
    and E for the weighted sum; a step past the history needs no MLP, and
    an empty history reads as zeros (no softmax) or the mean of its T keys
    (softmax).  Bytes: the keys those read, the query, the mask, the
    weights and the [B, 1, E] result."""
    B, T, E = k.shape
    n1 = layers[0][0].shape[1]
    later = sum(w.shape[0] * w.shape[1] for w, _ in layers[1:])
    valid = int(lengths.sum())
    rows = int((lengths > 0).sum())
    flops = 2 * (products[0] * valid * E * n1 + products[1] * (
        rows * 2 * E * n1 + valid * (later + E)))
    steps_read = valid
    if wnorm:
        flops += products[1] * (B - rows) * T * E
        steps_read += (B - rows) * T
    n_bytes = (steps_read * E * k.element_size()
               + q.numel() * q.element_size() + m.numel() * m.element_size()
               + 4 * sum(w.numel() + b.numel() for w, b in layers)
               + B * E * k.element_size())
    return bound(n_bytes, flops, flop_rate)


def bound(n_bytes, flops, flop_rate=F32_FLOP_PER_S):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flop_rate * 1e3
    return ((by_ops, "operations") if by_ops >= by_bytes
            else (by_bytes, "bytes"))


def gather_bytes(X, tables, cols):
    """The bytes gather_rows must move: the id of every (b, f), every row
    the ids touch once (a table shared by several fields counts its rows
    once), the [B, F, W] output."""
    ids = {}
    for t, c in zip(tables, cols):
        ids.setdefault(t.data_ptr(), []).append(
            X[:, c].to(torch.int32).to(torch.int64))
    unique_rows = sum(int(torch.unique(torch.cat(v)).numel())
                      for v in ids.values())
    B, F, W = X.shape[0], len(tables), tables[0].shape[1]
    return 4 * B * F + 4 * W * unique_rows + 4 * B * F * W, unique_rows


def seq_gather_fields(model, neg):
    """The tables and id columns of the sequence model's one gather
    launch, as ``EmbeddingDict.gather`` builds them: predict's fields, and
    with ``neg`` a training forward's (the ``neg_hist_*`` spans too)."""
    tables, cols = [], []
    for fc in model._shared_columns:
        if fc.name.startswith("neg_") and not neg:
            continue
        start, end = model.feature_index[fc.name]
        if not isinstance(fc, pt.VarLenSparseFeat):
            end = start + 1
        tables += [model.embedding_dict.tables[fc.embedding_name]] * (
            end - start)
        cols += range(start, end)
    check(len({t.shape[1] for t in tables}) == 1, "the sequence model's "
          "gather has more than one row width")
    return tables, cols


def seq_gather_times(device):
    """gather_rows at the sequence paths' shape: DIEN AUGRU+neg's columns
    at B=SEQ_BATCH, predict's fields and a training forward's, device ms
    with a cold L2 beside the bytes bound.  Returns {fields: (ms,
    bound_ms)}."""
    model = seq_model("dien", "AUGRU", device)
    X = seq_requests(model, SEQ_BATCH, SEED + 55, device)
    out = {}
    with torch.no_grad():
        for neg in (False, True):
            tables, cols = seq_gather_fields(model, neg)
            args = gather.GatherArgs()
            ms = device_ms(lambda: gather.gather_rows(X, tables, cols,
                                                      args=args))
            n_bytes, unique_rows = gather_bytes(X, tables, cols)
            bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            out[len(cols)] = (ms, bound_ms)
            log("gather_rows at the sequence shape (%s), B=%d F=%d W=%d: "
                "kernel %r ms, device time, cold L2 (earlier design: %r ms); "
                "bound %r ms (%d bytes: %d unique rows, %d output bytes), "
                "%.3gx the bound" % (
                    "a training forward" if neg else "predict", X.shape[0],
                    len(cols), tables[0].shape[1], ms,
                    EARLIER_MS["gather_rows_seq_%d" % len(cols)], bound_ms,
                    n_bytes, unique_rows,
                    4 * X.shape[0] * len(cols) * tables[0].shape[1],
                    ms / bound_ms))
    del model, X
    return out


def attention_length_times(device):
    """K4 at bf16, relu with softmax, B=SEQ_BATCH, T=SEQ_MAXLEN, E=SEQ_H:
    device ms with a cold L2 at every length 0, at every length T and at
    lengths uniform over [0, T]; they split a sample's fixed cost from the
    cost of a valid step."""
    q, k, m, layers, lengths = attention_inputs(SEQ_BATCH, torch.bfloat16,
                                                SEED + 62, device)
    packed = attention.pack_params(layers)
    out = {}
    with torch.no_grad():
        for label, mm in (("lengths 0", torch.zeros_like(m)),
                          ("lengths %d" % SEQ_MAXLEN, torch.ones_like(m)),
                          ("uniform lengths", m)):
            out[label] = device_ms(lambda: attention.din_attention_fused(
                q, k, mm, layers, "relu", True, packed=packed))
    log("din_attention (relu, softmax) at B=%d T=%d E=%d, bf16 keys, device "
        "time, cold L2: %s" % (SEQ_BATCH, SEQ_MAXLEN, SEQ_H, ", ".join(
            "%r ms at %s" % (v, k_) for k_, v in out.items())))
    return out


def phase_seq_timing_bf16(device):
    """DIN and DIEN predict at bf16 compute (examples/s, idle share), and
    both sequence kernels against their plain versions in device ms."""
    log("timing on: %s" % card_line())
    pt.set_compute_dtype("bfloat16")
    n = SEQ_BATCH * SEQ_BATCHES
    for kind, variant in (("din", "dice"), ("din", "sigmoid"),
                          ("dien", "GRU"), ("dien", "AUGRU")):
        model = seq_model(kind, variant, device)
        X = seq_requests(model, n, SEED + 50, device)
        label = "%s %s" % (kind.upper(), variant)
        check_predictions(model.predict(X, batch_size=SEQ_BATCH), n)
        run_ms = time_ms(lambda: model.predict(X, batch_size=SEQ_BATCH),
                         reps=1, runs=5)
        busy_ms = profile_ms(lambda: model.predict(X, batch_size=SEQ_BATCH),
                             "predict %s" % label, top=5)
        log("predict bf16 %s, device input: %r examples/s (%r ms for %d); "
            "device busy %s" % (label, n / run_ms * 1e3, run_ms, n,
                                busy_line(busy_ms, run_ms)))
        del model, X

    out = {}
    with torch.no_grad():
        # float32 weights and a bool mask, as the layer keeps them: the
        # window holds the kernel's launch and its outputs' allocation
        args = gru_inputs(SEQ_BATCH, "gru", torch.bfloat16, SEED + 60,
                          device)
        gi = args[0]
        H = SEQ_H
        # the library's GRU (cuDNN where it takes the type) over the [B, T,
        # H] inputs that DIEN's GRUs read, every row at its full length;
        # it projects its inputs itself and keeps no mask
        lib_gru = torch.nn.GRU(H, H, batch_first=True).to(device,
                                                          torch.bfloat16)
        lib_gru.flatten_parameters()
        x = torch.randn(SEQ_BATCH, SEQ_MAXLEN, H, device=device,
                        dtype=torch.bfloat16)
        timed = {
            "kernel": lambda: gru.gru_scan(*args[:4], mode="gru"),
            "plain": lambda: gru.gru_scan_ref(*args[:4], mode="gru"),
            "library": lambda: lib_gru(x),
        }
        ms = {k: device_ms(fn) for k, fn in timed.items()}
        # the bound at the rate of the units the kernel uses (TF32 tensor
        # cores, three products a multiply-add), beside the float32 FMA one
        bound_ms, bound_by = gru_bound(
            args, TF32_FLOP_PER_S / GRU_TF32_PRODUCTS)
        f32_ms, f32_by = gru_bound(args, F32_FLOP_PER_S)
        out["gru_scan"] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                               library_ms=ms["library"], bound_ms=bound_ms,
                               bound_by=bound_by)
        log("gru_scan (gru) at T=%d B=%d H=%d, bf16 storage, %d steps "
            "inside the histories, %s; device time, cold L2: kernel %r ms "
            "(earlier design: %r ms), plain %r ms, library (torch.nn.GRU, "
            "full length, its own input projection) %r ms; bound %r ms "
            "(%s; at the TF32 tensor rate, 3 products a multiply-add), %r "
            "ms (%s) "
            "at the float32 FMA rate"
            % (gi.shape[0], gi.shape[1], H, int(args[3].sum()),
               block_steps_line(args[3]), ms["kernel"],
               EARLIER_MS["gru_scan"], ms["plain"], ms["library"], bound_ms,
               bound_by, f32_ms, f32_by))

        q, k, m, layers, lengths = attention_inputs(SEQ_BATCH, torch.bfloat16,
                                                    SEED + 61, device)
        # the weights packed once, as the layer keeps them: the window
        # holds the kernel's launch and its output's allocation
        packed = attention.pack_params(layers)
        timed = {
            "kernel": lambda: attention.din_attention_fused(
                q, k, m, layers, "relu", True, packed=packed),
            "plain": lambda: attention.din_attention_fused_ref(
                q, k, m, layers, "relu", True),
        }
        ms = {k_: device_ms(fn) for k_, fn in timed.items()}
        # the bound at the units the kernel uses (TF32 tensor cores: the
        # first layer's key product 2 products a multiply-add at bf16 keys,
        # the rest 3), beside the float32 FMA one
        bound_ms, bound_by = attention_bound(q, k, m, layers, lengths, True,
                                             TF32_FLOP_PER_S, (2, 3))
        f32_ms, f32_by = attention_bound(q, k, m, layers, lengths, True)
        out["din_attention"] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                                    library_ms=None, bound_ms=bound_ms,
                                    bound_by=bound_by)
        log("din_attention (%s design; relu, softmax) at B=%d T=%d E=%d, "
            "bf16 keys, %d valid steps, device time, cold L2: kernel %r ms "
            "(earlier design: %r ms), plain %r ms, no library call; bound %r "
            "ms (%s; at the TF32 tensor rate, 2-3 products a multiply-add), "
            "%r ms (%s) at the float32 FMA rate" % (
                attention.route(SEQ_H, SEQ_ATT + (1,), torch.bfloat16),
                SEQ_BATCH,
                SEQ_MAXLEN, SEQ_H, int(lengths.sum()), ms["kernel"],
                EARLIER_MS["din_attention"], ms["plain"], bound_ms, bound_by,
                f32_ms, f32_by))
    attention_length_times(device)
    seq_gather_times(device)
    return out


# ---------------------------------------------------------------------------
# the sequence models' training path
# ---------------------------------------------------------------------------

def bits_equal(a, b):
    """The same shape, dtype and bits (NaNs and signed zeros included)."""
    if a is None or b is None:
        return a is None and b is None
    ints = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(ints),
                            b.contiguous().view(ints)))


def bwd_inputs(B, mode, dtype, seed, device, T=SEQ_MAXLEN, H=SEQ_H,
               masks="prefix"):
    """``gru_inputs`` and the cotangents of outs ([T, B, H], a view of a
    [B, T, H], as the layers hand it back) and h_last, normal from the
    seed, in the storage type."""
    args = gru_inputs(B, mode, dtype, seed, device, T, H, masks)
    gen = torch.Generator(device=device).manual_seed(seed + 1000)
    douts = torch.randn(B, T, H, generator=gen, device=device).to(
        dtype).transpose(0, 1)
    dh_last = torch.randn(B, H, generator=gen, device=device).to(dtype)
    return args, douts, dh_last


def gru_bwd_scales(args, carry, dgi):
    """The magnitudes of the terms the backward's sums add up: for dW_hh
    and db_hh the sums over (t, b) of |carry| |d_gh| and of |d_gh|, with
    d_gh = [d_pre_r, d_pre_z, d_pre_n * r] from dgi; for d(att) [B, T] the
    sum over the H units of |du| (agru) or |du z| (augru), which is
    |d_pre_n| |n - h| / (a (1 - n^2)) in both modes; r and n recomputed
    from the carries.  None for d(att) in mode gru."""
    gi, whh_t, bhh, _, att = args
    T, B, H3 = gi.shape
    H = H3 // 3
    h = carry.float().reshape(T * B, H)
    g = gi.float().reshape(T * B, H3)
    gh = h @ whh_t + bhh
    r = torch.sigmoid(g[:, :H] + gh[:, :H])
    n = torch.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
    d = dgi.float().reshape(T * B, H3).clone()
    scale_a = None
    if att is not None:
        a = att.float().t().reshape(T * B, 1)
        terms = torch.nan_to_num(d[:, 2 * H:].abs() * (n - h).abs()
                                 / (a * (1.0 - n * n)), nan=0.0, posinf=0.0)
        scale_a = terms.sum(dim=1).reshape(T, B).t()
    d[:, 2 * H:] *= r
    d = d.abs()
    return h.abs().t() @ d, d.sum(dim=0), scale_a


def check_gru_bwd_case(B, mode, dtype, seed, device, T=SEQ_MAXLEN, H=SEQ_H,
                       masks="prefix"):
    """The carry-saving forward and gru_scan_bwd against their plain
    versions, with the output cotangents given and absent; returns the
    largest |kernel - plain| of the backward's outputs."""
    args, douts, dh_last = bwd_inputs(B, mode, dtype, seed, device, T, H,
                                      masks)
    gi, whh_t, bhh, mask, att = args
    what = "gru_scan_bwd %s %s B=%d T=%d H=%d %s masks" % (mode, dtype, B, T,
                                                         H, masks)
    outs0, h0 = gru.gru_scan(gi, whh_t, bhh, mask, att=att, mode=mode)
    outs, h_last, carry = gru.gru_scan_with_carry(gi, whh_t, bhh, mask,
                                                  att=att, mode=mode)
    ref_carry = gru.gru_scan_ref(gi, whh_t, bhh, mask, att=att, mode=mode,
                                 save_carry=True)[2]
    bwd = (gi, carry, whh_t, bhh, mask, att)
    got = gru.gru_scan_bwd(*bwd, douts, dh_last, mode)
    again = gru.gru_scan_bwd(*bwd, douts, dh_last, mode)
    bare = gru.gru_scan_bwd(*bwd, None, None, mode)
    want = gru.gru_scan_bwd_ref(*bwd, douts, dh_last, mode)
    want_bare = gru.gru_scan_bwd_ref(*bwd, None, None, mode)
    torch.cuda.synchronize()
    check(bits_equal(outs, outs0) and bits_equal(h_last, h0),
          what + ": the carry-saving forward's outputs differ from the "
          "inference forward's")
    ec, _ = compare(carry, ref_carry, what + " carry")
    check(all(bits_equal(a, b) for a, b in zip(got, again)),
          what + ": a repeat launch gave other bits")
    pad = ~mask.t()
    worst, errs = 0.0, []
    for label, k, r in (("", got, want), (" (no cotangents)", bare,
                                          want_bare)):
        dgi, dwhh, dbhh, datt = k
        check(bool((dgi[pad] == 0).all()), what + label + ": a padded step "
              "has a non-zero dgi row")
        scale_w, scale_b, scale_a = gru_bwd_scales(args, carry, r[0])
        for name, a, b, scale in (("dgi", dgi, r[0], None),
                                  ("dwhh", dwhh, r[1], scale_w),
                                  ("dbhh", dbhh, r[2], scale_b),
                                  ("datt", datt, r[3], scale_a)):
            if a is None:
                check(b is None, what + ": no datt")
                continue
            e, m = compare(a, b, what + label + " " + name, scale)
            errs.append("%s%s %r" % (name, label, e))
            worst = max(worst, m)
        if datt is not None:
            check(bool((datt[pad.t()] == 0).all()), what + label + ": a "
                  "padded step has a non-zero d(att)")
    log("kernel vs plain: %s: carry %r; %s (dgi: %s; dW_hh, db_hh, d(att) "
        "relative to the sum of their terms' magnitudes, at least 1); max "
        "|err| %r; "
        "repeat bit-equal, padded steps zero, the carry-saving forward "
        "bit-equal to the inference forward"
        % (what, ec, ", ".join(errs), "max |err| / max(1, |plain|)"
           if dtype == torch.float32 else "max bf16 ulps", worst))
    return worst


def phase_gru_bwd_vs_plain(device):
    """gru_scan_bwd against gru_scan_bwd_ref at the shapes of phase 9;
    returns the largest float32 |kernel - plain| at the slice's shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    err = 0.0
    seed = SEED + 200
    with torch.no_grad():
        for B in (SEQ_BATCH, 1000):
            for masks in GRU_MASKS:
                for mode in gru.MODES:
                    for dtype in (torch.float32, torch.bfloat16):
                        seed += 1
                        a = check_gru_bwd_case(B, mode, dtype, seed, device,
                                               masks=masks)
                        if dtype == torch.float32:
                            err = max(err, a)
        for shape in (WIDE_GRU, ODD_GRU):
            for mode in gru.MODES:
                for dtype in (torch.float32, torch.bfloat16):
                    seed += 1
                    check_gru_bwd_case(shape["B"], mode, dtype, seed, device,
                                       T=shape["T"], H=shape["H"],
                                       masks="holes")
    return err


def seq_labels(n, seed):
    return np.random.default_rng(seed).integers(0, 2, n).astype(np.float32)


def seq_train_data(model, n, seed):
    """The bench's inputs as the flat host matrix ``fit`` takes, and
    labels."""
    X = seq_requests(model, n, seed, "cpu").numpy()
    return X, seq_labels(n, seed + 1)


def phase_seq_fit_f32(kind, variant, device):
    """compile("adagrad") + fit + evaluate at float32: the launches of
    each step, finite losses and AUC."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_compute_dtype("float32")
    label = "%s %s" % (kind.upper(), variant)
    model = seq_model(kind, variant, device)
    model.compile("adagrad", "binary_crossentropy", metrics=["auc"])
    check(model._sparse_specs == [], "%s: tables on the sparse path under "
          "auto: %s" % (label, model._sparse_specs))
    n = SEQ_BATCH * SEQ_TRAIN_STEPS
    x, y = seq_train_data(model, n, SEED + 80)
    losses = record_losses(model)
    reset_counts()
    model.fit(x, y, batch_size=SEQ_BATCH, epochs=1, verbose=0)
    counts = read_counts()
    for name, per_step in SEQ_TRAIN_LAUNCHES[(kind, variant)].items():
        check(counts[name] == per_step * SEQ_TRAIN_STEPS,
              "%s: %s launched %d times in %d train steps, want %d a step"
              % (label, name, counts[name], SEQ_TRAIN_STEPS, per_step))
    check(len(losses) == SEQ_TRAIN_STEPS and np.isfinite(losses).all(),
          "%s: train losses %s" % (label, losses))
    auc = model.evaluate(x, y, batch_size=SEQ_BATCH)["auc"]
    check(np.isfinite(auc), "%s: evaluate gave auc %r" % (label, auc))
    log("fit f32 %s: %d steps of %d, launches %s, per-step losses %s; "
        "evaluate auc %r" % (label, SEQ_TRAIN_STEPS, SEQ_BATCH, counts,
                             losses, auc))
    return counts


def phase_seq_fit_sparse(device):
    """DIEN AUGRU with sparse_table_updates=True: the touched rows of the
    three tables, the history spans' 100 id columns each included, go
    through row_update; exactly those rows (and row 0) change."""
    pt.set_compute_dtype("float32")
    model = seq_model("dien", "AUGRU", device)
    model.compile("adagrad", "binary_crossentropy",
                  sparse_table_updates=True)
    specs = model._sparse_specs
    check(sorted(p for p, _, _ in specs) == sorted(
        "embedding_dict/" + t for t in SEQ_VOCABS), "sparse tables %s"
        % [p for p, _, _ in specs])
    steps = 2
    n = SEQ_BATCH * steps
    x, y = seq_train_data(model, n, SEED + 85)
    tables = model._tables()
    before = {p: tables[p].detach().clone() for p, _, _ in specs}
    reset_counts()
    model.fit(x, y, batch_size=SEQ_BATCH, epochs=1, verbose=0)
    counts = read_counts()
    for name, want in (("row_update", steps), ("scatter_add_rows", steps),
                       ("gru_scan_bwd", 2 * steps)):
        check(counts[name] == want, "DIEN sparse: %s launched %d times in "
              "%d steps" % (name, counts[name], steps))
    X = torch.from_numpy(x).to(device)
    with torch.no_grad():
        for path, spans, rows in specs:
            cols = [c for s, e in spans for c in range(s, e)]
            touched = torch.zeros(rows, dtype=torch.bool, device=device)
            touched[X[:, cols].long().reshape(-1)] = True
            touched[0] = True
            changed = (tables[path] != before[path]).any(dim=1)
            check(torch.equal(changed, touched), "DIEN sparse: %s: the rows "
                  "that changed are not the rows the batches touched" % path)
    log("fit f32 DIEN AUGRU, sparse_table_updates=True: %d steps of %d, "
        "launches %s; in each of %s exactly the touched rows (and row 0) "
        "changed" % (steps, SEQ_BATCH, counts, [p for p, _, _ in specs]))
    return counts


def phase_seq_fit_card_vs_cpu(kind, variant, device):
    """The same train steps on the card and on the CPU from the same
    weights, at batches of SEQ_CPU_BATCH."""
    pt.set_compute_dtype("float32")
    label = "%s %s" % (kind.upper(), variant)
    card = seq_model(kind, variant, device)
    cpu = seq_model(kind, variant, "cpu")
    cpu.set_weights(card.get_weights())
    n = SEQ_CPU_BATCH * SEQ_CPU_STEPS
    x, y = seq_train_data(card, n, SEED + 90)
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        model.compile("adagrad", "binary_crossentropy")
        losses = record_losses(model)
        t0 = time.perf_counter()
        model.fit(x, y, batch_size=SEQ_CPU_BATCH, epochs=1, verbose=0)
        runs[name] = (losses, time.perf_counter() - t0)
    (lc, tc), (lp, tp) = runs["card"], runs["cpu"]
    check(len(lc) == len(lp) == SEQ_CPU_STEPS, "losses %s %s" % (lc, lp))
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    check(rel <= LOSS_RTOL, "%s card vs CPU: losses %s vs %s" % (label, lc,
                                                                lp))
    log("fit card vs CPU %s (%d steps of %d): losses card %s cpu %s, max "
        "rel diff %r (rtol %r); fit took %.2f s on the card, %.2f s on the "
        "CPU" % (label, SEQ_CPU_STEPS, SEQ_CPU_BATCH, lc, lp, rel, LOSS_RTOL,
                 tc, tp))


def gru_bwd_bound(args, flop_rate):
    """(ms, "operations" or "bytes") for gru_scan_bwd on ``args``: a step
    inside a history does 3 products of H x 3H multiply-adds a row (the
    gates recomputed, dh, dW_hh); a step past it needs none.  Bytes: the
    gates, carries and output cotangents of those steps, h_last's
    cotangent, the mask and the weights read once; dgi (every step),
    dW_hh and db_hh written once."""
    gi, whh_t, bhh, mask, _ = args
    T, B, H3 = gi.shape
    H = H3 // 3
    valid = int(mask.sum())
    size = gi.element_size()
    n_bytes = (valid * (H3 + 2 * H) * size + B * H * size
               + mask.numel() * mask.element_size() + T * B * H3 * size
               + 2 * 4 * (H * H3 + H3))
    return bound(n_bytes, 6 * valid * H * H3, flop_rate)


def gru_dw_bound(args, flop_rate=F32_FLOP_PER_S):
    """(ms, "operations" or "bytes") for gru_scan_bwd's dW_hh / db_hh
    product alone (its own kernels, on float32 FMAs) on ``args``: over the
    steps inside the histories, H x 3H multiply-adds a row for dW_hh and 3H
    adds for db_hh.  Bytes: those steps' carries (storage type) and float32
    d_gh rows and the mask read once, dW_hh and db_hh written once."""
    gi, _, _, mask, _ = args
    H3 = gi.shape[2]
    H = H3 // 3
    valid = int(mask.sum())
    n_bytes = (valid * (H * gi.element_size() + H3 * 4)
               + mask.numel() * mask.element_size() + 4 * (H * H3 + H3))
    return bound(n_bytes, 2 * valid * H * H3 + valid * H3, flop_rate)


# the SASS instruction classes counted in the kernels of SASS_PICK
SASS_OPS = ("LDS", "LDS.128", "LDS.64", "FFMA", "HMMA", "SHFL", "BAR", "LDG",
            "STG", "MUFU", "LDC")


def sass_counts(name):
    """{kernel function: {instruction class: count}} of the SASS of
    ``csrc/<name>.cu``'s built library (``cuobjdump -sass``).  Static
    counts: an instruction inside a loop counts once.  None where the
    toolkit has no cuobjdump."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    lib = _build._paths(name)[1]
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS + ("all",), 0)
            continue
        if fn is None or not line.startswith("/*") or "*/" not in line:
            continue
        words = line.split("*/", 1)[1].split()
        if not words or words[0] == "/*":
            continue
        op = words[1] if words[0].startswith("@") and len(words) > 1 \
            else words[0]
        counts[fn]["all"] += 1
        for cls in SASS_OPS:
            if op == cls or op.startswith(cls + "."):
                counts[fn][cls] += 1
    return counts


# the instances whose SASS counts phase 1 prints: the GRU kernels'
# bfloat16 gru-mode instances (the timed case) and the dW product's
# kernels; the attention's bfloat16 instances of the timed case (relu);
# every instance of row_update (one an optimizer)
SASS_PICK = {
    "gru_scan": lambda label: "bfloat16" in label and ", 0," in label,
    "gru_scan_bwd": lambda label: ("bfloat16" in label and ", 0," in label
                                   or "dw_" in label),
    "din_attention": lambda label: "bfloat16" in label and (
        "mma" in label or ", 1>" in label),
    "row_update": lambda label: True,
}


def log_sass():
    """The SASS instruction counts of the instances of SASS_PICK."""
    for name, pick in SASS_PICK.items():
        counts = sass_counts(name)
        if counts is None:
            log("sass %s: not measured (no cuobjdump)" % name)
            continue
        names = subprocess.run(["c++filt"], input="\n".join(counts),
                               capture_output=True, text=True).stdout
        pretty = (names.splitlines() if names.count("\n") >= len(counts) - 1
                  and names else list(counts))
        for (fn, c), label in zip(counts.items(), pretty):
            label = label.replace("(anonymous namespace)::", "")
            if pick(label):
                log("sass %s: %s: %s" % (name, label.split("(")[0], ", ".join(
                    "%s %d" % kv for kv in c.items())))


def gru_times(device):
    """Device ms with a cold L2 (median of 20) of K3 and K5 at bf16,
    B=1024, T=100, H=64, gru mode, prefix masks of lengths over [0, 100]:
    the inference and carry-saving forwards; the backward whole, its
    reverse scan alone and its dW_hh / db_hh product (partials and their
    reduction) alone.  Returns (ms, gru_inputs' args, douts, dh_last,
    carry)."""
    args, douts, dh_last = bwd_inputs(SEQ_BATCH, "gru", torch.bfloat16,
                                      SEED + 300, device)
    gi, whh_t, bhh, mask, _ = args
    with torch.no_grad():
        _, _, carry = gru.gru_scan_with_carry(gi, whh_t, bhh, mask)
        bwd = (gi, carry, whh_t, bhh, mask, None, douts, dh_last)
        run, _ = gru.gru_scan_bwd_launcher(*bwd)
        run(gru.BWD_SCAN)  # the d_gh the dW product reads
        timed = {
            "forward": lambda: gru.gru_scan(gi, whh_t, bhh, mask),
            "carry-saving forward": lambda: gru.gru_scan_with_carry(
                gi, whh_t, bhh, mask),
            "backward": lambda: gru.gru_scan_bwd(*bwd),
            "backward scan": lambda: run(gru.BWD_SCAN),
            "backward dW": lambda: run(gru.BWD_DW),
        }
        ms = {k: device_ms(fn) for k, fn in timed.items()}
    return ms, args, douts, dh_last, carry


# phase 15's fits: (model, variant, sparse_table_updates)
SEQ_FIT_TIMED = (("dien", "AUGRU", False), ("din", "dice", False),
                 ("dien", "AUGRU", True))


def seq_fit_timing(kind, variant, sparse, device):
    """fit at bf16, SEQ_TRAIN_STEPS steps of SEQ_BATCH from host arrays:
    examples/s (CUDA events, median of 3) and device busy time
    (torch.profiler)."""
    pt.set_compute_dtype("bfloat16")
    n = SEQ_BATCH * SEQ_TRAIN_STEPS
    label = "%s %s%s" % (kind.upper(), variant,
                         ", sparse tables" if sparse else "")
    model = seq_model(kind, variant, device)
    model.compile("adagrad", "binary_crossentropy",
                  sparse_table_updates=sparse)
    x, y = seq_train_data(model, n, SEED + 95)

    def fit():
        model.fit(x, y, batch_size=SEQ_BATCH, epochs=1, verbose=0)
    fit_ms = time_ms(fit, reps=1, runs=3)
    busy_ms = profile_ms(fit, "fit %s" % label)
    log("fit bf16 %s, host numpy input: %r examples/s (%r ms for %d steps "
        "of %d); device busy %s"
        % (label, n / fit_ms * 1e3, fit_ms, SEQ_TRAIN_STEPS, SEQ_BATCH,
           busy_line(busy_ms, fit_ms)))


def k2_dien_times(device):
    """row_update at DIEN AUGRU's sparse shape (dien_sparse_args), every
    optimizer: device ms and bounds."""
    model, w, touched, l2s = dien_sparse_args(device)
    what = "DIEN sparse (%d touched rows in %d slots of %d tables, W=%d)" % (
        sum(valid_counts(touched.rows, w)),
        sum(len(r) for r in touched.rows), len(w), w[0].shape[1])
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    for opt in OPTIMIZERS:
        states = k2_states(opt, w, gen)
        upd = (w, states, touched.grads, touched.rows, l2s, 0.01)
        log(k2_line(opt, what, k2_times(opt, upd,
                                        k2_bias(opt, len(w), device)),
                    k2_bounds(opt, w, states, touched.rows)))
    del model


def phase_seq_train_timing_bf16(device):
    """fit of DIEN AUGRU+neg and DIN Dice at bf16 (examples/s, idle share);
    the backward kernel against its plain version and torch.nn.GRU's
    backward, and the carry-saving forward against the inference one, in
    device ms."""
    log("timing on: %s" % card_line())
    k2_dien_times(device)
    for kind, variant, sparse in SEQ_FIT_TIMED:
        seq_fit_timing(kind, variant, sparse, device)

    kms, args, douts, dh_last, carry = gru_times(device)
    gi, whh_t, bhh, mask, _ = args
    T, B, H3 = gi.shape
    H = H3 // 3
    bwd = (gi, carry, whh_t, bhh, mask, None, douts, dh_last)
    with torch.no_grad():
        ms = {"plain": device_ms(lambda: gru.gru_scan_bwd_ref(*bwd))}
    # the earlier yardsticks: autograd through the plain forward, and the
    # library's GRU (cuDNN where it takes the type) over the [B, T, H]
    # inputs DIEN's GRUs read, every row at its full length, its own input
    # projection included
    lib_gru = torch.nn.GRU(H, H, batch_first=True).to(device, torch.bfloat16)
    lib_gru.flatten_parameters()
    x = torch.randn(B, T, H, device=device, dtype=torch.bfloat16)
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in (gi, whh_t, bhh)]
        outs, h_last = gru.gru_scan_ref(*leaves, mask)
        y, _ = lib_gru(x.requires_grad_())
        dy = torch.randn_like(y)
        more = {
            "autograd": lambda: torch.autograd.grad(
                (outs, h_last), leaves, (douts, dh_last), retain_graph=True),
            "library": lambda: torch.autograd.grad(
                y, [x] + list(lib_gru.parameters()), dy, retain_graph=True),
        }
        ms.update({k: device_ms(fn) for k, fn in more.items()})
    bound_ms, bound_by = gru_bwd_bound(args,
                                       TF32_FLOP_PER_S / GRU_TF32_PRODUCTS)
    f32_ms, f32_by = gru_bwd_bound(args, F32_FLOP_PER_S)
    dw_ms, dw_by = gru_dw_bound(args)
    log("gru_scan_bwd (gru) at T=%d B=%d H=%d, bf16 storage, %d steps inside "
        "the histories, %s; device time, cold L2: kernel %r ms (earlier "
        "design: %r ms): the reverse scan %r ms, the dW_hh / db_hh product "
        "(partials and their reduction) %r ms (its bound %r ms, %s, at the "
        "float32 FMA rate); plain (gru_scan_bwd_ref) %r ms, "
        "autograd through gru_scan_ref %r ms, "
        "library (torch.nn.GRU backward, full length) %r ms; bound %r ms "
        "(%s; the products at the TF32 tensor rate, 3 products a "
        "multiply-add), %r ms (%s) at the float32 FMA rate"
        % (T, B, H, int(mask.sum()), block_steps_line(mask),
           kms["backward"], EARLIER_MS["gru_scan_bwd"], kms["backward scan"],
           kms["backward dW"], dw_ms, dw_by, ms["plain"], ms["autograd"],
           ms["library"], bound_ms, bound_by, f32_ms, f32_by))
    log("gru_scan forward at the same shape, device time, cold L2: "
        "inference %r ms (earlier design: %r ms), carry-saving (training) "
        "%r ms"
        % (kms["forward"], EARLIER_MS["gru_scan"],
           kms["carry-saving forward"]))
    return dict(ms=kms["backward"], plain_ms=ms["plain"],
                library_ms=ms["library"], bound_ms=bound_ms,
                bound_by=bound_by)


# ---------------------------------------------------------------------------
# xDeepFM: the CIN kernel, serving and training
# ---------------------------------------------------------------------------

def cin_inputs(B, H, O, dtype, seed, device, D=EMB_DIM, F=XD_FIELDS,
               split_of=None):
    """``cin_mix``'s arguments: hidden_t [B, D, H] and x0_t [B, D, F] normal,
    w3 [O, H, F] from the layer's init U(+-1/sqrt(O)), all rounded to
    ``dtype``; with ``split_of`` the hidden maps are the first half of a
    [B, D, split_of] tensor, as the layer hands them on."""
    gen = torch.Generator(device=device).manual_seed(seed)
    width = split_of or H
    maps = torch.randn(B, D, width, generator=gen, device=device).to(dtype)
    hidden = maps[..., :H]
    x0 = torch.randn(B, D, F, generator=gen, device=device).to(dtype)
    w3 = ((torch.rand(O, H, F, generator=gen, device=device) * 2 - 1)
          * O ** -0.5).to(dtype)
    return hidden, x0, w3


def cin_scale(hidden, x0, w3):
    """sum_k |w z| of every output, in float32."""
    return cin.cin_mix_ref(hidden.float().abs(), x0.float().abs(),
                           w3.float().abs())


def check_cin_case(B, H, O, dtype, seed, device, D=EMB_DIM, F=XD_FIELDS,
                   split_of=None):
    """One cin_mix case against its plain version and a repeat launch;
    returns max |kernel - plain|."""
    hidden, x0, w3 = cin_inputs(B, H, O, dtype, seed, device, D, F,
                                split_of)
    wt, wm = cin.kernel_weights(w3, dtype)
    got = cin.cin_mix(hidden, x0, w3, wt=wt, wm=wm)
    again = cin.cin_mix(hidden, x0, w3, wt=wt, wm=wm)
    want = cin.cin_mix_ref(hidden, x0, w3)
    torch.cuda.synchronize()
    what = ("cin_mix %s B=%d D=%d H=%d F=%d O=%d%s, %s route"
            % (dtype, B, D, H, F, O,
               " (first half of %d maps)" % split_of if split_of else "",
               cin.route(dtype, H, F, O)))
    check(bits_equal(got, again), what + ": a repeat launch gave other bits")
    e, a = compare(got, want, what, cin_scale(hidden, x0, w3))
    log("kernel vs plain: %s: %s %r; max |err| %r; repeat bit-equal"
        % (what, "max |err| / max(1, sum_k |w z|)" if dtype == torch.float32
           else "max bf16 ulps", e, a))
    return a


def check_cin_grads(B, H, O, seed, device, D=EMB_DIM, F=XD_FIELDS):
    """CinMix's gradients against autograd through cin_mix_ref, float32."""
    hidden, x0, w3 = cin_inputs(B, H, O, torch.float32, seed, device, D, F)
    wt = cin.kernel_weight(w3, torch.float32)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    g = torch.randn(B, D, O, generator=gen, device=device)
    leaves = [t.detach().clone().requires_grad_() for t in (hidden, x0, wt)]
    out = cin.CinMix.apply(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.detach().clone().requires_grad_()
                  for t in (hidden, x0, wt)]
    w3_ref = ref_leaves[2].reshape(F, H, O).permute(2, 1, 0)
    ref_out = cin.cin_mix_ref(ref_leaves[0], ref_leaves[1], w3_ref)
    want = torch.autograd.grad(ref_out, ref_leaves, g)
    scales = cin.cin_mix_bwd(hidden.abs(), x0.abs(), wt.abs(), g.abs())
    torch.cuda.synchronize()
    what = "CinMix gradients B=%d D=%d H=%d F=%d O=%d" % (B, D, H, F, O)
    errs = []
    for name, a, b, scale in zip(("dh", "dx", "dwt"), got, want, scales):
        e, _ = compare(a, b, what + " " + name, scale)
        errs.append("%s %r" % (name, e))
    log("kernel vs plain: %s vs autograd through cin_mix_ref: max |err| / "
        "max(1, sum of term magnitudes): %s" % (what, ", ".join(errs)))


def phase_cin_vs_plain(device):
    """cin_mix against cin_mix_ref at the slice's shapes and the others of
    phase 16; returns the largest float32 |kernel - plain| at the slice's
    shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    err = 0.0
    seed = SEED + 400
    (h0, o0), (h1, o1) = XD_LAYERS
    cases = [dict(B=BATCH, H=h0, O=o0), dict(B=BATCH, H=h1, O=o1,
                                             split_of=o0),
             dict(B=1000, H=h0, O=o0), dict(B=1000, H=h1, O=o1,
                                            split_of=o0),
             dict(B=BATCH, H=o0, O=o1),                # split_half=False
             dict(B=BATCH, H=h0, O=100),               # O no multiple of 8
             dict(B=37, H=5, O=7, D=3, F=3),
             dict(B=64, H=400, O=72),
             # rows too wide for the tensor-core path's shared memory
             dict(B=64, H=1000, O=256)]
    with torch.no_grad():
        for i, case in enumerate(cases):
            for dtype in (torch.float32, torch.bfloat16):
                seed += 1
                a = check_cin_case(dtype=dtype, seed=seed, device=device,
                                   **case)
                if dtype == torch.float32 and i < 2:
                    err = max(err, a)
    for case in (dict(B=BATCH, H=h0, O=o0), dict(B=BATCH, H=h1, O=o1),
                 dict(B=37, H=5, O=7, D=3, F=3)):
        seed += 1
        check_cin_grads(seed=seed, device=device, **case)
    return err


def xdeepfm_columns():
    sparse = [pt.SparseFeat("C%d" % i, XD_VOCAB, EMB_DIM)
              for i in range(XD_FIELDS)]
    dense = [pt.DenseFeat("I%d" % i, 1) for i in range(N_DENSE)]
    return sparse + dense


def xdeepfm_model(device):
    """xDeepFM at the slice's width, its weights redrawn from a seed so
    that predictions spread: the tables (deep and wide columns) from
    normal(0.3), the DNN's kernels at 1/sqrt(fan_in); the CIN's and the
    output layers' at their init."""
    cols = xdeepfm_columns()
    model = xDeepFM(cols, cols, dnn_hidden_units=XD_HIDDEN,
                    cin_layer_size=XD_CIN, seed=SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 410)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("dnn.") and p.dim() == 2:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif "embedding_dict" in name:
                p.normal_(0.0, XD_EMB_STD, generator=gen)
    return model


def xdeepfm_requests(n, seed, device):
    """A flat [n, 39] float32 batch: uniform ids, dense values in [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, XD_VOCAB, (n, XD_FIELDS), generator=gen,
                        device=device)
    dense = torch.rand(n, N_DENSE, generator=gen, device=device)
    return torch.cat([ids.float(), dense], dim=1).contiguous()


def phase_xdeepfm_f32(device):
    """predict, then compile/fit/evaluate, at float32; then card against
    CPU from the same weights.  Returns the launches of both runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_compute_dtype("float32")
    model = xdeepfm_model(device)
    n = BATCH * N_BATCHES
    X = xdeepfm_requests(n, SEED + 420, device)
    reset_counts()
    pred = model.predict(X, batch_size=BATCH)
    counts = read_counts()
    for name, per_batch in (("cin_mix", 2), ("gather_rows", 1)):
        check(counts[name] == per_batch * N_BATCHES, "xDeepFM predict: %s "
              "launched %d times in %d batches, want %d a batch"
              % (name, counts[name], N_BATCHES, per_batch))
    check_predictions(pred, n)
    model.to("cpu")
    try:
        pred_cpu = model.predict(X[:BATCH].cpu(), batch_size=BATCH)
    finally:
        model.to(device)
    diff = float(np.abs(pred[:BATCH] - pred_cpu).max())
    check(diff <= ATOL_CPU, "xDeepFM: card vs CPU max |dp| %r > %r"
          % (diff, ATOL_CPU))
    log("predict f32 xDeepFM: %d requests in %d batches, launches %s, "
        "predictions in [%.6f, %.6f], std %.6f; first batch vs CPU max |dp| "
        "= %r (atol %r)" % (n, N_BATCHES, counts, pred.min(), pred.max(),
                            pred.std(), diff, ATOL_CPU))

    model.compile("adagrad", "binary_crossentropy", metrics=["auc"])
    check(model._sparse_specs == [], "xDeepFM: tables on the sparse path "
          "under auto: %s" % model._sparse_specs)
    n = BATCH * XD_TRAIN_STEPS
    x = X[:n].cpu().numpy()
    y = criteo_labels(n, SEED + 421)
    losses = record_losses(model)
    reset_counts()
    model.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    train_counts = read_counts()
    for name, per_step in XD_TRAIN_LAUNCHES.items():
        check(train_counts[name] == per_step * XD_TRAIN_STEPS,
              "xDeepFM fit: %s launched %d times in %d train steps, want %d "
              "a step" % (name, train_counts[name], XD_TRAIN_STEPS,
                          per_step))
    check(len(losses) == XD_TRAIN_STEPS and np.isfinite(losses).all(),
          "xDeepFM: train losses %s" % losses)
    auc = model.evaluate(x, y, batch_size=BATCH)["auc"]
    check(np.isfinite(auc), "xDeepFM: evaluate gave auc %r" % auc)
    log("fit f32 xDeepFM: %d steps of %d, launches %s, per-step losses %s; "
        "evaluate auc %r" % (XD_TRAIN_STEPS, BATCH, train_counts, losses,
                             auc))
    del model

    card = xdeepfm_model(device)
    cpu = xdeepfm_model("cpu")
    cpu.set_weights(card.get_weights())
    n = XD_CPU_BATCH * XD_CPU_STEPS
    x = X[-n:].cpu().numpy()
    y = criteo_labels(n, SEED + 422)
    runs = {}
    for name, m in (("card", card), ("cpu", cpu)):
        m.compile("adagrad", "binary_crossentropy")
        rec = record_losses(m)
        t0 = time.perf_counter()
        m.fit(x, y, batch_size=XD_CPU_BATCH, epochs=1, verbose=0)
        runs[name] = (rec, time.perf_counter() - t0)
    (lc, tc), (lp, tp) = runs["card"], runs["cpu"]
    check(len(lc) == len(lp) == XD_CPU_STEPS, "losses %s %s" % (lc, lp))
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    check(rel <= LOSS_RTOL, "xDeepFM card vs CPU: losses %s vs %s"
          % (lc, lp))
    log("fit card vs CPU xDeepFM (%d steps of %d): losses card %s cpu %s, "
        "max rel diff %r (rtol %r); fit took %.2f s on the card, %.2f s on "
        "the CPU" % (XD_CPU_STEPS, XD_CPU_BATCH, lc, lp, rel, LOSS_RTOL, tc,
                     tp))
    return counts, train_counts


def cin_bound(B, H, O, size, flop_rate, D=EMB_DIM, F=XD_FIELDS):
    """(ms, "operations" or "bytes") for cin_mix: 2 M K O operations at
    ``flop_rate`` against hidden, x0 and wt read once and the output
    written once, ``size`` bytes an element."""
    M, K = B * D, H * F
    n_bytes = size * (M * H + M * F + K * O + M * O)
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * M * K * O / flop_rate * 1e3
    return ((by_ops, "operations") if by_ops >= by_bytes
            else (by_bytes, "bytes"))


def phase_xdeepfm_timing_bf16(device):
    """xDeepFM predict and fit at bf16 compute (examples/s, idle share,
    device time by kernel), and cin_mix at both layers' shapes against
    its plain version and the library's product, with its bound."""
    log("timing on: %s" % card_line())
    pt.set_compute_dtype("bfloat16")
    model = xdeepfm_model(device)
    n = BATCH * N_BATCHES
    X = xdeepfm_requests(n, SEED + 430, device)
    check_predictions(model.predict(X, batch_size=BATCH), n)
    run_ms = time_ms(lambda: model.predict(X, batch_size=BATCH), reps=1,
                     runs=5)
    log("predict bf16 xDeepFM, device input: %r examples/s (%r ms for %d)"
        % (n / run_ms * 1e3, run_ms, n))
    busy_ms = profile_ms(lambda: model.predict(X, batch_size=BATCH),
                         "predict xDeepFM", top=6)
    if busy_ms is not None:
        log("predict bf16 xDeepFM: device busy %r ms of %r ms, idle share %r"
            % (busy_ms, run_ms, 1 - busy_ms / run_ms))

    model.compile("adagrad", "binary_crossentropy")
    nt = BATCH * XD_TRAIN_STEPS
    x, y = X[:nt].cpu().numpy(), criteo_labels(nt, SEED + 431)

    def fit():
        model.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    fit_ms = time_ms(fit, reps=1, runs=5)
    log("fit bf16 xDeepFM, host numpy input: %r examples/s (%r ms for %d "
        "steps of %d)" % (nt / fit_ms * 1e3, fit_ms, XD_TRAIN_STEPS, BATCH))
    busy_ms = profile_ms(fit, "fit xDeepFM")
    if busy_ms is not None:
        log("fit bf16 xDeepFM: device busy %r ms of %r ms, idle share %r"
            % (busy_ms, fit_ms, 1 - busy_ms / fit_ms))
    del model

    dtype = torch.bfloat16
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by = set()
    with torch.no_grad():
        for i, (H, O) in enumerate(XD_LAYERS):
            hidden, x0, w3 = cin_inputs(BATCH, H, O, dtype, SEED + 440 + i,
                                        device, split_of=XD_CIN[0] if i
                                        else None)
            wt, wm = cin.kernel_weights(w3, dtype)
            M, K = BATCH * EMB_DIM, H * XD_FIELDS
            zf = (x0[..., :, None] * hidden[..., None, :]).reshape(M, K)
            timed = {
                "kernel": lambda: cin.cin_mix(hidden, x0, w3, wt=wt, wm=wm),
                "plain": lambda: cin.cin_mix_ref(hidden, x0, w3),
                # the library's product of a prebuilt z [M, K] (f-major,
                # the kernel's K order) by the kernel's weight
                "library": lambda: torch.matmul(zf, wt),
                "z build": lambda: (x0[..., :, None]
                                    * hidden[..., None, :]).reshape(M, K),
            }
            ms = {k: device_ms(fn) for k, fn in timed.items()}
            bound_ms, by = cin_bound(BATCH, H, O, 2, BF16_FLOP_PER_S)
            f32_ms, f32_by = cin_bound(BATCH, H, O, 4, F32_FLOP_PER_S)
            for k, key in (("kernel", "ms"), ("plain", "plain_ms"),
                           ("library", "library_ms")):
                total[key] += ms[k]
            total["bound_ms"] += bound_ms
            bound_by.add(by)
            flops = 2 * M * K * O
            log("cin_mix layer %d (B=%d D=%d H=%d F=%d O=%d, K=%d), bf16, "
                "device time, cold L2: kernel %r ms (%r TFLOP/s), plain %r "
                "ms, library (torch.matmul of a prebuilt z by wt) %r ms, "
                "building z %r ms; bound %r ms (%s, %.4g GFLOP at %.3g "
                "FLOP/s); at float32 FMA rate the bound would be %r ms (%s)"
                % (i, BATCH, EMB_DIM, H, XD_FIELDS, O, K, ms["kernel"],
                   flops / ms["kernel"] / 1e9, ms["plain"], ms["library"],
                   ms["z build"], bound_ms, by, flops / 1e9,
                   BF16_FLOP_PER_S, f32_ms, f32_by))
            del zf
    log("cin_mix, both layers of one forward, bf16: kernel %r ms, plain %r "
        "ms, library %r ms, bound %r ms" % (total["ms"], total["plain_ms"],
                                            total["library_ms"],
                                            total["bound_ms"]))
    return dict(total, bound_by="/".join(sorted(bound_by)))


# ---------------------------------------------------------------------------
# the scatter micro-benchmark's row scatter
# ---------------------------------------------------------------------------

def guarded_copy(arena):
    """A copy of ``arena`` in a buffer GUARD_ROWS rows longer, those rows
    at a sentinel: (the copy, a view of the rows past it)."""
    rows, width = arena.shape
    buf = torch.empty(rows + GUARD_ROWS, width, dtype=arena.dtype,
                      device=arena.device)
    buf[:rows].copy_(arena)
    buf[rows:].fill_(-12345.0)
    return buf[:rows], buf[rows:]


def phase_static_scatter(device):
    """static_scatter (every unroll) and the dynamic variant against their
    plain versions at the tool's shape, then the micro-benchmark's run
    (its launches counted) and the device-ms table.  Returns the kernels
    line's entry."""
    inp = scatter_micro.make_inputs(SEED + 500, device)
    arena, vals, starts = inp["arena"], inp["vals"], inp["starts"]
    nvs = inp["n_valids"]
    G, R, N, NV = inp["shape"]
    L, W = scatter_micro.L, scatter_micro.W
    dump = G * R * L
    named = torch.zeros(arena.shape[0], dtype=torch.bool, device=device)
    named[(starts[:, :NV].reshape(-1, 1).long()
           + torch.arange(L, device=device)).reshape(-1)] = True
    pad = vals[:, NV * L:].reshape(G, N - NV, L, W)
    with torch.no_grad():
        want = arena.clone()
        scatter_rows.static_scatter_ref(want, vals, starts)
        err = 0.0
        for u in scatter_rows.UNROLLS:
            got, guard = guarded_copy(arena)
            scatter_rows.static_scatter(got, vals, starts, unroll=u)
            torch.cuda.synchronize()
            what = "static_scatter u%d" % u
            check(same_bits(got[:dump], want[:dump]), what + ": differs "
                  "from the plain version outside the dump row")
            unnamed = ~named[:dump]
            check(torch.equal(got[:dump][unnamed], arena[:dump][unnamed]),
                  what + ": a row no slot names changed")
            d = got[dump:dump + L]
            check(bool((pad == d).flatten(0, 1).any(dim=0).all()),
                  what + ": a dump-row value is none of the padding slots'")
            check(bool((guard == -12345.0).all()), what + ": wrote past the "
                  "arena")
            err = max(err, (got[:dump] - want[:dump]).abs().max().item())
            del got, guard
        dyn_want = arena.clone()
        scatter_rows.scatter_rows_ref(dyn_want, vals, starts, nvs, L=L)
        for label, fn in (
                ("one launch", lambda a: scatter_rows.scatter_rows(
                    a, vals, starts, nvs, L=L)),
                ("one launch a table", lambda a: [scatter_rows.scatter_rows(
                    a, vals[t], starts[t], nvs[t:t + 1], L=L)
                    for t in range(G)])):
            got, guard = guarded_copy(arena)
            fn(got)
            torch.cuda.synchronize()
            check(same_bits(got, dyn_want), "dynamic scatter (%s) differs "
                  "from its plain version" % label)
            check(torch.equal(got[dump:], arena[dump:]), "dynamic scatter "
                  "(%s) wrote the dump row" % label)
            check(bool((guard == -12345.0).all()), "dynamic scatter (%s) "
                  "wrote past the arena" % label)
            del got, guard
        del want, dyn_want
    log("kernel vs plain: static_scatter at G=%d R=%d N=%d NV=%d L=%d W=%d "
        "(a %.2f GB arena), unroll 1, 2, 4, 8: bit-equal outside the dump "
        "row (max |err| %r), dump-row values all padding slots', unnamed "
        "rows unchanged, nothing written past the arena; the dynamic "
        "variant (one launch, and one a table) bit-equal everywhere, the "
        "dump row untouched" % (G, R, N, NV, L, W,
                                arena.numel() * 4 / 1e9, err))

    reset_counts()
    scatter_rows.SCATTER_ROWS_LAUNCHES = 0
    records = scatter_micro.run(inp, repeats=SCATTER_REPEATS)
    counts = read_counts()
    for rec in records:
        print(json.dumps(rec), flush=True)
    log("scatter micro-benchmark on %s: static_scatter launches %d, dynamic "
        "launches %d" % (card_line(), counts["static_scatter"],
                         scatter_rows.SCATTER_ROWS_LAUNCHES))

    with torch.no_grad():
        valid = torch.arange(N, device=device)[None, :] < nvs[:, None].long()
        dst = (starts[valid].long()[:, None]
               + torch.arange(L, device=device)).reshape(-1)
        src = vals.reshape(G, N, L, W)[valid].reshape(-1, W).contiguous()
        # every slot, the padding slots onto the dump row, as the kernel
        # copies them: the call that computes static_scatter's function
        dst_all = (starts.reshape(-1).long()[:, None]
                   + torch.arange(L, device=device)).reshape(-1)
        src_all = vals.reshape(-1, W)
        timed = {"u%d" % u: (lambda u=u: scatter_rows.static_scatter(
            arena, vals, starts, unroll=u)) for u in scatter_rows.UNROLLS}
        timed.update({
            "dynamic": lambda: scatter_rows.scatter_rows(
                arena, vals, starts, nvs, L=L),
            "plain": lambda: scatter_rows.static_scatter_ref(arena, vals,
                                                             starts),
            # the library's row copy of every slot, and (a smaller
            # function) of the valid rows alone, indices prebuilt
            "library": lambda: arena.index_copy_(0, dst_all, src_all),
            "library valid": lambda: arena.index_copy_(0, dst, src),
        })
        ms = {k: device_ms(fn) for k, fn in timed.items()}
    best = min(scatter_rows.UNROLLS, key=lambda u: ms["u%d" % u])
    n_bytes = 2 * G * N * L * W * 4
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    dyn_bound = 2 * G * NV * L * W * 4 / HBM_BYTES_PER_S * 1e3
    log("static_scatter at the tool's shape, device time, cold L2: %s ms; "
        "dynamic (one launch) %r ms (bound %r ms); plain %r ms; library "
        "(index_copy_ of every slot, the padding slots onto the dump row: "
        "the same function) %r ms, and of the valid rows alone (a smaller "
        "function) %r ms; bound %r ms (%d bytes); fastest unroll %d"
        % (", ".join("u%d %r" % (u, ms["u%d" % u])
                     for u in scatter_rows.UNROLLS),
           ms["dynamic"], dyn_bound, ms["plain"], ms["library"],
           ms["library valid"], bound_ms, n_bytes, best))
    return dict(max_abs_err=err, ms=ms["u%d" % best], plain_ms=ms["plain"],
                library_ms=ms["library"], bound_ms=bound_ms,
                bound_by="bytes")

# ---------------------------------------------------------------------------
# the device-resident loops: fit on a device tensor (each step a replay of
# one captured graph) and predict (each batch a replay)
# ---------------------------------------------------------------------------

LOOP_STEPS = 8      # the graphed fits' steps: 8 x 4096, DIEN 8 x 1024
LOOP_RUNS = 5       # timed runs of each loop: median and spread


@contextlib.contextmanager
def no_host_sync():
    """Any call in the enclosed work that waits for the device (a host
    read, a blocking copy) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def strict_loops():
    """Every graph replay, and every run of a loop's step (the capture's
    warm-up and the capture itself), under no_host_sync."""
    replay, step = graphs._Captured.replay, graphs.StepGraph.step

    def strict_replay(self):
        with no_host_sync():
            replay(self)

    def strict_step(self):
        with no_host_sync():
            step(self)
    graphs._Captured.replay = strict_replay
    graphs.StepGraph.step = strict_step
    try:
        yield
    finally:
        graphs._Captured.replay, graphs.StepGraph.step = replay, step


def tensor_bits_equal(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {4: torch.int32, 2: torch.int16, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def training_state(model):
    """Every tensor training moves: the weights, the dense parameters'
    optimizer state and the sparse tables' state, by name."""
    out = dict(model.state_dict())
    sparse = set(model._table_state)
    dense = [p for p, _ in model._named_params() if p not in sparse]
    for path, st in zip(dense, model._dense_opt.state):
        for j, a in enumerate(st):
            out["%s (state %d)" % (path, j)] = a
    for path, st in model._table_state.items():
        for j, a in enumerate(st):
            out["%s (state %d)" % (path, j)] = a
    return out


def check_same_state(got, want, what):
    check(set(got) == set(want), "%s: other tensors" % what)
    for k in want:
        check(tensor_bits_equal(got[k], want[k]), "%s: %s differs"
              % (what, k))


def loop_fit(model, X, y, B):
    """fit(X) in the device-resident loop, every step and replay under
    no_host_sync: returns (history, the loop, its launches, replays)."""
    reset_counts()
    graphs.GRAPH_REPLAYS = 0
    with strict_loops():
        hist = model.fit(X, y, batch_size=B, epochs=1, verbose=0,
                         shuffle=False)
    counts = read_counts()
    loop = [g for k, g in model._graphs.items() if k[0] == "fit"]
    check(len(loop) == 1, "one captured fit loop, found %d" % len(loop))
    return hist, loop[0], counts, graphs.GRAPH_REPLAYS


def graph_vs_eager_fit(graphed, eager, X, y, B, label, per_step):
    """``graphed.fit(X)`` (the first step the capture's warm-up, every
    other a replay) against the same steps run one by one through
    ``eager._train_step`` on a twin from the same weights, each under
    no_host_sync: per-step losses, every weight, optimizer state and
    sparse table state bit for bit; each kernel of ``per_step`` launched
    that many times a step."""
    steps = X.shape[0] // B
    _, loop, counts, replays = loop_fit(graphed, X, y, B)
    check(replays == steps - 1, "%s: %d replays in %d steps" % (
        label, replays, steps))
    for name, n in per_step.items():
        check(counts[name] == n * steps, "%s: %s launched %d times in %d "
              "graphed steps, want %d a step" % (label, name, counts[name],
                                                 steps, n))
    y_dev = torch.as_tensor(y, device=X.device).view(-1, 1)
    sw = torch.ones(B, device=X.device)
    eager._begin_steps(steps)
    totals = []
    for i in range(steps):
        with no_host_sync():
            _, total, _ = eager._train_step(X[i * B:(i + 1) * B],
                                            y_dev[i * B:(i + 1) * B], sw)
        totals.append(total)
    eager_losses = torch.stack(totals)
    check(tensor_bits_equal(loop.losses, eager_losses), "%s: graphed losses "
          "%s, eager %s" % (label, loop.losses.tolist(),
                            eager_losses.tolist()))
    check_same_state(training_state(graphed), training_state(eager),
                     "%s: graphed vs eager" % label)
    log("graphed fit %s: %d steps of %d (1 eager warm-up, %d replays), "
        "launches %s; losses, weights and every optimizer and table state "
        "bit-equal to the same steps run eagerly; no host sync in any step "
        "or replay; losses %s" % (label, steps, B, replays, counts,
                                  loop.losses.tolist()))
    return counts


def eager_predict(model, X, B):
    """The eager forward of every batch, the last padded with zero rows,
    as predict batches it."""
    outs = []
    with torch.no_grad():
        for start in range(0, X.shape[0], B):
            xb = X[start:start + B]
            n = xb.shape[0]
            if n < B:
                xb = torch.cat([xb, xb.new_zeros(B - n, xb.shape[1])])
            outs.append(model(xb, training=False).float()[:n])
    return torch.cat(outs).cpu().numpy().astype("float64")


def graph_vs_eager_predict(model, X, B, label, per_batch):
    """predict(X) (every batch a replay under no_host_sync, the first the
    capture's warm-up where the model has no graph yet) against the eager
    forward: bit for bit; each kernel of ``per_batch`` launched that many
    times a batch."""
    n_batches = -(-X.shape[0] // B)
    fresh = not any(k[0] == "predict" for k in model._graphs)
    reset_counts()
    graphs.GRAPH_REPLAYS = 0
    with strict_loops():
        got = model.predict(X, B)
    counts = read_counts()
    check(graphs.GRAPH_REPLAYS == n_batches - fresh, "%s predict: %d "
          "replays for %d batches" % (label, graphs.GRAPH_REPLAYS,
                                      n_batches))
    for name, n in per_batch.items():
        check(counts[name] == n * n_batches, "%s predict: %s launched %d "
              "times in %d batches" % (label, name, counts[name], n_batches))
    want = eager_predict(model, X, B)
    check(got.shape == want.shape and np.array_equal(got, want),
          "%s: graphed predict differs from the eager forward (max |d| %r)"
          % (label, float(np.abs(got - want).max())))
    check_predictions(got, X.shape[0])
    return counts


def loop_models(device):
    """The four models the loops run, each with its inputs, labels, batch,
    graph-vs-eager twin maker and launches: ``{label: dict}``."""
    def deepfm():
        cols = criteo_columns()
        return DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                      seed=SEED, device=device)

    def dien():
        return seq_model("dien", "AUGRU", device)

    def din():
        return seq_model("din", "sigmoid", device)
    gen = torch.Generator(device=device).manual_seed(SEED + 500)
    X_criteo = criteo_requests(BATCH * LOOP_STEPS, gen, device)
    probe = dien()
    X_seq = seq_requests(probe, SEQ_BATCH * LOOP_STEPS, SEED + 501, device)
    del probe
    probe = din()
    X_din = seq_requests(probe, SEQ_BATCH * 2, SEED + 502, device)
    del probe
    return {
        "DeepFM Criteo": dict(
            make=deepfm, X=X_criteo, B=BATCH, sparse="auto",
            y=criteo_labels(BATCH * LOOP_STEPS, SEED + 503),
            predict={"gather_rows": 1},
            fit={"gather_rows": 1, "scatter_add_rows": 1, "row_update": 1}),
        "DIEN AUGRU+neg, sparse tables": dict(
            make=dien, X=X_seq, B=SEQ_BATCH, sparse=True,
            y=seq_labels(SEQ_BATCH * LOOP_STEPS, SEED + 504),
            predict={"gather_rows": 1, "gru_scan": 2},
            fit={"gather_rows": 1, "scatter_add_rows": 1, "gru_scan": 2,
                 "gru_scan_bwd": 2, "row_update": 1}),
        "DIN sigmoid": dict(
            make=din, X=X_din, B=SEQ_BATCH, sparse="auto",
            y=seq_labels(SEQ_BATCH * 2, SEED + 505),
            predict={"gather_rows": 1, "din_attention": 1},
            fit={"gather_rows": 1, "scatter_add_rows": 1}),
        "xDeepFM": dict(
            make=lambda: xdeepfm_model(device),
            X=xdeepfm_requests(BATCH * 2, SEED + 506, device), B=BATCH,
            sparse="auto", y=criteo_labels(BATCH * 2, SEED + 507),
            predict={"gather_rows": 1, "cin_mix": 2},
            fit={"gather_rows": 1, "scatter_add_rows": 1, "cin_mix": 2}),
    }


def phase_loops_f32(device):
    """phase 20: for each model, predict graphed vs eager, fit in the
    device-resident loop graphed vs eager steps on a twin (DeepFM and DIEN
    at LOOP_STEPS steps), predict again (the in-place updates must reach
    the replayed forward); for DIEN, the loop re-captured after
    set_weights and after compile gives the first fit's bits."""
    loops_f32(loop_models(device))


def loops_f32(models):
    """Graphed predict and fit against eager on twins, at float32, for
    each of ``models`` (``loop_models``' form)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_compute_dtype("float32")
    for label, m in models.items():
        X, y, B = m["X"], m["y"], m["B"]
        graphed, eager = m["make"](), m["make"]()
        for model in (graphed, eager):
            model.compile("adagrad", "binary_crossentropy",
                          sparse_table_updates=m["sparse"])
        check_same_state(training_state(graphed), training_state(eager),
                         "%s: the twins from one seed" % label)
        start = graphed.get_weights() if label.startswith("DIEN") else None
        graph_vs_eager_predict(graphed, X, B, label + " before fit",
                               m["predict"])
        graph_vs_eager_fit(graphed, eager, X, y, B, label, m["fit"])
        graph_vs_eager_predict(graphed, X, B, label + " after fit",
                               m["predict"])
        log("graphed predict %s before and after the fit bit-equal to the "
            "eager forward; %d batches of %d" % (label, -(-X.shape[0] // B),
                                                 B))
        if start is not None:
            first = {k: v.clone() for k, v in training_state(graphed).items()}
            for change in ("set_weights", "compile"):
                graphed.set_weights(start)
                if change == "compile":
                    graphed.compile("adagrad", "binary_crossentropy",
                                    sparse_table_updates=m["sparse"])
                check(not graphed._graphs, "%s: graphs kept after %s"
                      % (label, change))
                graph_vs_eager_predict(graphed, X, B, "%s after %s"
                                       % (label, change), m["predict"])
                loop_fit(graphed, X, y, B)
                check_same_state(training_state(graphed), first,
                                 "%s: re-captured after %s" % (label, change))
            log("graphed fit %s re-captured after set_weights and after "
                "compile: bit-equal to the first fit" % label)
        del graphed, eager
        torch.cuda.empty_cache()


def run_ms(fn, runs=LOOP_RUNS):
    """Per-run ms of ``fn`` by CUDA events, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def rate_line(n, times):
    """examples/s: the median, and the spread over the runs."""
    rates = sorted(n / t * 1e3 for t in times)
    return "%r examples/s (median of %d; %r-%r)" % (
        statistics.median(rates), len(rates), rates[0], rates[-1])


def profile_launches(fn):
    """(device busy ms or None, kernels launched) of ``fn`` by
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    rows = [(ev.self_device_time_total, ev.count)
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy = sum(us for us, _ in rows) / 1e3
    return (busy if busy > 0 else None), sum(c for _, c in rows)


def loop_timing(label, model, X, y, B):
    """The device-resident loop against the host-array loop on the same
    data, alternating, bf16: examples/s, device busy and idle share,
    kernels a step (the profiler's count; the port's own by their
    counters), graph replays a step, host ms a step."""
    steps = X.shape[0] // B
    n = X.shape[0]
    x_host = X.cpu().numpy()

    def device_fit():
        model.fit(X, y, batch_size=B, epochs=1, verbose=0)

    def host_fit():
        model.fit(x_host, y, batch_size=B, epochs=1, verbose=0)
    device_fit()
    host_fit()
    times = {"device": [], "host": []}
    for _ in range(LOOP_RUNS):
        for name, fn in (("device", device_fit), ("host", host_fit)):
            times[name] += run_ms(fn, runs=1)
    reset_counts()
    graphs.GRAPH_REPLAYS = 0
    device_fit()
    counts = read_counts()
    replays = graphs.GRAPH_REPLAYS
    loop = [g for k, g in model._graphs.items() if k[0] == "fit"][0]
    gen = torch.Generator(device=X.device).manual_seed(SEED)
    host_ms = []
    for _ in range(LOOP_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.run_epoch(gen)
        host_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        torch.cuda.synchronize()
    out = {}
    for name, fn in (("device", device_fit), ("host", host_fit)):
        busy, kernels = profile_launches(fn)
        wall = statistics.median(times[name])
        out[name] = dict(busy=busy, kernels=kernels, wall=wall)
        log("fit bf16 %s, %s loop, %d steps of %d: %s; device busy %s; %r "
            "device operations a step (profiler: kernels and copies)" % (
                label, "device-resident" if name == "device" else
                "host-array", steps, B, rate_line(n, times[name]),
                busy_line(busy, wall), kernels / steps))
    host_step = statistics.median(
        t / steps for t in times["host"])
    log("fit bf16 %s: device loop %r graph replays a step, port kernels a "
        "step %s, host ms a step (enqueueing an epoch) %r (runs %s); "
        "host-array loop %r ms a step of wall time; device busy a step "
        "%r ms (device loop) vs %r ms (host-array loop, eager steps)"
        % (label, replays / steps,
           {k: v / steps for k, v in counts.items() if v},
           statistics.median(host_ms), host_ms, host_step,
           (out["device"]["busy"] or float("nan")) / steps,
           (out["host"]["busy"] or float("nan")) / steps))
    return out


def predict_timing(label, model, X, B):
    """Graphed predict against the eager forward on the same batches,
    bf16: examples/s and device busy."""
    n = X.shape[0]
    fns = {"graphed": lambda: model.predict(X, B),
           "eager": lambda: eager_predict(model, X, B)}
    times = {k: [] for k in fns}
    for k, fn in fns.items():
        fn()
    for _ in range(LOOP_RUNS):
        for k, fn in fns.items():
            times[k] += run_ms(fn, runs=1)
    parts = []
    for k, fn in fns.items():
        busy, kernels = profile_launches(fn)
        wall = statistics.median(times[k])
        parts.append("%s %s, device busy %s, %r device operations a "
                     "batch" % (
            k, rate_line(n, times[k]), busy_line(busy, wall),
            kernels / -(-n // B)))
    log("predict bf16 %s, %d batches of %d: %s" % (
        label, -(-n // B), B, "; ".join(parts)))


def phase_loops_timing_bf16(device):
    """phase 21: each loop at bf16 beside the host-array loop and the
    eager forward in the same call."""
    log("timing on: %s" % card_line())
    pt.set_compute_dtype("bfloat16")
    for label, m in loop_models(device).items():
        model = m["make"]()
        model.compile("adagrad", "binary_crossentropy",
                      sparse_table_updates=m["sparse"])
        X, B = m["X"], m["B"]
        if label.startswith("DeepFM") or label.startswith("DIEN"):
            predict_timing(label, model, X, B)
        loop_timing(label, model, X, m["y"], B)
        del model
        torch.cuda.empty_cache()


# the zoo (ROADMAP section 1 item 5) at bench.py's Criteo layout
# (bench.py:28-36: 26 fields of 10,000 rows, E=16, 13 dense fields,
# batches of 4096, adagrad), each model at its JAX constructor's defaults
# but PNN, which runs both product layers (use_outter, kernel "mat"); and
# DCN at the 26 Criteo Kaggle cardinalities (bench.py:43-46), where
# adagrad's "auto" puts 8 tables on the sparse path
ZOO = {"WDL": (WDL, {}), "NFM": (NFM, {}), "DCN": (DCN, {}),
       "DCNMix": (DCNMix, {}), "AutoInt": (AutoInt, {}), "AFM": (AFM, {}),
       "FiBiNET": (FiBiNET, {}), "PNN": (PNN, {"use_outter": True})}
ZOO_KAGGLE = "DCN Criteo Kaggle"
ZOO_EMB_STD = 0.3
ZOO_STEPS = 3           # phase 23's graphed fits: 3 x 4096


def zoo_model(name, device):
    """A zoo model (``ZOO``, or DCN at the Kaggle cardinalities for
    ``ZOO_KAGGLE``) with its weights redrawn from a seed so that
    predictions spread: the tables (deep and wide columns) from
    normal(0.3), the DNN's kernels at 1/sqrt(fan_in); the interaction
    layers and the head at their init.  AFM's deep columns are the sparse
    ones (its interaction takes no dense field); PNN takes only deep
    columns."""
    kaggle = name == ZOO_KAGGLE
    cols = criteo_columns() if kaggle else xdeepfm_columns()
    cls, kw = ZOO["DCN" if kaggle else name]
    if cls is PNN:
        model = cls(cols, seed=SEED, device=device, **kw)
    else:
        deep = ([c for c in cols if isinstance(c, pt.SparseFeat)]
                if cls is AFM else cols)
        model = cls(cols, deep, seed=SEED, device=device, **kw)
    gen = torch.Generator(device=device).manual_seed(SEED + 600)
    with torch.no_grad():
        for key, p in model.named_parameters():
            if key.startswith("dnn.") and p.dim() == 2:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif "embedding_dict" in key:
                p.normal_(0.0, ZOO_EMB_STD, generator=gen)
    return model


def zoo_requests(name, n, seed, device):
    if name == ZOO_KAGGLE:
        return criteo_requests(
            n, torch.Generator(device=device).manual_seed(seed), device)
    return xdeepfm_requests(n, seed, device)


def zoo_loop_models(device, steps):
    """The zoo's models in ``loop_models``' form, ``steps`` batches each:
    tables dense under "auto" (one gather and one scatter a step), but
    DCN Kaggle's 8 sparse tables (and one ``row_update`` a step)."""
    out = {}
    for i, name in enumerate(list(ZOO) + [ZOO_KAGGLE]):
        sparse = name == ZOO_KAGGLE
        out[name] = dict(
            make=lambda name=name: zoo_model(name, device),
            X=zoo_requests(name, BATCH * steps, SEED + 610 + i, device),
            B=BATCH, sparse="auto",
            y=criteo_labels(BATCH * steps, SEED + 630 + i),
            predict={"gather_rows": 1},
            fit={"gather_rows": 1, "scatter_add_rows": 1,
                 "row_update": int(sparse)})
    return out


def phase_zoo_f32(device):
    """phase 22: each zoo model's predict at float32, graphed: 8 batches
    of 4096, one gather a batch, every prediction finite and in (0, 1),
    the first batch within 1e-5 of the same model on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_compute_dtype("float32")
    n = BATCH * N_BATCHES
    for i, name in enumerate(list(ZOO) + [ZOO_KAGGLE]):
        model = zoo_model(name, device)
        X = zoo_requests(name, n, SEED + 650 + i, device)
        reset_counts()
        pred = model.predict(X, batch_size=BATCH)
        counts = read_counts()
        check(counts["gather_rows"] == N_BATCHES, "%s predict: %d gathers "
              "in %d batches" % (name, counts["gather_rows"], N_BATCHES))
        check_predictions(pred, n)
        model.to("cpu")
        pred_cpu = model.predict(X[:BATCH].cpu(), batch_size=BATCH)
        diff = float(np.abs(pred[:BATCH] - pred_cpu).max())
        check(diff <= ATOL_CPU, "%s: card vs CPU max |dp| %r > %r"
              % (name, diff, ATOL_CPU))
        log("predict f32 %s: %d requests in %d batches, launches %s, "
            "predictions in [%.6f, %.6f], std %.6f; first batch vs CPU max "
            "|dp| = %r (atol %r)" % (name, n, N_BATCHES, counts, pred.min(),
                                     pred.max(), pred.std(), diff, ATOL_CPU))
        del model
        torch.cuda.empty_cache()


def phase_zoo_loops_f32(device):
    """phase 23: phase 20's checks for each zoo model, ZOO_STEPS steps."""
    loops_f32(zoo_loop_models(device, ZOO_STEPS))


def zoo_timing(label, model, X, y, B):
    """Device-loop fit and graphed predict at bf16: examples/s (median of
    LOOP_RUNS, alternating, with the spread), device busy and idle share,
    and the device time by kernel of one replayed train step."""
    n, steps = X.shape[0], X.shape[0] // B
    fns = {"fit": lambda: model.fit(X, y, batch_size=B, epochs=1,
                                    verbose=0),
           "predict": lambda: model.predict(X, B)}
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(LOOP_RUNS):
        for k, fn in fns.items():
            times[k] += run_ms(fn, runs=1)
    out = {}
    for k, fn in fns.items():
        busy, kernels = profile_launches(fn)
        wall = statistics.median(times[k])
        out[k] = dict(rate=n / wall * 1e3, busy=busy, wall=wall)
        log("%s bf16 %s, %d %s of %d: %s; device busy %s; %r device "
            "operations a %s" % (
                "fit (device-resident loop)" if k == "fit" else
                "predict (graphed)", label, steps,
                "steps" if k == "fit" else "batches", B,
                rate_line(n, times[k]), busy_line(busy, wall),
                kernels / steps, "step" if k == "fit" else "batch"))
    loop = [g for key, g in model._graphs.items() if key[0] == "fit"][0]
    # the profiler now and then records none of a lone replay's kernels:
    # a second profile of the same step then reads them
    for _ in range(2):
        model._begin_steps(1)
        if profile_ms(loop.captured.replay,
                      "%s one replayed train step" % label) is not None:
            break
    return out


def phase_zoo_timing_bf16(device):
    """phase 24: each zoo model, and DCN Kaggle, timed at bf16."""
    log("timing on: %s" % card_line())
    pt.set_compute_dtype("bfloat16")
    for label, m in zoo_loop_models(device, LOOP_STEPS).items():
        model = m["make"]()
        model.compile("adagrad", "binary_crossentropy",
                      sparse_table_updates=m["sparse"])
        zoo_timing(label, model, m["X"], m["y"], m["B"])
        del model
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    if Path(pt.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: deepctr_tpu_torch must come from this checkout, "
              "not %s" % pt.__file__, file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda")
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))

    phase_build()

    t0 = time.perf_counter()
    cols = criteo_columns()
    model = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                   seed=SEED, device=device)
    n_rows = sum(CRITEO_KAGGLE_VOCABS)
    log("DeepFM built on %s in %.2f s: %d table rows, %.3f GB of tables"
        % (device, time.perf_counter() - t0, n_rows,
           sum(t.numel() * 4 for t in model.embedding_dict.tables.values())
           / 1e9))
    generator = torch.Generator(device=device).manual_seed(SEED)
    X_all = criteo_requests(BATCH * N_BATCHES, generator, device)

    err = phase_kernel_vs_plain(model, X_all[:BATCH])
    phase_predict_f32(model, X_all)
    timing = phase_timing_bf16(model, X_all)

    k1_err, k2_err = phase_train_kernels_vs_plain(model, X_all[:BATCH])
    phase_fit_f32(model, X_all)
    phase_fit_card_vs_cpu(X_all)
    train_timing = phase_train_timing_bf16(model, X_all)
    del model, X_all
    torch.cuda.empty_cache()

    seq_errs = phase_seq_kernels_vs_plain(device)
    for kind, variant, per_batch in (
            ("dien", "GRU", {"gru_scan": 2, "din_attention": 1}),
            ("dien", "AUGRU", {"gru_scan": 2, "din_attention": 0}),
            ("din", "dice", {"gru_scan": 0, "din_attention": 0}),
            ("din", "sigmoid", {"gru_scan": 0, "din_attention": 1})):
        phase_seq_predict_f32(kind, variant, per_batch, device)
    seq_timing = phase_seq_timing_bf16(device)

    seq_errs["gru_scan_bwd"] = phase_gru_bwd_vs_plain(device)
    for kind, variant in SEQ_TRAIN_LAUNCHES:
        phase_seq_fit_f32(kind, variant, device)
    phase_seq_fit_sparse(device)
    for kind, variant in SEQ_TRAIN_LAUNCHES:
        phase_seq_fit_card_vs_cpu(kind, variant, device)
    seq_timing["gru_scan_bwd"] = phase_seq_train_timing_bf16(device)
    torch.cuda.empty_cache()

    cin_err = phase_cin_vs_plain(device)
    phase_xdeepfm_f32(device)
    cin_timing = phase_xdeepfm_timing_bf16(device)
    torch.cuda.empty_cache()
    scatter = phase_static_scatter(device)
    torch.cuda.empty_cache()

    phase_loops_f32(device)
    phase_loops_timing_bf16(device)
    torch.cuda.empty_cache()

    phase_zoo_f32(device)
    phase_zoo_loops_f32(device)
    phase_zoo_timing_bf16(device)

    log(card_line())
    measured = {"gather_rows": dict(max_abs_err=err, **timing),
                "scatter_add_rows": dict(max_abs_err=k1_err,
                                         **train_timing["scatter_add_rows"]),
                "row_update": dict(max_abs_err=k2_err,
                                   **train_timing["row_update"])}
    for name in ("gru_scan", "gru_scan_bwd", "din_attention"):
        measured[name] = dict(max_abs_err=seq_errs[name], **seq_timing[name])
    measured["cin_mix"] = dict(max_abs_err=cin_err, **cin_timing)
    measured["static_scatter"] = scatter
    kernels = []
    for name in KERNELS:
        check(MAIN_PATH_LAUNCHES[name] > 0, "%s never launched on the main "
              "path" % name)
        kernels.append(dict(name=name, launches=MAIN_PATH_LAUNCHES[name],
                            **measured[name], **KERNELS[name]))
    log("chip_smoke: %.1f s in all" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
