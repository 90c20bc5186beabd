"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths, DeepFM (also streamed from a hashed Criteo
file, served from an exported artifact and trained and served on a mesh of
ranks, ``parallel/``), xDeepFM and the zoo (WDL, NFM, DCN,
DCNMix, AutoInt, AFM, FiBiNET, PNN, ONN, CCPM, AFN, IFM, DIFM, MLR, and
the multi-task SharedBottom, ESMM, MMOE and PLE) serving and training at
Criteo width and DIN/DIEN serving and training at the sequence bench's
width, through the entry points a user calls (``DeepFM(...)``,
``xDeepFM(...)``, ``DCN(...)`` and the other zoo models, ``MMOE(...)``
and the other multi-task models, ``DIN(...)``, ``DIEN(...)``,
``model.predict``, ``model.compile``, ``model.fit``, ``model.evaluate``,
``save_checkpoint``/``load_checkpoint``, ``save``/``load_model``,
``ModelCheckpoint``, ``fit(x=criteo_stream(...))``,
``serving.export_predict``/``save_exported``/``load_exported``), and the
scatter micro-benchmark (``python -m
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
   300 fields (more than a block stages), and the zoo's widths over
   B=4096 x 26 fields: 400 (ONN's pair tables), 1 (MLR's linear models)
   and 16 (the multi-task models' tables, no wide column);
3. DeepFM predict, float32: the 26 real Criteo vocabularies (33.8M rows),
   13 dense fields, DNN 400-400-400, weights drawn at std 0.05 from a
   seed; 8 batches of 4096 requests through the kernel (its launch count
   must rise), every prediction finite and in [0, 1], and the first batch
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
   (``launch_plan``) counts; then both at the zoo's train shapes, built by
   the models' own train steps at B=4096: ``scatter_add_rows`` into ONN's
   26 pair-table gradients ([10,000, 400] each), into one of MLR's linear
   models (26 of [10,000, 1]) and into MMOE Kaggle's tables (W=16, 8
   sparse, 18 dense), and ``row_update`` on MMOE Kaggle's touched rows of
   its 8 sparse W=16 tables;
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
    prediction finite and in [0, 1], the first batch within 1e-5 of the
    same model on the CPU (whose attention readout runs the fused
    operator's plain version);
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
    gather a batch), every prediction finite and in [0, 1], the first
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

Then the zoo: WDL, NFM, DCN, DCNMix, AutoInt, AFM, FiBiNET, PNN, ONN,
CCPM, AFN, IFM, DIFM, MLR and the multi-task SharedBottom, ESMM, MMOE and
PLE (two binary tasks, labels drawn from the seed, the second implying the
first, trained with a loss list) at ``bench.py``'s Criteo layout (26
fields of 10,000 rows with E=16, 13 dense fields, batches of 4096,
adagrad; each at its constructor's defaults, PNN with both product
layers), and DCN and MMOE at the 26 Criteo Kaggle cardinalities (33.8M
rows; 8 tables on the sparse path), tables (ONN's pair tables too) drawn
at std 0.3 and DNN kernels (the stacked experts' too) at 1/sqrt(fan_in)
from a seed:

22. float32: graphed ``predict`` of 8 batches (one gather a batch; ONN
    two, its shared rows and its pair tables; MLR eight, one for each of
    its linear models), every prediction finite and in [0, 1] ([N, 2] for
    the multi-task models), the first batch within 1e-5 of the same model
    on the CPU; for the multi-task models ``evaluate`` with ``auc`` and
    ``binary_crossentropy``: a ``<task>_<metric>`` key for each task and
    the bare metric their mean;
23. float32: phase 20's checks, 3 steps each: graphed ``predict`` and the
    device-resident ``fit`` bit-equal to the eager forward and to the same
    steps on a twin (losses, weights, every optimizer and table state),
    no host sync in any step or replay, each model's gathers and as many
    scatters a step and, for the Kaggle runs only, one ``row_update``;
24. timing, bfloat16: the device-resident ``fit`` (8 x 4096) and graphed
    ``predict`` in examples/s (median of 5, alternating, with the
    spread), device busy and idle share, and the device time by kernel of
    one replayed train step (``torch.profiler``).

Then the rest of the engine:

25. ``cin_mix`` with bfloat16 operands and a float32 output (the CIN's
    ``carry`` mode) against ``cin_mix_ref(out_dtype=float32)`` at both
    xDeepFM layers (B=4096), a ragged B=1000 and H=1000 (the FMA route):
    within 1e-5 of sum_k |w z|, a repeat bit-equal; its device ms with a
    cold L2 (median of 20) beside the bfloat16-output route's, and its
    bound;
26. checkpoint resume at Criteo width (DeepFM, 26 x 10,000 rows, DNN
    400-400-400, B=4096, ``dnn_dropout=0.5``, every table sparse), adagrad
    and adam: two epochs of 4 steps through the device-resident loop
    (shuffled) against one epoch, ``save_checkpoint``, a fresh model's
    ``load_checkpoint`` and ``fit(initial_epoch=1)``: bit-equal weights,
    dense and table optimizer states and step counts; one gather,
    scatter and ``row_update`` a step;
27. a checkpoint at the Criteo Kaggle size (DeepFM, 33.8M rows, adagrad
    "auto", ``dnn_dropout=0.5``) after 2 steps: the loaded state and the
    next step of both models bit-equal; the file's bytes and the seconds
    to save and to load; the file deleted;
28. dropout in the graphed loops, float32: DeepFM Kaggle (phase 27's
    twins) and DIEN AUGRU+neg at the sequence bench (adam, tables sparse,
    ``dnn_dropout=0.6``), 3 steps graphed against 3 eager steps on the
    twin, bit for bit, no host sync in a step; every mask recorded: the
    graphed ones equal the eager ones, each step draws a new one, the keep
    fraction within 5 sigma of 1 - rate; then both in bf16 beside the same
    model at rate 0 (examples/s, median of 5, alternating, with the
    spread);
29. ``save`` and ``load_model`` on the card for DIN sigmoid (the fused
    attention at inference), xDeepFM and DCN: the loaded model's graphed
    ``predict`` bit-equal to the saved one's; DeepFM at Criteo width
    through the device-resident loop with ``EarlyStopping`` and
    ``ModelCheckpoint(save_best_only=True)``, the best epoch's file
    reloaded;
30. optimizer objects, DeepFM at Criteo width: ``torch.optim.Adam(...,
    capturable=True)`` captured, ``torch.optim.Adagrad`` (no such option)
    run eagerly on the card with one warning, each bit-equal to the same
    steps through ``_train_step`` on a twin; each route's examples/s in
    bf16;
31. the CIN's modes, xDeepFM at Criteo width (CIN 256-128, DNN 400-400,
    B=4096), bf16 compute: under ``bf16``, ``carry`` and ``f32`` the
    graphed fit bit-equal to eager steps on a twin, 2 ``cin_mix``
    launches a step; then one model's device-loop fit in each mode
    (alternating; the mode is part of a graph's key): examples/s and
    device busy ms a step.

Then hashing, streaming and serving:

32. the streamed fit: a Criteo-format TSV of 262,144 rows written from the
    seed (label, 13 counts, 26 hex ids drawn over the Criteo Kaggle
    cardinalities, some fields empty) and deleted afterwards; DeepFM at
    ``criteo_columns(vocab_size=1_000_000)`` (26 x 1M x 17 float32, every
    table on the sparse path), adagrad, ``fit(x=criteo_stream(path,
    chunk_rows=65536), batch_size=4096)``; the native batcher's numpy
    versions refused throughout.  float32, the first 2 chunks: bit-equal
    to a twin's device-resident fits of the same chunks, then under sgd
    within 1e-5 (relative) of the CPU port from the same weights.  bf16,
    2 epochs: the gather, K1 and K2 once a step, a capture for each chunk
    geometry and replays after, no host sync in a step or replay; then
    examples/s (median of 3, alternating, with the spread), device busy
    and idle share beside the device-resident ``fit`` of the same rows,
    and the host half's ms a chunk;
33. serving: the Criteo Kaggle DeepFM of phases 3-8 exported with a
    symbolic batch (``serving.export_predict``) and saved, then loaded and
    run in a fresh process that builds no model and no columns, on
    batches of 1, 4096 and 4097 handed over in a ``.npy`` file: within
    1e-5 of in-process ``predict`` (and whether bit-equal), the gather
    launched once a batch; the artifact's bytes, export, save and load
    seconds, and its ms a batch at 4096 beside the graphed predict's;
    then DIN sigmoid, DIEN GRU (maxlen 100) and xDeepFM (CIN 256-128)
    exported, saved and loaded in process: each kernel's launches inside
    the artifact (the gather, ``din_attention``, ``gru_scan``,
    ``cin_mix``), within 1e-5 of ``predict`` and of the artifact of a
    CPU twin, whose operators run the kernels' plain versions.

Then the mesh (``deepctr_tpu_torch/parallel/``), float32:

34. a. one rank under NCCL in this process (``distributed.initialize``
    through a file store, ``make_mesh((1, 1))``): the Criteo Kaggle
    DeepFM with ``shard_embeddings=True`` (every table a one-rank block),
    adagrad "auto", 3 fit steps of 4096 (eager: no graph under a mesh)
    and predict of 8 batches (32,768 rows), bit for bit the same model
    without a mesh
    (graphed), every table and state too; the gather, K1 and K2 once a
    step; ms an eager step.  Then the gather's shard-local zero-fill mode
    at the Kaggle shape (B=4096, the 26 tables cut into the blocks of a
    (1, 2) mesh) bit-equal to its plain version on both blocks, and its
    device ms beside the NaN mode's and the plain version's;
    b. two ranks on the one card (``tools/multiprocess_sim.spawn``, gloo
    with CUDA tensors: NCCL refuses two ranks on one device): the Kaggle
    DeepFM at (1, 2) with its tables sharded, under the psum exchange
    (sgd and adagrad) and a2a at slack 8 (sgd); at (2, 1), data parallel
    (sgd, adagrad); DIN with Dice at the sequence bench's width (maxlen
    100, B=1024) at (2, 1) (sgd, adagrad); DIEN AUGRU with negative
    sampling at that width at (2, 1) (adagrad, its three tables on the
    sparse path: ``gru_scan`` and ``gru_scan_bwd`` twice a step on each
    rank, the GRU kernels under a mesh), then DIEN ``GRU``'s predict on
    the same mesh (``gru_scan`` twice and ``din_attention`` once a batch)
    within 1e-5 of one process; PLE at the zoo's Criteo width at (1, 2)
    with its 26 tables sharded (adam: the stacked experts over row-sharded
    tables); each 3 steps and predict, the
    ranks' predictions alike and within 1e-5 (sgd) or 1e-4 (adagrad,
    adam) of the same steps in this process without a mesh, each rank's
    touched rows of its block within ``MESH_BLOCK_TOL``; per rank its
    bytes of tables and state, K2 launches and ms a step (gloo through
    the host: not a scaling figure).  Beside each data-parallel leg, the
    same steps in this process with each batch's halves swapped (what the
    two data ranks change: the order the half batches add in) against
    this process's unswapped steps, the size of float32 reordering alone;
    c. after the a2a leg, ids skewed onto rank 0's rows at slack 1.0:
    every prediction NaN under ``on_overflow="error"``, finite and alike
    on both ranks under ``"drop"``;
    d. two gloo ranks again: phase 32's streamed fit (the hashed Criteo
    TSV of 262,144 rows, 26 x 1M buckets all on the sparse path, adagrad,
    chunks of 65,536, B=4096), one epoch at (1, 2) with every table
    sharded and at (2, 1), against the same streamed fit in this process
    without a mesh: the ranks' losses alike, predictions of the stream's
    first 8,192 rows within 1e-4 and their touched rows within
    ``MESH_BLOCK_TOL``; per rank ms a chunk, device busy ms of a second,
    profiled epoch and the idle share, the host half's ms a chunk;
    e. the Kaggle DeepFM at (1, 2), sharded, after 34b's 3 sgd steps:
    ``serving.export_predict`` on both ranks, ``save_exported`` written
    by rank 0 alone, the artifact at least the whole tables' bytes,
    scored in a fresh process (no model, no mesh) at B = 1, 4096, 4097
    within 1e-5 of the mesh's ``predict``; export and save seconds;
    f. the Kaggle DeepFM at (1, 2), sharded, under
    ``torch.optim.Adagrad``: ``save_checkpoint`` after an epoch of 3
    steps, a second epoch, and a fresh model that loads the checkpoint
    and takes the second epoch bit for bit as the uninterrupted one
    (loss, predictions, every table, weight and optimizer state); the
    checkpoint's bytes, save and load seconds.

Then the rest of the feature set:

35. a. adam's per-row step count (``config.set_adam_t("rowwise")``) on
    the Criteo Kaggle DeepFM, named adam, "auto" (8 sparse tables): K2's
    rowwise mode against its plain version bit for bit (tables, m, v and
    t; counts drawn in [0, 40), untouched rows and counts unchanged) at
    the touched rows of a batch of 4096 and inside model rank 1's block of
    the ``(1, 2)`` mesh (the tables that shard, ``shard_local_rows``);
    then 3 captured steps (graphed device loop, float32) bit-equal to the
    same steps with K2 replaced by ``row_update_ref``; K2's device ms in
    rowwise and table mode at the touched rows of a batch, beside their
    bytes bounds (rowwise: 8 more bytes a touched row and the table of
    pairs); the device-loop fit (bf16, 8 x 4096) in both modes, median of
    5 alternating runs with the spread, measured and not held;
    b. Dice and PReLU with parameters, float32: xDeepFM with
    ``cin_activation`` ``"dice"`` and ``"prelu"`` at CIN 256-256, MMOE and
    PLE with ``dnn_activation="dice"`` at Criteo width, the activations'
    parameters and Dice's statistics drawn from the seed: graphed predict
    of 8 batches (xDeepFM: ``cin_mix`` twice a batch), the first batch
    within 1e-5 of the CPU; 2 sgd steps of 512 on the card and the CPU from
    the same weights, losses within 1e-5 relative, the predictions after
    within 1e-5 (xDeepFM's fit: ``cin_mix`` twice a step);
    c. the seven example recipes (``deepctr_tpu_torch/examples/``) called
    in process as ``main(epochs=1, device="cuda")``, each printing its
    metrics (finite, but the AUC of a batch of one class) and its
    launches (the gather and K1 in every one, K3 and K5 in DIEN's).

36. the dense parameters' optimizer step in one launch
    (``ops.dense_update``): ``dense_update`` against ``dense_update_ref``
    bit for bit, 3 steps, for sgd, adagrad, rmsprop and adam, at the dense
    parameters of the benchmark's DeepFM and DIEN (``portbench/configs``)
    with the L2 vectors their compiled rules give the dense optimizer
    (DeepFM's 19, DIEN none) and at three times DIEN's with drawn ones
    (past a launch's capacity, every third array one float past a 16-byte
    boundary), every fourth gradient None, each call with the launches
    its plan counts; adam's device ms with a cold L2 at each model's
    shapes, the kernel alone, the whole call and the chain of PyTorch
    operations it replaced, with the device operations of each, beside
    the bytes bound (28 bytes a float).  Then the penalty's launch
    (``dense_penalty``) at DeepFM's: two calls bit-equal, within 1e-6 of
    a float64 sum; its device ms beside its plain version, the eager
    autograd penalty it replaced (value and gradient, one term a rule)
    and the bytes bound (4 a float).  Phase 20's graphed DeepFM and DIEN
    loops launch the step once a step, DeepFM's the penalty too.
37. the CIN backward's kernels (``ops.cin.bwd_launch``: the tiles of g,
    wt, hid and x, the data and weight products, the partials' sum) at the
    benchmark xDeepFM's layer shapes (B=4096, E=10, F=26, H 26 and 200 to
    200 maps) against a float64 evaluation from the same bfloat16 inputs:
    dh, dx and dwt each no further off than the einsums they replace
    (``cin_mix_bwd``) plus one bf16 ulp of the sum of the terms'
    magnitudes, a repeat bit-equal; device ms with a cold L2 of both at
    each shape and over the three layers, beside the bound (the two
    products at the bf16 rate, 0.367 ms); a bf16 step of the cell's CIN
    launches the kernels 7 times a layer and takes no einsum.

The command's total seconds are printed before the kernels line.

Launches in the kernels line are those of the main-path runs (phases 3,
6, 10, 11, 14, 17, 20, 22, 23, 26, 28, 29, 30, 31, 32, 33, 34 and 35, the
two ranks' counted in their processes and added here; for
``static_scatter``, the micro-benchmark's run in phase 19), each counted
from 0 just before the run and read just after; the runs that compare a
kernel with its plain version, time it or check the card against the CPU
are not counted.  A graph replay adds the launches its capture recorded.
``artifact_launches`` counts the launches inside exported artifacts
(phase 33), ``mesh_launches`` those on the ranks of a mesh (phases
34b-f); ``launches`` includes both.

Any failure exits non-zero.  Without a CUDA device it fails at once and
runs nothing on the CPU.  The last two lines before the final one are the
card (``nvidia-smi`` name and power limit) and a JSON line describing each
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import json
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import deepctr_tpu_torch as pt  # noqa: E402
from deepctr_tpu_torch import callbacks as pcb  # noqa: E402
from deepctr_tpu_torch import native, serving  # noqa: E402
from deepctr_tpu_torch.models import (  # noqa: E402
    AFM, AFN, CCPM, DCN, DIEN, DIFM, DIN, IFM, MLR, NFM, ONN, PNN, WDL,
    AutoInt, DCNMix, DeepFM, FiBiNET, xDeepFM)
from deepctr_tpu_torch.models.multitask import (  # noqa: E402
    ESMM, MMOE, PLE, SharedBottom)
from deepctr_tpu_torch.models import graphs  # noqa: E402
from deepctr_tpu_torch.layers import core as pcore  # noqa: E402
from deepctr_tpu_torch.layers.sequence import (  # noqa: E402
    AttentionSequencePoolingLayer)
from deepctr_tpu_torch.ops import _build  # noqa: E402
from deepctr_tpu_torch.ops._args import DeviceArgs  # noqa: E402
from deepctr_tpu_torch.ops import attention  # noqa: E402
from deepctr_tpu_torch.ops import cin  # noqa: E402
from deepctr_tpu_torch.ops import dense_update  # noqa: E402
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
SEQ_STEP_KERNELS = {
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
XD_STEP_KERNELS = {"gather_rows": 1, "scatter_add_rows": 1, "cin_mix": 2,
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
    "dense_update": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/dense_update.cu",
        "replaces": "none: the dense optimizer step, left to optax and "
                    "XLA in the JAX package",
    },
    "dense_penalty": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/dense_update.cu",
        "replaces": "none: the dense parameters' L2 penalty, an autograd "
                    "term under XLA in the JAX package",
    },
    "cin_mix_bwd": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/cin_mix_bwd.cu",
        "replaces": "none: the CIN kernel's backward, XLA einsums in the "
                    "JAX package (deepctr_tpu/ops/pallas.py:104)",
    },
}

# each kernel's launches, by the names of KERNELS
LAUNCHES = _build.LAUNCHES
# the launches of every main-path run, summed (read_counts adds to it)
MAIN_PATH_TOTALS = dict.fromkeys(KERNELS, 0)
# of those, the launches on the ranks of a mesh (phases 34b-f)
MESH_TOTALS = dict.fromkeys(KERNELS, 0)


def log(msg):
    print(msg, flush=True)


def reset_counts():
    """Every kernel's launch count to 0, just before a main-path run."""
    for name in KERNELS:
        LAUNCHES[name] = 0


def add_rank_counts(counts):
    """A mesh rank's launches (counted in its process) into the totals."""
    for name, n in counts.items():
        MAIN_PATH_TOTALS[name] += n
        MESH_TOTALS[name] += n


def read_counts():
    """The launches since reset_counts(), just after a main-path run;
    added to MAIN_PATH_TOTALS."""
    counts = {name: LAUNCHES[name] for name in KERNELS}
    for name, count in counts.items():
        MAIN_PATH_TOTALS[name] += count
    return counts


@functools.lru_cache(maxsize=None)
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


def check_predictions(pred, n, n_out=1):
    """Finite predictions of shape [n, n_out] in [0, 1], a float32
    sigmoid's range (it rounds to exactly 0 or 1 past |logit| ~ 17).
    Returns how many lie at exactly 0 or 1."""
    check(pred.shape == (n, n_out), "predictions of shape %s"
          % (pred.shape,))
    check(np.isfinite(pred).all(), "non-finite predictions")
    check(((pred >= 0) & (pred <= 1)).all(), "predictions outside [0, 1]")
    return int(((pred == 0) | (pred == 1)).sum())


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
# 32 generic), a pair count no multiple of 32 (77 x 3), more fields than a
# block stages, and the zoo's shapes at B=4096 over 26 fields: ONN's pair
# tables (W=400), MLR's linear models (W=1) and the tables without a wide
# column of the multi-task models (W=16)
GATHER_CASES = ((1, 3, 77, False), (8, 3, 77, False), (17, 3, 77, False),
                (32, 3, 77, False), (32, 3, 77, True), (33, 3, 77, False),
                (32, 300, 5, False), (400, 26, BATCH, False),
                (1, 26, BATCH, False), (16, 26, BATCH, False))


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
    ids = [X[:, c].to(torch.int32).to(torch.int64) for c in cols]
    timed = {
        "kernel": lambda: gather.gather_rows(X, tables, cols),
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
            X_sorted, tables, cols))
        warm_ms = device_ms(lambda: gather.gather_rows(
            X, tables, cols), cold=False)
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


def train_kernel_args(model, X, seed, prefix="embedding_dict/"):
    """Both train kernels' arguments as a train step of ``model`` builds
    them for the batch ``X`` and the gather of every table under
    ``prefix``: the touched rows of its sparse tables (None without any),
    a cotangent of the gather ([B, F, W], normal from ``seed``), and each
    field's target (a zero dense gradient, or the touched rows') and
    row."""
    touched = model._touched_rows(X) if model._sparse_specs else None
    plan = model._step_plan(X.shape[0])
    for g in plan.dense_grads.values():
        g.zero_()
    names = list(dict(model._table_holders())[prefix].tables)
    cols = [model.feature_index[n][0] for n in names]
    gen = torch.Generator(device=X.device).manual_seed(seed)
    targets, idx, _ = model._scatter_targets(X, prefix, names, cols,
                                             touched, plan)
    grad = torch.randn(X.shape[0], len(names), targets[0].shape[1],
                       generator=gen, device=X.device)
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
        before = LAUNCHES["row_update"]
        rowup.row_update(opt, kern_w, kern_s, *args)
        launches = LAUNCHES["row_update"] - before
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
        del case
        errs = zoo_train_kernels_vs_plain(X.device)
    return max(k1_err, errs[0]), max(k2_err, errs[1])


# phase 5's zoo cases: (zoo model, the tables whose gather is scattered)
ZOO_SCATTER_CASES = (("ONN", "second_order_embedding/"),
                     ("MLR", "region_linear_0/embedding_dict/"),
                     ("MMOE Criteo Kaggle", "embedding_dict/"))


def zoo_train_kernels_vs_plain(device):
    """Phase 5's checks at the zoo's new train shapes, from the models'
    own train steps (B=4096): scatter_add_rows into ONN's pair tables (26
    dense [10,000, 400] gradients), into one of MLR's linear models (26 of
    [10,000, 1]) and into MMOE Kaggle's tables (W=16: 8 sparse tables'
    touched rows, 18 dense); row_update on MMOE Kaggle's touched rows of
    its 8 sparse tables, their gradients normal.  Returns (K1, K2) max
    |err|."""
    k1_err = k2_err = 0.0
    for i, (name, prefix) in enumerate(ZOO_SCATTER_CASES):
        model = zoo_model(name, device)
        model.compile("adagrad", zoo_loss(name))
        X = zoo_requests(name, BATCH, SEED + 20 + i, device)
        touched, grad, targets, idx = train_kernel_args(model, X,
                                                        SEED + 23 + i, prefix)
        what = ("%s's %s tables (%d targets, %d of them sparse tables' "
                "touched rows)" % (name, prefix.rstrip("/"), len(targets),
                                   len(model._sparse_specs)))
        k1_err = max(k1_err, check_scatter_case(grad, targets, idx, what))
        if touched is not None:
            tables = model._tables()
            paths = [p for p, _, _ in model._sparse_specs]
            check(sorted(paths) == EXPECTED_SPARSE, "%s: sparse tables %s, "
                  "want %s" % (name, sorted(paths), EXPECTED_SPARSE))
            gen = torch.Generator(device=device).manual_seed(SEED + 26)
            for g in touched.grads:
                g.normal_(generator=gen)
            k2_err = max(k2_err, check_row_update_case(
                [tables[p].detach() for p in paths], touched.grads,
                touched.rows, [model._table_l2_vec(p) for p in paths],
                "%s's shape (%d sparse tables, W=%d, touched rows %s)" % (
                    name, len(paths), tables[paths[0]].shape[1],
                    valid_counts(touched.rows,
                                 [tables[p] for p in paths])),
                SEED + 27))
        del model, touched, grad, targets, idx
        torch.cuda.empty_cache()
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
        LAUNCHES["din_attention"] = 0
        got = layer(q, k, keys_length=lengths)
        launches = LAUNCHES["din_attention"]
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


def seq_model(kind, variant, device, **kw):
    """DIEN (``variant`` its gru_type; AUGRU with negative sampling, as
    bench.py runs it) or DIN (``variant`` its att_activation) at the bench
    width, with the constructor's further arguments ``kw``.  Every weight is redrawn from normal(0.3), seeded, but the
    prediction tower's (``dnn``, ``dnn_linear``) at 1/sqrt(fan_in), so that
    no float32 sigmoid saturates to exactly 1; Dice's running mean from
    normal(0.3), its variance from uniform[0.5, 1.5)."""
    if kind == "dien":
        neg = variant == "AUGRU"
        model = DIEN(seq_columns(neg), ["item_id", "cate_id"],
                     gru_type=variant, use_negsampling=neg,
                     dnn_hidden_units=SEQ_HIDDEN, att_hidden_units=SEQ_ATT,
                     seed=SEED, device=device, **kw)
    else:
        model = DIN(seq_columns(False), ["item_id", "cate_id"],
                    dnn_hidden_units=SEQ_HIDDEN, att_hidden_size=SEQ_ATT,
                    att_activation=variant, seed=SEED, device=device, **kw)
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
            ms = device_ms(lambda: gather.gather_rows(X, tables, cols))
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
    for name, per_step in SEQ_STEP_KERNELS[(kind, variant)].items():
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
    out = cin.CinMix.apply(leaves[0], leaves[1], w3, leaves[2])
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
    for name, per_step in XD_STEP_KERNELS.items():
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
    LAUNCHES["scatter_rows"] = 0
    records = scatter_micro.run(inp, repeats=SCATTER_REPEATS)
    counts = read_counts()
    for rec in records:
        print(json.dumps(rec), flush=True)
    log("scatter micro-benchmark on %s: static_scatter launches %d, dynamic "
        "launches %d" % (card_line(), counts["static_scatter"],
                         LAUNCHES["scatter_rows"]))

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
    y_dev = torch.as_tensor(y, device=X.device).view(X.shape[0], -1)
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
    times a batch; ``check_predictions``."""
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
    saturated = check_predictions(got, X.shape[0], model.num_tasks)
    if saturated:
        log("%s: %d of %d predictions at exactly 0 or 1" % (
            label, saturated, got.size))
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
            fit={"gather_rows": 1, "scatter_add_rows": 1, "row_update": 1,
                 "dense_update": 1, "dense_penalty": 1}),
        "DIEN AUGRU+neg, sparse tables": dict(
            make=dien, X=X_seq, B=SEQ_BATCH, sparse=True,
            y=seq_labels(SEQ_BATCH * LOOP_STEPS, SEED + 504),
            predict={"gather_rows": 1, "gru_scan": 2},
            fit={"gather_rows": 1, "scatter_add_rows": 1, "gru_scan": 2,
                 "gru_scan_bwd": 2, "row_update": 1, "dense_update": 1}),
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
            model.compile("adagrad", m.get("loss", "binary_crossentropy"),
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
        loop.run_epoch(gen, 0)
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


# the zoo (ROADMAP section 1 items 5 and 6) at bench.py's Criteo layout
# (bench.py:28-36: 26 fields of 10,000 rows, E=16, 13 dense fields,
# batches of 4096, adagrad), each model at its JAX constructor's defaults
# but PNN, which runs both product layers (use_outter, kernel "mat"); and
# DCN and MMOE at the 26 Criteo Kaggle cardinalities (bench.py:43-46),
# where adagrad's "auto" puts 8 tables on the sparse path.  AFM's and
# CCPM's deep columns are the sparse ones (their interactions take no
# dense field); PNN, MLR and the multi-task models take one column list.
ZOO = {"WDL": (WDL, {}), "NFM": (NFM, {}), "DCN": (DCN, {}),
       "DCNMix": (DCNMix, {}), "AutoInt": (AutoInt, {}), "AFM": (AFM, {}),
       "FiBiNET": (FiBiNET, {}), "PNN": (PNN, {"use_outter": True}),
       "ONN": (ONN, {}), "CCPM": (CCPM, {}), "AFN": (AFN, {}),
       "IFM": (IFM, {}), "DIFM": (DIFM, {}), "MLR": (MLR, {}),
       "SharedBottom": (SharedBottom, {}), "ESMM": (ESMM, {}),
       "MMOE": (MMOE, {}), "PLE": (PLE, {})}
ZOO_KAGGLE = ("DCN Criteo Kaggle", "MMOE Criteo Kaggle")
MULTITASK = (SharedBottom, ESMM, MMOE, PLE)
# the gathers of a forward, where not one: ONN's shared rows and its pair
# tables; one for each of MLR's linear models (4 regions, base = region);
# a train step scatters each gather's rows once
ZOO_GATHERS = {"ONN": 2, "MLR": 8}
ZOO_EMB_STD = 0.3
ZOO_STEPS = 3           # phase 23's graphed fits: 3 x 4096


def zoo_model(name, device, **extra):
    """A zoo model (``ZOO``, or one of ``ZOO_KAGGLE`` at the Kaggle
    cardinalities) with its weights redrawn from a seed so that
    predictions spread: the tables (deep and wide columns, ONN's pair
    tables, MLR's linear models') from normal(0.3), the DNN kernels (and
    the stacked experts') at 1/sqrt(fan_in); the interaction layers and
    the heads at their init.  ``extra``: further constructor arguments."""
    kaggle = name in ZOO_KAGGLE
    cols = criteo_columns() if kaggle else xdeepfm_columns()
    cls, kw = ZOO[name.split()[0]]
    kw = dict(kw, **extra)
    if cls in (PNN, MLR) + MULTITASK:
        model = cls(cols, seed=SEED, device=device, **kw)
    else:
        deep = ([c for c in cols if isinstance(c, pt.SparseFeat)]
                if cls in (AFM, CCPM) else cols)
        model = cls(cols, deep, seed=SEED, device=device, **kw)
    gen = torch.Generator(device=device).manual_seed(SEED + 600)
    with torch.no_grad():
        for key, p in model.named_parameters():
            if ".dense_" in key and p.dim() >= 2 and not key.endswith(
                    "bias"):
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif "embedding" in key:
                p.normal_(0.0, ZOO_EMB_STD, generator=gen)
    return model


def zoo_requests(name, n, seed, device):
    if name in ZOO_KAGGLE:
        return criteo_requests(
            n, torch.Generator(device=device).manual_seed(seed), device)
    return xdeepfm_requests(n, seed, device)


def zoo_labels(name, n, seed):
    """One label column, or two for a multi-task model: the first clicks,
    the second converts only where the first clicked (ESMM's ctcvr)."""
    y = criteo_labels(n, seed)
    if ZOO[name.split()[0]][0] not in MULTITASK:
        return y
    return np.stack([y, y * criteo_labels(n, seed + 1)], axis=1)


def zoo_loss(name):
    if ZOO[name.split()[0]][0] in MULTITASK:
        return ["binary_crossentropy", "binary_crossentropy"]
    return "binary_crossentropy"


def zoo_loop_models(device, steps):
    """The zoo's models in ``loop_models``' form, ``steps`` batches each:
    tables dense under "auto" (each gather's scatter a step), but the
    Kaggle runs' 8 sparse tables (and one ``row_update`` a step)."""
    out = {}
    for i, name in enumerate(list(ZOO) + list(ZOO_KAGGLE)):
        sparse = name in ZOO_KAGGLE
        gathers = ZOO_GATHERS.get(name, 1)
        # the label of every line the run prints names the card
        out["%s on %s" % (name, card_line())] = dict(
            make=lambda name=name: zoo_model(name, device),
            X=zoo_requests(name, BATCH * steps, SEED + 610 + i, device),
            B=BATCH, sparse="auto", loss=zoo_loss(name),
            y=zoo_labels(name, BATCH * steps, SEED + 630 + i),
            predict={"gather_rows": gathers},
            fit={"gather_rows": gathers, "scatter_add_rows": gathers,
                 "row_update": int(sparse)})
    return out


def check_task_metrics(model, X, y, name):
    """A multi-task model's ``evaluate`` on the card: a
    ``<task>_<metric>`` key for each task, the bare metric their mean."""
    metrics = ["auc", "binary_crossentropy"]
    model.compile("adagrad", zoo_loss(name), metrics=metrics)
    got = model.evaluate(X, y, batch_size=BATCH)
    want = set(metrics) | {"%s_%s" % (t, m) for t in model.task_names
                           for m in metrics}
    check(set(got) == want, "%s evaluate: keys %s, want %s"
          % (name, sorted(got), sorted(want)))
    for m in metrics:
        per_task = [got["%s_%s" % (t, m)] for t in model.task_names]
        check(np.isfinite(per_task).all() and abs(
            got[m] - np.mean(per_task)) <= 1e-12 * max(1.0, abs(got[m])),
              "%s evaluate: %s %r is not the mean of %r"
              % (name, m, got[m], per_task))
    log("evaluate f32 %s on %s: %s" % (name, card_line(), got))


def phase_zoo_f32(device):
    """phase 22: each zoo model's predict at float32, graphed: 8 batches
    of 4096, its gathers a batch, every prediction finite and in [0, 1],
    the first batch within 1e-5 of the same model on the CPU; each
    multi-task model's per-task ``evaluate``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_compute_dtype("float32")
    n = BATCH * N_BATCHES
    for i, name in enumerate(list(ZOO) + list(ZOO_KAGGLE)):
        model = zoo_model(name, device)
        X = zoo_requests(name, n, SEED + 650 + i, device)
        gathers = ZOO_GATHERS.get(name, 1)
        reset_counts()
        pred = model.predict(X, batch_size=BATCH)
        counts = read_counts()
        check(counts["gather_rows"] == gathers * N_BATCHES, "%s predict: %d "
              "gathers in %d batches" % (name, counts["gather_rows"],
                                         N_BATCHES))
        saturated = check_predictions(pred, n, model.num_tasks)
        if model.num_tasks > 1:
            reset_counts()
            check_task_metrics(model, X, zoo_labels(name, n, SEED + 670 + i),
                               name)
            read_counts()
        model.to("cpu")
        pred_cpu = model.predict(X[:BATCH].cpu(), batch_size=BATCH)
        diff = float(np.abs(pred[:BATCH] - pred_cpu).max())
        check(diff <= ATOL_CPU, "%s: card vs CPU max |dp| %r > %r"
              % (name, diff, ATOL_CPU))
        log("predict f32 %s on %s: %d requests in %d batches, launches %s, "
            "predictions in [%.6f, %.6f], std %.6f, %d at exactly 0 or 1; "
            "first batch vs CPU max |dp| = %r (atol %r)"
            % (name, card_line(), n, N_BATCHES, counts, pred.min(),
               pred.max(), pred.std(), saturated, diff, ATOL_CPU))
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
    """phase 24: each zoo model, and the Kaggle runs, timed at bf16."""
    log("timing on: %s" % card_line())
    pt.set_compute_dtype("bfloat16")
    for label, m in zoo_loop_models(device, LOOP_STEPS).items():
        model = m["make"]()
        model.compile("adagrad", m["loss"],
                      sparse_table_updates=m["sparse"])
        zoo_timing(label, model, m["X"], m["y"], m["B"])
        del model
        torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# the rest of the engine: the CIN kernel's float32 output, checkpoints,
# dropout in the graphed loops, load_model, optimizer objects, CIN modes
# ---------------------------------------------------------------------------

# phase 25: the float32-output route at the slice's layers (B=4096), a
# ragged B and bfloat16 rows too wide for the tensor cores (the FMA route)
CIN_F32_OUT_CASES = ((dict(B=BATCH, H=XD_LAYERS[0][0], O=XD_LAYERS[0][1])),
                     dict(B=BATCH, H=XD_LAYERS[1][0], O=XD_LAYERS[1][1],
                          split_of=XD_LAYERS[0][1]),
                     dict(B=1000, H=XD_LAYERS[0][0], O=XD_LAYERS[0][1]),
                     dict(B=64, H=1000, O=256))
# phases 26-28: the dropout rates of the runs (DeepFM's dnn_dropout in
# tests/models/DeepFM_test.py:26, DIEN's in examples/run_dien.py:66-69)
DEEPFM_DROPOUT = 0.5
DIEN_DROPOUT = 0.6
RESUME_STEPS = 4        # phase 26: steps an epoch of the resumed fits
DROPOUT_STEPS = 3       # phase 28: graphed steps against eager ones


def scratch_dir(name):
    """A directory for this run's files under the checkout's build
    directory (gitignored), emptied first."""
    path = HERE / "deepctr_tpu_torch" / "_build" / "chip_smoke" / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def phase_cin_f32_output(device):
    """phase 25: cin_mix with bfloat16 operands and a float32 output (the
    CIN's carry mode) against cin_mix_ref(out_dtype=float32): within 1e-5
    of sum_k |w z| (relative above 1), a repeat bit-equal; device ms with
    a cold L2 (median of 20) beside the bfloat16-output route's at both
    layers.  Returns the largest |kernel - plain| and the float32-output
    route's times and bounds."""
    err, seed, out = 0.0, SEED + 700, {}
    for case in CIN_F32_OUT_CASES:
        seed += 1
        hidden, x0, w3 = cin_inputs(dtype=torch.bfloat16, seed=seed,
                                    device=device, **case)
        wt, wm = cin.kernel_weights(w3, torch.bfloat16)
        with torch.no_grad():
            got = cin.cin_mix(hidden, x0, w3, wt=wt, wm=wm,
                              out_dtype=torch.float32)
            again = cin.cin_mix(hidden, x0, w3, wt=wt, wm=wm,
                                out_dtype=torch.float32)
            want = cin.cin_mix_ref(hidden, x0, w3, out_dtype=torch.float32)
        torch.cuda.synchronize()
        B, H, O = case["B"], case["H"], case["O"]
        what = ("cin_mix bf16 -> float32 B=%d H=%d O=%d, %s route"
                % (B, H, O, cin.route(torch.bfloat16, H, XD_FIELDS, O)))
        check(got.dtype == torch.float32, what + ": output %s" % got.dtype)
        check(bits_equal(got, again), what + ": a repeat gave other bits")
        e, a = compare(got, want, what, cin_scale(hidden, x0, w3))
        err = max(err, a)
        log("kernel vs plain: %s: max |err| / max(1, sum_k |w z|) %r; max "
            "|err| %r; repeat bit-equal" % (what, e, a))
        if B != BATCH:
            continue
        times = {}
        for name, dtype in (("float32 out", torch.float32),
                            ("bf16 out", None)):
            times[name] = device_ms(lambda dtype=dtype: cin.cin_mix(
                hidden, x0, w3, wt=wt, wm=wm, out_dtype=dtype))
        bound_ms, bound_by = cin_bound(B, H, O, 2, BF16_FLOP_PER_S)
        out["layer H=%d O=%d" % (H, O)] = dict(ms=times["float32 out"],
                                               bound_ms=bound_ms)
        log("cin_mix bf16 operands, B=%d H=%d O=%d: float32 output %r ms, "
            "bfloat16 output %r ms (device, cold L2, median of 20); bound "
            "%r ms by %s" % (B, H, O, times["float32 out"],
                             times["bf16 out"], bound_ms, bound_by))
    return err, out


def resume_model(opt, device):
    """DeepFM at the xDeepFM leg's Criteo width with dnn_dropout, every
    table on the sparse path, compiled."""
    cols = xdeepfm_columns()
    model = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                   dnn_dropout=DEEPFM_DROPOUT, seed=SEED, device=device)
    model.compile(opt, "binary_crossentropy", sparse_table_updates=True)
    return model


def check_same_counts(got, want, what):
    check(got._dense_opt.count == want._dense_opt.count
          and got._table_t == want._table_t,
          "%s: step counts %r %r vs %r %r" % (
              what, got._dense_opt.count, got._table_t,
              want._dense_opt.count, want._table_t))


def phase_checkpoint_resume(device):
    """phase 26: for adagrad and adam, two epochs of RESUME_STEPS steps
    through the device-resident loop (shuffled, dropout on) against one
    epoch, save_checkpoint, a fresh model's load_checkpoint and
    fit(initial_epoch=1): bit-equal weights, dense and table optimizer
    states and step counts; one gather, scatter and row_update a step."""
    pt.set_compute_dtype("float32")
    n = BATCH * RESUME_STEPS
    X = xdeepfm_requests(n, SEED + 710, device)
    y = criteo_labels(n, SEED + 711)
    for opt in ("adagrad", "adam"):
        ref = resume_model(opt, device)
        reset_counts()
        with strict_loops():
            ref.fit(X, y, batch_size=BATCH, epochs=2, verbose=0)
        counts = read_counts()
        for name in ("gather_rows", "scatter_add_rows", "row_update"):
            check(counts[name] == 2 * RESUME_STEPS, "resume %s: %s launched "
                  "%d times in %d steps" % (opt, name, counts[name],
                                            2 * RESUME_STEPS))
        first = resume_model(opt, device)
        first.fit(X, y, batch_size=BATCH, epochs=1, verbose=0)
        path = scratch_dir("resume")
        first.save_checkpoint(str(path))
        resumed = resume_model(opt, device)
        resumed.load_checkpoint(str(path))
        check_same_state(training_state(resumed), training_state(first),
                         "resume %s: the loaded state" % opt)
        with strict_loops():
            resumed.fit(X, y, batch_size=BATCH, epochs=2, initial_epoch=1,
                        verbose=0)
        check_same_state(training_state(resumed), training_state(ref),
                         "resume %s: resumed vs uninterrupted" % opt)
        check_same_counts(resumed, ref, "resume %s" % opt)
        shutil.rmtree(path)
        log("checkpoint resume %s, DeepFM Criteo width (26 x %d rows, every "
            "table sparse, dnn_dropout %r), device-resident loop: 2 epochs "
            "of %d steps of %d bit-equal to 1 epoch, save_checkpoint, "
            "load_checkpoint into a fresh model and fit(initial_epoch=1): "
            "weights, dense and table optimizer states, step counts %r %r; "
            "launches of the uninterrupted fit %s"
            % (opt, XD_VOCAB, DEEPFM_DROPOUT, RESUME_STEPS, BATCH,
               ref._dense_opt.count, sorted(set(ref._table_t.values())),
               {k: v for k, v in counts.items() if v}))
        del ref, first, resumed
        torch.cuda.empty_cache()


def kaggle_deepfm(device, dropout):
    cols = criteo_columns()
    model = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                   dnn_dropout=dropout, seed=SEED, device=device)
    model.compile("adagrad", "binary_crossentropy")
    return model


def phase_checkpoint_kaggle(device):
    """phase 27: DeepFM at the Criteo Kaggle cardinalities (33.8M rows;
    adagrad "auto": 8 tables sparse) with dnn_dropout, 2 graphed steps,
    save_checkpoint, and load_checkpoint into a fresh model: the loaded
    state bit-equal, and the next step of each bit-equal.  The file's
    bytes and the seconds to save and to load; the file is deleted.
    Returns both models, twins, for phase 28."""
    pt.set_compute_dtype("float32")
    X = criteo_requests(BATCH * 3, torch.Generator(device=device)
                        .manual_seed(SEED + 720), device)
    y = criteo_labels(BATCH * 3, SEED + 721)
    model = kaggle_deepfm(device, DEEPFM_DROPOUT)
    check(sorted(p for p, _, _ in model._sparse_specs) == EXPECTED_SPARSE,
          "Kaggle DeepFM: sparse tables %s" % model._sparse_specs)
    model.fit(X[:2 * BATCH], y[:2 * BATCH], batch_size=BATCH, verbose=0,
              shuffle=False)
    path = scratch_dir("kaggle")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.save_checkpoint(str(path))
    save_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in path.iterdir())
    twin = kaggle_deepfm(device, DEEPFM_DROPOUT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin.load_checkpoint(str(path))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(path)
    check_same_state(training_state(twin), training_state(model),
                     "Kaggle checkpoint: the loaded state")
    check_same_counts(twin, model, "Kaggle checkpoint")
    for m in (model, twin):
        with strict_loops():
            m.fit(X[2 * BATCH:], y[2 * BATCH:], batch_size=BATCH, verbose=0,
                  shuffle=False)
    check_same_state(training_state(twin), training_state(model),
                     "Kaggle checkpoint: the next step")
    log("checkpoint DeepFM Criteo Kaggle (%d table rows, adagrad, 8 sparse "
        "tables, dnn_dropout %r) after 2 steps of %d: %d bytes, "
        "save_checkpoint %r s, load_checkpoint into a fresh model %r s "
        "(%s); the loaded state and the next step of both bit-equal; file "
        "deleted" % (sum(CRITEO_KAGGLE_VOCABS), DEEPFM_DROPOUT, BATCH,
                     size, save_s, load_s, card_line()))
    return model, twin


@contextlib.contextmanager
def recorded_masks(masks):
    """Every dropout mask drawn in the enclosed work, appended to
    ``masks`` as a device copy: an eager draw (a step or a capture's
    warm-up) as it is drawn, a captured one after each replay (the graph
    rewrites the mask it captured).  The enclosed work replays one graph
    that draws masks."""
    keep_mask, replay = pcore.Dropout.keep_mask, graphs._Captured.replay
    live = []

    def record(self, x):
        mask = keep_mask(self, x)
        if torch.cuda.is_current_stream_capturing():
            live.append(mask)
        else:
            masks.append(mask.clone())
        return mask

    def replay_and_read(self):
        replay(self)
        masks.extend(m.clone() for m in live)
    pcore.Dropout.keep_mask = record
    graphs._Captured.replay = replay_and_read
    try:
        yield masks
    finally:
        pcore.Dropout.keep_mask = keep_mask
        graphs._Captured.replay = replay


def check_masks(masks, per_step, steps, rate, label):
    """The graphed steps' masks (the first ``steps * per_step``) equal the
    eager twin's (the rest); each step's first mask differs from the step
    before it; the keep fraction lies within 5 sigma of 1 - rate."""
    check(len(masks) == 2 * steps * per_step, "%s: %d masks drawn, want %d"
          % (label, len(masks), 2 * steps * per_step))
    graphed, eager = masks[:steps * per_step], masks[steps * per_step:]
    for i, (a, b) in enumerate(zip(graphed, eager)):
        check(torch.equal(a, b), "%s: graphed mask %d differs from the "
              "eager step's" % (label, i))
    firsts = graphed[::per_step]
    for i in range(1, steps):
        check(not torch.equal(firsts[i], firsts[i - 1]), "%s: steps %d and "
              "%d drew the same mask" % (label, i - 1, i))
    n = sum(m.numel() for m in graphed)
    kept = sum(int(m.sum()) for m in graphed)
    keep = 1.0 - rate
    sigma = (n * keep * (1 - keep)) ** 0.5
    check(abs(kept - n * keep) <= 5 * sigma, "%s: kept %d of %d, want "
          "%r +- 5 x %r" % (label, kept, n, n * keep, sigma))
    return kept / n, (kept - n * keep) / sigma


def dropout_rates(label, graphed, eager, X, y, B):
    """bf16: the device-resident fit of ``graphed`` (dropout on) and of
    ``eager`` with its rates set to 0, alternating: examples/s each."""
    for m in eager.modules():
        if isinstance(m, pcore.Dropout):
            m.rate = 0.0
    eager._drop_graphs()
    fns = {"dropout": lambda: graphed.fit(X, y, batch_size=B, verbose=0),
           "rate 0": lambda: eager.fit(X, y, batch_size=B, verbose=0)}
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(LOOP_RUNS):
        for k, fn in fns.items():
            times[k] += run_ms(fn, runs=1)
    log("fit bf16 %s, device-resident loop, %d steps of %d: with dropout %s; "
        "the same model at rate 0 %s (%s)" % (
            label, X.shape[0] // B, B, rate_line(X.shape[0],
                                                 times["dropout"]),
            rate_line(X.shape[0], times["rate 0"]), card_line()))


def phase_dropout_loops(device, kaggle):
    """phase 28: the graphed fit with dropout bit-equal to the same steps
    run eagerly on a twin from the same generator state, no host sync in
    a step, every replay new masks (each step's first mask differs from
    the last one's; the graphed masks equal the eager ones), the keep
    fraction within 5 sigma of 1 - rate: DeepFM Kaggle (phase 27's twins)
    and DIEN AUGRU+neg at the sequence bench, adam, its tables sparse,
    dnn_dropout 0.6.  Then both in bf16 against the same model at rate 0,
    in examples/s."""
    pt.set_compute_dtype("float32")
    model, twin = kaggle
    for m in (model, twin):
        m._drop_graphs()
    n = BATCH * DROPOUT_STEPS
    X = criteo_requests(n, torch.Generator(device=device)
                        .manual_seed(SEED + 730), device)
    y = criteo_labels(n, SEED + 731)
    dien = [seq_model("dien", "AUGRU", device, dnn_dropout=DIEN_DROPOUT)
            for _ in range(2)]
    for m in dien:
        m.compile("adam", "binary_crossentropy", sparse_table_updates=True)
    Xs = seq_requests(dien[0], SEQ_BATCH * LOOP_STEPS, SEED + 732, device)
    ys = seq_labels(SEQ_BATCH * LOOP_STEPS, SEED + 733)
    runs = [("DeepFM Criteo Kaggle, dnn_dropout %r" % DEEPFM_DROPOUT,
             (model, twin), X, y, BATCH, DEEPFM_DROPOUT, len(HIDDEN),
             {"gather_rows": 1, "scatter_add_rows": 1, "row_update": 1}),
            ("DIEN AUGRU+neg, adam, sparse tables, dnn_dropout %r"
             % DIEN_DROPOUT, dien, Xs[:SEQ_BATCH * DROPOUT_STEPS],
             ys[:SEQ_BATCH * DROPOUT_STEPS], SEQ_BATCH, DIEN_DROPOUT,
             len(SEQ_HIDDEN),
             {"gather_rows": 1, "scatter_add_rows": 1, "gru_scan": 2,
              "gru_scan_bwd": 2, "row_update": 1})]
    for label, (graphed, eager), Xr, yr, B, rate, per_step, launches in runs:
        check(graphed._has_dropout(), label + ": no dropout")
        with recorded_masks([]) as masks:
            graph_vs_eager_fit(graphed, eager, Xr, yr, B, label, launches)
        share, z = check_masks(masks, per_step, DROPOUT_STEPS, rate, label)
        log("dropout %s: %d masks a step, graphed masks equal to the eager "
            "steps', each step's new; keep fraction %r (%r sigma from %r)"
            % (label, per_step, share, z, 1 - rate))
    pt.set_compute_dtype("bfloat16")
    Xk = criteo_requests(BATCH * LOOP_STEPS, torch.Generator(device=device)
                         .manual_seed(SEED + 734), device)
    yk = criteo_labels(BATCH * LOOP_STEPS, SEED + 735)
    dropout_rates(runs[0][0], model, twin, Xk, yk, BATCH)
    dropout_rates(runs[1][0], dien[0], dien[1], Xs, ys, SEQ_BATCH)


def phase_load_model(device):
    """phase 29: save and load_model on the card for DIN sigmoid (the
    fused attention at inference), xDeepFM and DCN: the loaded model's
    graphed predict bit-equal to the saved model's; then DeepFM at Criteo
    width through the device-resident loop with EarlyStopping and
    ModelCheckpoint(save_best_only=True) on val_auc."""
    pt.set_compute_dtype("float32")
    path = scratch_dir("models") / "model.pt"
    cases = [("DIN sigmoid", lambda: seq_model("din", "sigmoid", device),
              SEQ_BATCH, {"gather_rows": 1, "din_attention": 1}),
             ("xDeepFM", lambda: xdeepfm_model(device), BATCH,
              {"gather_rows": 1, "cin_mix": 2}),
             ("DCN", lambda: zoo_model("DCN", device), BATCH,
              {"gather_rows": 1})]
    for label, make, B, per_batch in cases:
        model = make()
        X = (seq_requests(model, 2 * B, SEED + 740, device)
             if label.startswith("DIN") else
             xdeepfm_requests(2 * B, SEED + 741, device))
        want = model.predict(X, B)
        model.save(str(path))
        loaded = pt.load_model(str(path))
        check(type(loaded) is type(model)
              and loaded._device.type == device.type,
              "%s: load_model built %s on %s" % (label, type(loaded),
                                                 loaded._device))
        reset_counts()
        got = loaded.predict(X, B)
        counts = read_counts()
        for name, k in per_batch.items():
            check(counts[name] == 2 * k, "%s after load_model: %s launched "
                  "%d times in 2 batches" % (label, name, counts[name]))
        check(np.array_equal(got, want), "%s: the loaded model's predict "
              "differs (max |d| %r)" % (label, float(np.abs(got - want)
                                                       .max())))
        check_predictions(got, X.shape[0])
        log("load_model %s: %d bytes; graphed predict of the loaded model "
            "bit-equal to the saved one's over 2 batches of %d; launches %s"
            % (label, path.stat().st_size, B,
               {k: v for k, v in counts.items() if v}))
        del model, loaded
    cols = xdeepfm_columns()
    model = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                   seed=SEED, device=device)
    model.compile("adagrad", "binary_crossentropy", metrics=["auc"])
    X = xdeepfm_requests(BATCH * 4, SEED + 742, device)
    y = criteo_labels(BATCH * 4, SEED + 743)
    best = pcb.ModelCheckpoint(str(path), monitor="val_auc", mode="max",
                               save_best_only=True)
    stop = pcb.EarlyStopping(monitor="val_auc", mode="max", patience=1)
    hist = model.fit(X, y, batch_size=BATCH, epochs=4, verbose=0,
                     validation_split=0.25, callbacks=[stop, best])
    aucs = hist.history["val_auc"]
    check(best.best == max(aucs), "ModelCheckpoint: best %r of %r"
          % (best.best, aucs))
    loaded = pt.load_model(str(path))
    pred = loaded.predict(X[-BATCH:], BATCH)
    check_predictions(pred, BATCH)
    if aucs[-1] == max(aucs):
        check(np.array_equal(pred, model.predict(X[-BATCH:], BATCH)),
              "ModelCheckpoint: the best epoch's file predicts otherwise")
    log("ModelCheckpoint(save_best_only) + EarlyStopping, DeepFM Criteo "
        "width, device-resident loop, 3 steps of %d an epoch: val_auc %r, "
        "best %r saved and reloaded" % (BATCH, aucs, best.best))
    shutil.rmtree(path.parent)


def phase_optimizer_objects(device):
    """phase 30: DeepFM at Criteo width compiled with torch.optim.Adam(
    capturable=True) (captured) and torch.optim.Adagrad (no capturable
    option: the device loop runs each step eagerly on the card and says
    so once): each route's fit bit-equal to the same steps run through
    _train_step on a twin; then each route's device-loop examples/s in
    bf16, beside the named adam's (a captured DenseOptimizer)."""
    pt.set_compute_dtype("float32")
    X = xdeepfm_requests(BATCH * 3, SEED + 750, device)
    y = criteo_labels(BATCH * 3, SEED + 751)
    routes = {"Adam(capturable=True)": lambda ps: torch.optim.Adam(
                  ps, lr=1e-3, capturable=True),
              "Adagrad": lambda ps: torch.optim.Adagrad(ps, lr=0.01)}
    cols = xdeepfm_columns()
    models = {}
    for label, make in routes.items():
        pair = []
        for _ in range(2):
            m = DeepFM(cols, cols, dnn_hidden_units=HIDDEN,
                       init_std=INIT_STD, seed=SEED, device=device)
            m.compile(make(m.parameters()), "binary_crossentropy")
            pair.append(m)
        graphed, eager = pair
        per_step = {"gather_rows": 1, "scatter_add_rows": 1, "row_update": 0}
        if graphed._dense_opt.capturable:
            graph_vs_eager_fit(graphed, eager, X, y, BATCH, label, per_step)
            route = "captured: each step a graph replay"
        else:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                reset_counts()
                graphs.GRAPH_REPLAYS = 0
                graphed.fit(X, y, batch_size=BATCH, verbose=0,
                            shuffle=False)
                graphed.fit(X, y, batch_size=BATCH, verbose=0,
                            shuffle=False)
                counts = read_counts()
            said = [str(w.message) for w in seen
                    if "eagerly on the card" in str(w.message)]
            check(len(said) == 1 and graphs.GRAPH_REPLAYS == 0,
                  "%s: %d warnings, %d replays" % (label, len(said),
                                                  graphs.GRAPH_REPLAYS))
            for name, k in per_step.items():
                check(counts[name] == 6 * k, "%s: %s launched %d times in 6 "
                      "steps" % (label, name, counts[name]))
            y_dev = torch.as_tensor(y, device=device).view(-1, 1)
            sw = torch.ones(BATCH, device=device)
            for _ in range(2):
                eager._begin_steps(3)
                for i in range(3):
                    eager._train_step(X[i * BATCH:(i + 1) * BATCH],
                                      y_dev[i * BATCH:(i + 1) * BATCH], sw)
            check_same_state(training_state(graphed), training_state(eager),
                             "%s: eager loop vs eager twin" % label)
            route = "eager steps on the card (%s)" % said[0]
        log("optimizer object %s: %s; bit-equal to the same steps through "
            "_train_step on a twin" % (label, route))
        models[label] = graphed
        del eager
    named = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                   seed=SEED, device=device)
    named.compile("adam", "binary_crossentropy", learning_rate=1e-3)
    models["named adam"] = named
    pt.set_compute_dtype("bfloat16")
    Xt = xdeepfm_requests(BATCH * LOOP_STEPS, SEED + 752, device)
    yt = criteo_labels(BATCH * LOOP_STEPS, SEED + 753)
    fns = {k: (lambda m=m: m.fit(Xt, yt, batch_size=BATCH, verbose=0))
           for k, m in models.items()}
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(LOOP_RUNS):
        for k, fn in fns.items():
            times[k] += run_ms(fn, runs=1)
    for k in fns:
        log("fit bf16 DeepFM Criteo width, device-resident loop, %s, %d "
            "steps of %d: %s (%s)" % (k, LOOP_STEPS, BATCH,
                                      rate_line(Xt.shape[0], times[k]),
                                      card_line()))


CIN_MODES = ("bf16", "carry", "f32")


def phase_cin_modes(device):
    """phase 31: xDeepFM at Criteo width (CIN 256-128, DNN 400-400, B=4096)
    fit in bf16 compute under each CIN mode: the graphed fit bit-equal to
    eager steps on a twin, 2 cin_mix launches a step, and the backward's
    14 kernel launches a step in the "bf16" mode, the einsums in the
    others, replays counted; then one model's
    device-loop fit in each mode (a graph each: the mode is in the graph's
    key), alternating: examples/s and device busy ms a step, and the
    device time by kernel of one replayed step under carry and f32."""
    pt.set_compute_dtype("bfloat16")
    X = xdeepfm_requests(BATCH * 3, SEED + 760, device)
    y = criteo_labels(BATCH * 3, SEED + 761)
    layers = len(XD_CIN)
    try:
        for mode in CIN_MODES:
            pt.set_cin_dtype(mode)
            graphed, eager = xdeepfm_model(device), xdeepfm_model(device)
            for m in (graphed, eager):
                m.compile("adagrad", "binary_crossentropy")
            # the "bf16" mode's backward takes the kernels, seven launches a
            # layer; the others take the einsums, in the graphed steps
            # (replays count what their capture took) and the eager ones
            kernels = mode == "bf16"
            per_step = {"gather_rows": 1, "scatter_add_rows": 1,
                        "cin_mix": layers,
                        "cin_mix_bwd": 7 * layers if kernels else 0}
            einsums = LAUNCHES["cin_mix_bwd_einsum"]
            graph_vs_eager_fit(graphed, eager, X, y, BATCH,
                               "xDeepFM bf16, CIN mode %s" % mode, per_step)
            einsums = LAUNCHES["cin_mix_bwd_einsum"] - einsums
            want = 0 if kernels else 2 * layers * (X.shape[0] // BATCH)
            check(einsums == want, "xDeepFM bf16, CIN mode %s: %d einsum "
                  "backwards in the graphed and the eager steps, want %d"
                  % (mode, einsums, want))
            log("xDeepFM bf16, CIN mode %s: %d einsum backwards in %d "
                "graphed and %d eager steps" % (mode, einsums,
                                                X.shape[0] // BATCH,
                                                X.shape[0] // BATCH))
            del graphed, eager
        model = xdeepfm_model(device)
        model.compile("adagrad", "binary_crossentropy")
        Xt = xdeepfm_requests(BATCH * LOOP_STEPS, SEED + 762, device)
        yt = criteo_labels(BATCH * LOOP_STEPS, SEED + 763)

        def fit(mode):
            pt.set_cin_dtype(mode)
            model.fit(Xt, yt, batch_size=BATCH, verbose=0)
        for mode in CIN_MODES:
            fit(mode)
        times = {mode: [] for mode in CIN_MODES}
        for _ in range(LOOP_RUNS):
            for mode in CIN_MODES:
                times[mode] += run_ms(lambda: fit(mode), runs=1)
        for mode in CIN_MODES:
            busy, _ = profile_launches(lambda: fit(mode))
            wall = statistics.median(times[mode])
            log("fit bf16 xDeepFM Criteo width, device-resident loop, CIN "
                "mode %s, %d steps of %d: %s; device busy %s, %r ms a step "
                "(%s)" % (mode, LOOP_STEPS, BATCH,
                          rate_line(Xt.shape[0], times[mode]),
                          busy_line(busy, wall),
                          (busy or float("nan")) / LOOP_STEPS, card_line()))
        for mode in ("carry", "f32"):
            pt.set_cin_dtype(mode)
            key = [k for k in model._graphs if k[0] == "fit" and mode in k]
            loop = model._graphs[key[0]]
            for _ in range(2):      # see zoo_timing
                model._begin_steps(1)
                if profile_ms(loop.captured.replay, "xDeepFM CIN mode %s "
                              "one replayed train step" % mode) is not None:
                    break
    finally:
        pt.set_cin_dtype("bf16")


# phases 32-33: the streamed fit of a hashed Criteo file, and serving
# through exported artifacts.  The file: STREAM_ROWS rows written from the
# seed, ids drawn over the Criteo Kaggle cardinalities and hashed by the
# reader onto STREAM_BUCKETS buckets a field (data.criteo_columns's
# default), streamed in chunks of STREAM_CHUNK rows
STREAM_ROWS = 262144
STREAM_CHUNK = 65536
STREAM_BUCKETS = 1_000_000
STREAM_EPOCHS = 2
# the f32 checks: the first chunks of one epoch; card against CPU under
# sgd, float32 sums in other orders
STREAM_CPU_CHUNKS = 2
STREAM_LOSS_RTOL = 1e-5
STREAM_WEIGHT_RTOL = 1e-5
STREAM_WEIGHT_ATOL = 1e-6
STREAM_RUNS = 3
# the batches the Kaggle artifact serves, in a fresh process
SERVE_BATCHES = (1, BATCH, BATCH + 1)
# the kernels' launches inside the artifacts of phase 33
ARTIFACT_TOTALS = dict.fromkeys(KERNELS, 0)

_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)
_SMALL_INTS = np.array([b"%d" % i for i in range(-1, 1000)])


def write_criteo_tsv(path, n, seed):
    """A Criteo-format TSV of ``n`` rows from ``seed``: a label (a quarter
    positive), 13 counts (geometric, some empty) and 26 categorical fields
    as 8-digit hex strings of ids drawn uniformly over the Criteo Kaggle
    cardinalities (5% empty)."""
    rng = np.random.default_rng(seed)
    label = np.where(rng.random(n) < 0.25, b"1", b"0").astype(object)
    dense = _SMALL_INTS[np.minimum(rng.geometric(0.05, (n, N_DENSE)), 1000)
                        ].astype(object)
    dense[rng.random((n, N_DENSE)) < 0.1] = b""
    ids = np.stack([rng.integers(0, v, n) for v in CRITEO_KAGGLE_VOCABS],
                   axis=1).astype(np.uint64)
    h = ((ids * np.uint64(2654435761)) % np.uint64(2 ** 32)).astype(
        np.uint32)
    shifts = np.arange(28, -4, -4, dtype=np.uint32)
    hexs = _HEX[(h[..., None] >> shifts) & 0xF].view("S8")[..., 0].astype(
        object)
    hexs[rng.random(hexs.shape) < 0.05] = b""
    rows = np.concatenate([label[:, None], dense, hexs], axis=1)
    with open(path, "wb") as f:
        f.write(b"\n".join(b"\t".join(r) for r in rows.tolist()) + b"\n")


@contextlib.contextmanager
def native_only():
    """The native batcher's plain numpy versions raise if anything calls
    them in the enclosed work: the library, built, is what ran."""
    names = ("assemble_ref", "take_rows_ref", "hash_to_bucket_ref",
             "parse_criteo_ref")
    saved = {n: getattr(native, n) for n in names}

    def refuse(*args, **kwargs):
        raise RuntimeError("a plain numpy version of the native batcher "
                           "ran")
    for n in names:
        setattr(native, n, refuse)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(native, n, fn)


def stream_model(device, optimizer="adagrad", learning_rate=None, **kw):
    cols = pt.criteo_columns(vocab_size=STREAM_BUCKETS, embedding_dim=EMB_DIM)
    model = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                   seed=SEED, device=device, **kw)
    model.compile(optimizer, "binary_crossentropy",
                  learning_rate=learning_rate)
    check(len(model._sparse_specs) == len(CRITEO_KAGGLE_VOCABS),
          "streamed DeepFM: %d tables on the sparse path, want all 26"
          % len(model._sparse_specs))
    return model, cols


def stream_chunks(stream):
    """The chunks of ``stream`` as ``[(x dict, y)]``.  The reader yields
    what a read of ``read_bytes`` holds, so chunks fall a little short of
    ``chunk_rows``."""
    return list(stream())


def stream_steps(chunks):
    """Steps of BATCH an epoch over ``chunks``, each padded to whole
    batches."""
    return sum(-(-len(y) // BATCH) for _, y in chunks)


def stream_checks_f32(path, device):
    """f32, the first STREAM_CPU_CHUNKS chunks, one epoch: the streamed fit
    on the card against a twin that fits each of those chunks in turn
    with the device-resident loop (adagrad, unshuffled: the same steps,
    each chunk padded to whole batches alike, so bit-equal states), every
    step and replay without a host sync; then the streamed fit on the
    card against the CPU port from the same weights under sgd.  (Under
    adagrad a step moves a weight by about lr * sign(g), so rounding-level
    differences of a near-zero gradient flip weights by 2 lr and the card
    and CPU trajectories part over 32 steps: a first run measured their
    epoch losses 1.5e-4 apart; phase 7 holds adagrad over 4 steps.)"""
    pt.set_compute_dtype("float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    streamed, cols = stream_model(device)
    stream = pt.criteo_stream(str(path), cols, chunk_rows=STREAM_CHUNK)
    chunks = stream_chunks(stream)[:STREAM_CPU_CHUNKS]
    steps = stream_steps(chunks)
    with strict_loops():
        hs = streamed.fit(stream, batch_size=BATCH, epochs=1,
                          steps_per_epoch=steps, shuffle=False, verbose=0)
    twin, _ = stream_model(device)
    with strict_loops():
        for x, y in chunks:
            twin.fit(twin.assemble_device_input(x), y, batch_size=BATCH,
                     epochs=1, shuffle=False, verbose=0)
    check_same_state(training_state(streamed), training_state(twin),
                     "streamed fit vs the device-resident fits")
    log("stream f32 (%d chunks of %s rows, %d steps of %d, adagrad, "
        "unshuffled, 26 tables of %d buckets on the sparse path): every "
        "weight and optimizer state bit-equal to a twin's device-resident "
        "fits of the same chunks; epoch loss %r; no host sync in a step"
        % (len(chunks), [len(y) for _, y in chunks], steps, BATCH,
           STREAM_BUCKETS, hs.history["loss"][0]))
    del streamed, twin
    card, _ = stream_model(device, "sgd")
    cpu, _ = stream_model("cpu", "sgd")
    cpu.set_weights(card.get_weights())
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        hist = model.fit(stream, batch_size=BATCH, epochs=1,
                         steps_per_epoch=steps, verbose=0)
        runs[name] = (hist.history["loss"][0], model.get_weights(),
                      time.perf_counter() - t0)
    (lc, wc, tc), (lp, wp, tp) = runs["card"], runs["cpu"]
    rel = abs(lc - lp) / abs(lp)
    check(rel <= STREAM_LOSS_RTOL, "streamed fit card vs CPU: loss %r vs "
          "%r" % (lc, lp))
    worst = max(float((np.abs(wc[k] - wp[k])
                       - STREAM_WEIGHT_RTOL * np.abs(wp[k])).max())
                for k in wp)
    check(worst <= STREAM_WEIGHT_ATOL, "streamed fit card vs CPU: a weight "
          "differs by %r past %r of its size" % (worst, STREAM_WEIGHT_RTOL))
    log("stream f32 card vs CPU (the same %d steps, shuffled, sgd, from the "
        "same weights): epoch loss card %r cpu %r, rel diff %r (rtol %r); "
        "weights max |dw| - %r |w| = %r (atol %r), max |dw| %r; fit %.2f s "
        "on the card, %.2f s on the CPU"
        % (steps, lc, lp, rel, STREAM_LOSS_RTOL, STREAM_WEIGHT_RTOL, worst,
           STREAM_WEIGHT_ATOL, max(float(np.abs(wc[k] - wp[k]).max())
                                   for k in wp), tc, tp))


def host_chunk_ms(model, stream):
    """The host half of the streamed fit, a chunk at a time on this thread
    (parse and hash, assemble, shuffle, pin): ms per chunk, median."""
    rng = np.random.default_rng(SEED)
    times = []
    chunks = stream()
    while True:
        t0 = time.perf_counter()
        item = next(chunks, None)
        if item is None:
            break
        X = model._assemble_x(item[0])
        X = X[rng.permutation(len(X))]
        torch.from_numpy(X).pin_memory()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def phase_stream_fit(device):
    """phase 32: DeepFM over a hashed Criteo TSV, fit(x=criteo_stream(...))
    at full width: the f32 card-vs-CPU check, then 2 epochs at bf16 with
    every step's launches and no host sync in a step, then the rate beside
    the device-resident fit of the same rows."""
    d = scratch_dir("stream")
    path = d / "criteo.tsv"
    t0 = time.perf_counter()
    write_criteo_tsv(path, STREAM_ROWS, SEED + 800)
    log("stream: wrote %d Criteo rows (%d bytes) in %.2f s"
        % (STREAM_ROWS, path.stat().st_size, time.perf_counter() - t0))
    try:
        with native_only():
            stream_checks_f32(path, device)
            out = stream_timing(path, device)
        check(native._lib is not None and native.library_path().exists(),
              "the native batcher was not built")
    finally:
        shutil.rmtree(d)
    return out


def stream_timing(path, device):
    pt.set_compute_dtype("bfloat16")
    model, cols = stream_model(device)
    stream = pt.criteo_stream(str(path), cols, chunk_rows=STREAM_CHUNK)
    chunks = stream_chunks(stream)
    sizes = [len(y) for _, y in chunks]
    per_epoch = stream_steps(chunks)
    steps = STREAM_EPOCHS * per_epoch
    geometries = len({-(-n // BATCH) for n in sizes})
    reset_counts()
    graphs.GRAPH_REPLAYS = 0
    with strict_loops():
        hist = model.fit(stream, batch_size=BATCH, epochs=STREAM_EPOCHS,
                         verbose=0)
    counts = read_counts()
    replays = graphs.GRAPH_REPLAYS
    losses = hist.history["loss"]
    check(len(losses) == STREAM_EPOCHS and np.isfinite(losses).all(),
          "streamed fit losses %s" % losses)
    for name in ("gather_rows", "scatter_add_rows", "row_update"):
        check(counts[name] == steps, "streamed fit: %s launched %d times in "
              "%d steps" % (name, counts[name], steps))
    check(replays == steps - geometries, "streamed fit: %d graph replays "
          "in %d steps, want a capture for each of %d chunk geometries"
          % (replays, steps, geometries))
    log("stream bf16 DeepFM, hashed Criteo (%d rows in chunks of %s, 26 x "
        "%d buckets, all on the sparse path), %d epochs of %d steps of %d: "
        "losses %s; launches %s; %d graph replays and %d captures; every "
        "step and replay without a host sync; the native batcher's plain "
        "versions never ran" % (STREAM_ROWS, sizes, STREAM_BUCKETS,
                                STREAM_EPOCHS, per_epoch, BATCH, losses,
                                {k: v for k, v in counts.items() if v},
                                replays, geometries))
    x = {k: np.concatenate([c[0][k] for c in chunks]) for k in chunks[0][0]}
    y = np.concatenate([c[1] for c in chunks])
    X = model.assemble_device_input(x)
    del chunks

    def streamed():
        model.fit(stream, batch_size=BATCH, epochs=1, verbose=0)

    def resident():
        model.fit(X, y, batch_size=BATCH, epochs=1, verbose=0)
    times = {"stream": [], "device": []}
    for _ in range(STREAM_RUNS):
        for name, fn in (("stream", streamed), ("device", resident)):
            times[name] += run_ms(fn, runs=1)
    host_ms, host_all = host_chunk_ms(model, stream)
    parts = []
    for name, fn in (("stream", streamed), ("device", resident)):
        busy, kernels = profile_launches(fn)
        wall = statistics.median(times[name])
        parts.append("%s: %s, device busy %s" % (
            "fit(x=criteo_stream(...))" if name == "stream" else
            "fit(assemble_device_input(x)) on the same rows",
            rate_line(STREAM_ROWS, times[name]), busy_line(busy, wall)))
    log("stream bf16 timing (%s), one epoch of %d rows: %s; host half %r "
        "ms a chunk (median; %s), on its own thread beside the device"
        % (card_line(), STREAM_ROWS, "; ".join(parts), host_ms,
           ["%.1f" % t for t in host_all]))
    return counts


def fresh_process_serve(path, X_path, out_path):
    """Run the artifact at ``path`` on the batches of ``X_path`` in a new
    interpreter that builds no model and no columns; returns its report."""
    code = (
        "import json, sys, time\n"
        "import numpy as np, torch\n"
        "sys.path.insert(0, sys.argv[4])\n"
        "from deepctr_tpu_torch import serving\n"
        "from deepctr_tpu_torch.ops._build import LAUNCHES\n"
        "t0 = time.perf_counter()\n"
        "exp = serving.load_exported(sys.argv[1])\n"
        "load_s = time.perf_counter() - t0\n"
        "X = np.load(sys.argv[2])\n"
        "outs = {}\n"
        "for b in json.loads(sys.argv[5]):\n"
        "    outs['b%d' % b] = exp.call(X[:b]).cpu().numpy()\n"
        "np.savez(sys.argv[3], **outs)\n"
        "print(json.dumps({'load_s': load_s, 'device': str(exp.device),\n"
        "                  'gather_launches': LAUNCHES['gather_rows']}))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(path), str(X_path), str(out_path),
         str(HERE), json.dumps(list(SERVE_BATCHES))], capture_output=True,
        text=True, timeout=600, cwd=str(path.parent))
    check(proc.returncode == 0, "the serving process failed:\n%s"
          % proc.stderr[-4000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_serve_kaggle(model, X_all):
    """phase 33, DeepFM: the Criteo Kaggle model exported with a symbolic
    batch, saved, then loaded and run in a fresh process on batches of 1,
    4096 and 4097, held against in-process predict; the artifact's bytes,
    its export, save and load seconds, and its device ms a batch beside
    the graphed predict's."""
    pt.set_compute_dtype("float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = scratch_dir("serving")
    try:
        t0 = time.perf_counter()
        exp = serving.export_predict(model)
        export_s = time.perf_counter() - t0
        path = d / "deepfm_kaggle.pt2"
        t0 = time.perf_counter()
        serving.save_exported(exp, str(path))
        save_s = time.perf_counter() - t0
        size = path.stat().st_size
        X = X_all[:max(SERVE_BATCHES)]
        np.save(d / "X.npy", X.cpu().numpy())
        want = model.predict(X, batch_size=BATCH)
        report = fresh_process_serve(path, d / "X.npy", d / "out.npz")
        got = np.load(d / "out.npz")
        check(report["gather_launches"] == len(SERVE_BATCHES), "the serving "
              "process launched the gather %d times for %d batches"
              % (report["gather_launches"], len(SERVE_BATCHES)))
        parts = []
        for b in SERVE_BATCHES:
            g = got["b%d" % b].astype("float64")
            check(g.shape == (b, 1), "artifact output %s at B=%d"
                  % (g.shape, b))
            diff = float(np.abs(g - want[:b]).max())
            check(diff <= ATOL_CPU, "artifact vs predict at B=%d: max |dp| "
                  "%r > %r" % (b, diff, ATOL_CPU))
            parts.append("B=%d max |dp| %r (%s)" % (
                b, diff, "bit-equal" if np.array_equal(g, want[:b])
                else "not bit-equal"))
        X4 = X_all[:BATCH]
        reset_counts()
        exp.call(X4)
        counts = read_counts()
        for name, n in counts.items():
            ARTIFACT_TOTALS[name] += n
        check(counts["gather_rows"] == 1, "the artifact launched the gather "
              "%d times a batch" % counts["gather_rows"])
        fns = {"artifact": lambda: exp.call(X4),
               "graphed predict": lambda: model.predict(X4, BATCH)}
        timing = []
        for name, fn in fns.items():
            ms = statistics.median(run_ms(fn, runs=LOOP_RUNS))
            busy, kernels = profile_launches(fn)
            timing.append("%s %r ms a batch (CUDA events, median of %d), "
                          "device busy %r ms, %d device operations" % (
                              name, ms, LOOP_RUNS, busy or float("nan"),
                              kernels))
        log("serve DeepFM Criteo Kaggle (%s): export_predict (symbolic "
            "batch) %.2f s, save_exported %.2f s, %d bytes; a fresh process "
            "(no model, no columns) loaded it in %.2f s on %s and ran B=%s "
            "with %d gather launches: %s (atol %r); in process at B=%d: %s"
            % (card_line(), export_s, save_s, size, report["load_s"],
               report["device"], list(SERVE_BATCHES),
               report["gather_launches"], "; ".join(parts), ATOL_CPU, BATCH,
               "; ".join(timing)))
        del exp
    finally:
        shutil.rmtree(d)


def serve_case(label, build, X, B, per_batch, device):
    """phase 33, one model: exported with a symbolic batch, saved and
    loaded in process, run on ``X``: its kernels' launches inside the
    artifact (``per_batch``, at least one each), against the model's
    ``predict``, and against the artifact of a CPU twin (the same weights;
    its operators run the kernels' plain versions) within ATOL_CPU."""
    model = build(device)
    d = scratch_dir("serving")
    try:
        exp = serving.export_predict(model)
        path = d / "model.pt2"
        serving.save_exported(exp, str(path))
        loaded = serving.load_exported(str(path))
        reset_counts()
        got = loaded.call(X).cpu().numpy().astype("float64")
        counts = read_counts()
    finally:
        shutil.rmtree(d)
    for name, n in counts.items():
        ARTIFACT_TOTALS[name] += n
    for name, n in per_batch.items():
        check(counts[name] == n, "%s artifact: %s launched %d times in one "
              "batch, want %d" % (label, name, counts[name], n))
    check_predictions(got, X.shape[0])
    want = model.predict(X, batch_size=B)
    diff = float(np.abs(got - want).max())
    check(diff <= ATOL_CPU, "%s artifact vs predict: max |dp| %r"
          % (label, diff))
    twin = build("cpu")
    twin.load_state_dict(model.state_dict())
    plain = serving.export_predict(twin).call(X.cpu()).numpy()
    pdiff = float(np.abs(got - plain).max())
    check(pdiff <= ATOL_CPU, "%s artifact on the card vs on the CPU: max "
          "|dp| %r" % (label, pdiff))
    log("serve %s: artifact (symbolic batch, saved and loaded) on %d "
        "requests: launches %s; vs predict max |dp| %r (%s); vs the CPU "
        "artifact (the plain versions) max |dp| %r (atol %r)"
        % (label, X.shape[0], {k: v for k, v in counts.items() if v}, diff,
           "bit-equal" if np.array_equal(got, want) else "not bit-equal",
           pdiff, ATOL_CPU))


def phase_serve_models(device):
    """phase 33, the sequence models and xDeepFM: every inference kernel
    inside an artifact."""
    pt.set_compute_dtype("float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    din = seq_model("din", "sigmoid", device)
    X_seq = seq_requests(din, SEQ_BATCH, SEED + 830, device)
    del din
    serve_case("DIN sigmoid", lambda d: seq_model("din", "sigmoid", d), X_seq,
               SEQ_BATCH, {"gather_rows": 1, "din_attention": 1}, device)
    serve_case("DIEN GRU", lambda d: seq_model("dien", "GRU", d), X_seq,
               SEQ_BATCH, {"gather_rows": 1, "din_attention": 1,
                           "gru_scan": 2}, device)
    serve_case("xDeepFM", xdeepfm_model, xdeepfm_requests(
        BATCH, SEED + 831, device), BATCH, {"gather_rows": 1, "cin_mix": 2},
        device)
    for name in ("gather_rows", "din_attention", "gru_scan", "cin_mix"):
        check(ARTIFACT_TOTALS[name] > 0, "%s never launched inside an "
              "artifact" % name)


# phase 34: the mesh.  34a: one NCCL rank in this process; 34b
# and 34c: two gloo ranks on the one card (tools/multiprocess_sim.spawn),
# each leg against the same steps on one process without a mesh
MESH_STEPS = 3
MESH_PREDICT = 8 * BATCH
MESH_SEQ_STEPS = 3
MESH_TOL = {"sgd": 1e-5, "adagrad": 1e-4, "adam": 1e-4}
# touched rows of a rank's block against one process, by optimizer and
# ranks on the data axis: 1e-6 under sgd with one data rank.  With two, the
# half batches' products and sums add in another order: 1.43e-6 at Criteo
# C8 (a 633-row table), which one process reaches alone with each batch's
# halves swapped (the witness beside each leg), so the predictions' 1e-5.
# Adagrad's early steps are about lr * sign(g) and amplify that order
# (7.07e-4 measured): 3e-3, while its first step alone moves every touched
# weight with a gradient by lr = 0.01, so a row left without its update
# is further off than that
# (adam's first step moves a touched weight with a gradient by about its
# lr = 1e-3: a row left without its update is further off than 1e-3)
MESH_BLOCK_TOL = {("sgd", 1): 1e-6, ("sgd", 2): 1e-5,
                  ("adagrad", 1): 3e-3, ("adagrad", 2): 3e-3,
                  ("adam", 1): 1e-3}
MESH_TIMEOUT = 600
# 34d: the rows whose predictions and touched rows are held
MESH_STREAM_CHECKED = 2 * BATCH


def mesh_kaggle(device, optimizer, **kw):
    """DeepFM at the Criteo Kaggle cardinalities (phase 3's model),
    compiled at float32 with ``sparse_table_updates="auto"``;
    ``optimizer`` a name, or a function of the model that returns a
    ``torch.optim`` optimizer over it."""
    cols = criteo_columns()
    model = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                   seed=SEED, device=device, **kw)
    if callable(optimizer):
        optimizer = optimizer(model)
    model.compile(optimizer, "binary_crossentropy")
    return model


def mesh_data(kind, device):
    """The legs' data, drawn alike in every process: ``(X [steps * B, D]
    on the device, labels, X to predict)``."""
    if kind in ("din", "dien"):
        probe = (seq_model("din", "Dice", "cpu") if kind == "din" else
                 seq_model("dien", "AUGRU", "cpu"))
        X = seq_requests(probe, SEQ_BATCH * MESH_SEQ_STEPS, SEED + 160,
                         device)
        Xp = seq_requests(probe, 2 * SEQ_BATCH, SEED + 161, device)
        return X, seq_labels(X.shape[0], SEED + 162), Xp
    if kind == "ple":
        X = xdeepfm_requests(BATCH * MESH_STEPS, SEED + 155, device)
        Xp = xdeepfm_requests(2 * BATCH, SEED + 156, device)
        return X, zoo_labels("PLE", X.shape[0], SEED + 157), Xp
    gen = torch.Generator(device=device).manual_seed(SEED + 150)
    X = criteo_requests(BATCH * MESH_STEPS, gen, device)
    Xp = criteo_requests(MESH_PREDICT, gen, device)
    return X, criteo_labels(X.shape[0], SEED + 151), Xp


def mesh_model(kind, optimizer, device, **kw):
    """A leg's model: the Kaggle DeepFM; DIN with Dice or DIEN AUGRU with
    negative sampling (its three tables on the sparse path) at the
    sequence bench's width; PLE at the zoo's Criteo width, whose weights
    on a mesh are those the model draws without one (the draw of a
    row-sharded table's block differs)."""
    if kind in ("din", "dien"):
        model = (seq_model("din", "Dice", device, **kw) if kind == "din"
                 else seq_model("dien", "AUGRU", device, **kw))
        model.compile(optimizer, "binary_crossentropy",
                      sparse_table_updates=kind == "dien")
        return model
    if kind == "ple":
        model = zoo_model("PLE", device, **kw)
        if model.mesh is not None:
            model.set_weights(zoo_model("PLE", device).state_dict())
        model.compile(optimizer, zoo_loss("PLE"))
        return model
    return mesh_kaggle(device, optimizer, **kw)


def touched_rows(model, X):
    """``{table path: (ids, rows)}``: the rows of the ids that ``X``
    reads from each table which this process holds (its block on a mesh),
    on the host."""
    out = {}
    spans = model._table_id_spans()
    for path, table in model._tables().items():
        base, stop = model._shards.get(path, (0, table.shape[0]))[:2]
        cols = [c for s, e in spans.get(path, []) for c in range(s, e)]
        ids = torch.unique(X[:, cols].long())
        ids = ids[(ids >= base) & (ids < stop)]
        out[path] = (ids.cpu().numpy(),
                     table.detach()[ids - base].cpu().numpy())
    return out


def mesh_bytes(model):
    """Bytes of the tables this rank holds, and of their optimizer
    state."""
    tables = model._tables()
    state = sum(t.numel() * 4 for st in model._table_state.values()
                for t in st)
    state += sum(t.numel() * 4 for p, st in zip(model._dense_paths,
                                                model._dense_opt.state)
                 if p in tables for t in st)
    return sum(t.numel() * 4 for t in tables.values()), state


def mesh_leg(kind, optimizer, device, mesh=None, shard=False, swap=False):
    """One leg: ``MESH_STEPS`` fit steps (shuffle off) and predict, at
    float32; ``swap`` swaps the halves of each batch (the same steps in
    exact arithmetic).  Returns the losses, predictions, touched rows,
    bytes, launches and ms a step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_compute_dtype("float32")
    X, y, Xp = mesh_data(kind, device)
    B = SEQ_BATCH if kind in ("din", "dien") else BATCH
    if swap:
        order = torch.arange(X.shape[0], device=X.device).view(
            -1, 2, B // 2).flip(1).reshape(-1)
        X, y = X[order], y[order.cpu().numpy()]
    model = mesh_model(kind, optimizer, device, mesh=mesh,
                       shard_embeddings=shard)
    ends = []
    step = model._train_step

    def timed(*args):   # the eager steps (a mesh), each synchronized
        out = step(*args)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return out
    if mesh is not None:
        model._train_step = timed
    torch.cuda.synchronize()
    reset_counts()
    hist = model.fit(X, y, batch_size=B, epochs=1, verbose=0, shuffle=False)
    counts = read_counts()
    model.__dict__.pop("_train_step", None)
    # ms a step after the first (which builds the step plan and arguments)
    ms = (statistics.median(np.diff(ends)) * 1e3 if len(ends) > 2
          else None)
    pred = model.predict(Xp, B)
    return model, {"loss": hist.history["loss"], "pred": pred,
                   "rows": touched_rows(model, X), "bytes": mesh_bytes(model),
                   "launches": counts, "ms": ms,
                   "blocks": {p: s[:2] for p, s in model._shards.items()}}


def mesh_gru_requests(device):
    """DIEN GRU's requests for 34b's predict on the mesh."""
    return seq_requests(seq_model("dien", "GRU", "cpu"), 2 * SEQ_BATCH,
                        SEED + 163, device)


def mesh_rank(rank, world, device, legs):
    """A rank of phase 34b/c: every leg ``(kind, optimizer, mesh shape,
    shard, exchange)`` on its mesh, and, after an a2a leg, its predict on
    skewed ids at slack 1.0 under "error" and "drop" (34c); after the
    DIEN leg, DIEN ``GRU``'s predict on the same mesh (the attention
    kernel's readout)."""
    from deepctr_tpu_torch import config
    from deepctr_tpu_torch.parallel import make_mesh
    out = []
    for kind, optimizer, shape, shard, exchange in legs:
        mesh = make_mesh(shape, devices="cuda")
        if exchange:
            config.set_embedding_exchange(exchange, mesh, a2a_slack=8.0)
        model, res = mesh_leg(kind, optimizer, device, mesh, shard)
        if exchange == "a2a":
            _, _, Xp = mesh_data(kind, device)
            skew = Xp.clone()
            skew[:, :len(CRITEO_KAGGLE_VOCABS)] %= 1000   # rank 0's rows
            for mode in ("error", "drop"):
                config.set_embedding_exchange("a2a", mesh, a2a_slack=1.0,
                                              on_overflow=mode)
                res["skew_" + mode] = model.predict(skew, BATCH)
        if kind == "dien":
            gru_model = seq_model("dien", "GRU", device, mesh=mesh,
                                  shard_embeddings=shard)
            X = mesh_gru_requests(device)
            reset_counts()
            res["gru_pred"] = gru_model.predict(X, SEQ_BATCH)
            res["gru_launches"] = read_counts()
            del gru_model
        config.set_embedding_exchange("gspmd")
        out.append(res)
        del model
        torch.cuda.empty_cache()
    return out


def mesh_one_rank(device):
    """34a: one rank under NCCL in this process, the Kaggle DeepFM on a
    (1, 1) mesh with its tables sharded (each rank its block: the whole
    table here), against the same model without a mesh (graphed): the
    losses of 3 adagrad steps and 8 predict batches bit for bit, every
    table and state too; the gather, K1 and K2 once a step."""
    import torch.distributed as dist
    from deepctr_tpu_torch.parallel import distributed, make_mesh
    store = scratch_dir("mesh") / "store"
    rank, world = distributed.initialize(init_method="file://%s" % store,
                                         world_size=1, rank=0)
    try:
        check((rank, world) == (0, 1) and dist.get_backend() == "nccl",
              "34a: process group %s, backend %s"
              % ((rank, world), dist.get_backend()))
        mesh = make_mesh((1, 1))
        model, got = mesh_leg("kaggle", "adagrad", device, mesh, True)
        twin, want = mesh_leg("kaggle", "adagrad", device)
        for name in ("gather_rows", "scatter_add_rows", "row_update"):
            check(got["launches"][name] == MESH_STEPS, "34a: %s launched %d "
                  "times in %d steps" % (name, got["launches"][name],
                                         MESH_STEPS))
        check(got["loss"] == want["loss"], "34a: losses %r vs %r"
              % (got["loss"], want["loss"]))
        check(np.array_equal(got["pred"], want["pred"]), "34a: predictions "
              "differ from the model without a mesh")
        a, b = training_state(model), training_state(twin)
        check_same_state(a, b, "34a")
        check(len(model._shards) == len(CRITEO_KAGGLE_VOCABS),
              "34a: %d tables sharded" % len(model._shards))
        log("34a mesh, one NCCL rank, (1, 1), Kaggle DeepFM adagrad f32: "
            "%d steps and %d predict rows bit-equal to the model without a "
            "mesh (graphed; losses %r), every table and state too; launches "
            "%s; %.3f ms an eager step (median after the first; no graph "
            "under a mesh)"
            % (MESH_STEPS, MESH_PREDICT, got["loss"],
               {k: v for k, v in got["launches"].items() if v}, got["ms"]))
        return twin
    finally:
        dist.destroy_process_group()


def mesh_gather_zero_fill(model):
    """The gather's shard-local mode at the Kaggle shape (B=4096, the 26
    tables cut into their two blocks as a (1, 2) mesh would, W=17): each
    rank's launch against the plain version bit for bit (ids of the other
    block give zero rows), and its device ms with a cold L2 beside the NaN
    mode on the same blocks and the plain version."""
    from deepctr_tpu_torch.parallel.sharding import table_block
    gen = torch.Generator(device="cuda").manual_seed(SEED + 170)
    X = criteo_requests(BATCH, gen, "cuda")
    cols = list(range(len(CRITEO_KAGGLE_VOCABS)))
    paths = ["embedding_dict/C%d" % i for i in cols]
    tables = model._tables()
    out = {}
    for m in (0, 1):
        blocks, bases = [], []
        for p in paths:
            t = tables[p].detach()
            block = table_block(2, m, t.shape[0], t.shape[1])
            base, stop = (block[:2] if block is not None
                          else (0, t.shape[0]))
            blocks.append(t[base:stop])
            bases.append(base)
        got = gather.gather_rows(X, blocks, cols, bases)
        want = gather.gather_rows_ref(X, blocks, cols, bases)
        check(same_bits(got, want), "zero-fill gather differs from its "
              "plain version on block %d" % m)
        if m == 0:
            out = {"zero_fill_ms": device_ms(
                       lambda: gather.gather_rows(X, blocks, cols, bases)),
                   "zero_fill_nan_mode_ms": device_ms(
                       lambda: gather.gather_rows(X, blocks, cols)),
                   "zero_fill_plain_ms": device_ms(
                       lambda: gather.gather_rows_ref(X, blocks, cols,
                                                      bases))}
    log("34 gather, shard-local zero-fill mode, Kaggle blocks of a (1, 2) "
        "mesh, B=4096 x 26, W=17: both blocks bit-equal to the plain "
        "version; device ms (cold L2) %.5f, NaN mode on the same blocks "
        "%.5f, plain %.4f" % (out["zero_fill_ms"],
                              out["zero_fill_nan_mode_ms"],
                              out["zero_fill_plain_ms"]))
    return out


def close(a, b, tol):
    return a.shape == b.shape and np.allclose(a, b, rtol=0, atol=tol)


def mesh_leg_errors(label, ranks, want):
    """The largest |prediction - one process's| over both ranks, and the
    largest |touched row - one process's| with its table and the largest
    |weight| of that table's touched rows, each rank's rows of its block;
    raises if the ranks predict differently or hold other ids."""
    worst_p, worst_b = 0.0, (0.0, None, 0.0)
    for r in ranks:
        check(np.array_equal(r["pred"], ranks[0]["pred"]), "%s: the ranks "
              "predict differently" % label)
        check(r["pred"].shape == want["pred"].shape, "%s: predictions of "
              "shape %s" % (label, r["pred"].shape))
        worst_p = max(worst_p, float(np.abs(r["pred"] - want["pred"]).max()))
        for path, (ids, rows) in r["rows"].items():
            ref_ids, ref_rows = want["rows"][path]
            pos = np.searchsorted(ref_ids, ids)
            check(np.array_equal(ref_ids[pos], ids), "%s: %s's ids" % (
                label, path))
            if len(ids):
                diff = float(np.abs(rows - ref_rows[pos]).max())
                if worst_b[1] is None or diff > worst_b[0]:
                    worst_b = (diff, path, float(np.abs(ref_rows).max()))
    return worst_p, worst_b


def mesh_dien_launches(label, got, device):
    """The DIEN leg's GRU kernels on each rank (two ``gru_scan`` and two
    ``gru_scan_bwd`` a step, one ``row_update``), and DIEN ``GRU``'s
    predict on the mesh (two ``gru_scan`` and one ``din_attention`` a
    batch) against this process's predict without a mesh; returns the
    line to log."""
    for r in got:
        for name, want in (("gru_scan", 2 * MESH_SEQ_STEPS),
                           ("gru_scan_bwd", 2 * MESH_SEQ_STEPS),
                           ("row_update", MESH_SEQ_STEPS)):
            check(r["launches"][name] == want, "%s: %s launched %d times on "
                  "a rank, want %d" % (label, name, r["launches"][name],
                                       want))
        for name, want in (("gru_scan", 4), ("din_attention", 2)):
            check(r["gru_launches"][name] == want, "%s: DIEN GRU predict "
                  "launched %s %d times, want %d"
                  % (label, name, r["gru_launches"][name], want))
        add_rank_counts(r["gru_launches"])
        check(np.array_equal(r["gru_pred"], got[0]["gru_pred"]), "%s: the "
              "ranks' DIEN GRU predictions differ" % label)
    want = seq_model("dien", "GRU", device).predict(
        mesh_gru_requests(device), SEQ_BATCH)
    diff = float(np.abs(got[0]["gru_pred"] - want).max())
    check(diff <= MESH_TOL["sgd"], "%s: DIEN GRU predict on the mesh vs one "
          "process: max |dp| %r" % (label, diff))
    return ("%s: launches a rank %s (the GRU's forward and backward kernels "
            "under a mesh); DIEN GRU predict on the mesh, %d rows: %s a "
            "rank, max |dp| %.3g from one process (bound %g)"
            % (label, {k: v for k, v in got[0]["launches"].items() if v},
               want.shape[0], {k: v for k, v in
                               got[0]["gru_launches"].items() if v},
               diff, MESH_TOL["sgd"]))


def phase_mesh(device, twin):
    """Phase 34 (b, c): the two-rank legs on the one card, gloo with CUDA
    tensors (NCCL refuses two ranks on one device), each against the same
    steps without a mesh in this process."""
    from deepctr_tpu_torch.tools.multiprocess_sim import spawn
    legs = [("kaggle", "sgd", (1, 2), True, "psum"),
            ("kaggle", "adagrad", (1, 2), True, "psum"),
            ("kaggle", "sgd", (1, 2), True, "a2a"),
            ("kaggle", "sgd", (2, 1), False, None),
            ("kaggle", "adagrad", (2, 1), False, None),
            ("din", "sgd", (2, 1), False, None),
            ("din", "adagrad", (2, 1), False, None),
            ("dien", "adagrad", (2, 1), False, None),
            ("ple", "adam", (1, 2), True, None)]
    del twin
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(str(HERE / "chip_smoke.py") + ":mesh_rank", 2,
                  str(scratch_dir("mesh_ranks")), {"legs": legs},
                  timeout=MESH_TIMEOUT, backend="gloo", device="cuda")
    log("34b: two gloo ranks on the card ran %d legs in %.1f s"
        % (len(legs), time.perf_counter() - t0))
    refs = {}
    lines = []
    failed = False
    for i, (kind, optimizer, shape, shard, exchange) in enumerate(legs):
        if (kind, optimizer) not in refs:
            model, refs[kind, optimizer] = mesh_leg(kind, optimizer, device)
            del model
            torch.cuda.empty_cache()
        want = refs[kind, optimizer]
        got = [r[i] for r in ranks]
        label = "34b %s %s %s%s" % (kind, optimizer, shape,
                                    " " + exchange if exchange else "")
        worst_p, (worst_b, where, scale) = mesh_leg_errors(label, got,
                                                           want)
        tol, btol = MESH_TOL[optimizer], MESH_BLOCK_TOL[optimizer, shape[0]]
        failed = failed or worst_p > tol or worst_b > btol
        for r in got:
            add_rank_counts(r["launches"])
        if kind == "dien":
            lines.append(mesh_dien_launches(label, got, device))
        if shard:
            check(got[0]["blocks"] and got[1]["blocks"], "%s: no table "
                  "sharded" % label)
        if shape[0] == 2:
            swapped, witness = mesh_leg(kind, optimizer, device, swap=True)
            del swapped
            torch.cuda.empty_cache()
            wp, (wb, wwhere, wscale) = mesh_leg_errors(
                label + " witness", [witness], want)
            lines.append(
                "%s witness, one process, each batch's halves swapped, "
                "against one process: predictions %.3g, touched rows %.3g "
                "(%s, touched |w| up to %.3g)" % (label, wp, wb, wwhere,
                                                  wscale))
        lines.append(
            "%s: predictions %.3g from one process's (bound %g), touched "
            "rows %.3g (bound %g, %s, touched |w| up to %.3g); per rank: "
            "tables %s bytes, state %s "
            "bytes, %s sharded tables, row_update launches %s, ms a step %s "
            "(gloo through the host on one card, not a scaling figure)"
            % (label, worst_p, tol, worst_b, btol, where, scale,
               [r["bytes"][0] for r in got], [r["bytes"][1] for r in got],
               len(got[0]["blocks"]), [r["launches"]["row_update"]
                                       for r in got],
               ["%.2f" % r["ms"] for r in got]))
        if exchange == "a2a":
            for r in got:
                check(not np.isfinite(r["skew_error"]).any(), "34c: an "
                      "overflowing a2a predicted finite values under "
                      "\"error\"")
                check_predictions(r["skew_drop"], MESH_PREDICT)
                check(np.array_equal(r["skew_drop"], got[0]["skew_drop"]),
                      "34c: the ranks drop differently")
            lines.append("34c a2a overflow at slack 1.0 (ids < 1000 in "
                         "every field: rank 0's rows): every prediction NaN "
                         "under \"error\", finite and alike on both ranks "
                         "under \"drop\"")
    for line in lines:
        log(line)
    check(not failed, "34b: a leg is over its bound (the lines above)")

# phases 34d-f: what the streamed fit, export and a torch.optim checkpoint
# do on a mesh, on two gloo ranks of the one card.  34d's legs: (mesh
# shape, tables sharded, optimizer, held to MESH_TOL and MESH_BLOCK_TOL).
# Over the stream's 64 steps adagrad's sign-like first steps amplify the
# data axis's reordered sums far past those bounds (a first run: 0.0205
# on predictions, 0.0403 on touched rows at (2, 1); at (1, 2) bit-equal),
# so the (2, 1) adagrad leg is measured and set beside one process whose
# batches have their halves swapped (the same steps in exact arithmetic),
# and the data axis is held under sgd over the same stream (whose
# reordering does not grow), at lr 1e-3: the losses sum over 4096 rows,
# and at sgd's default 0.01 a Kaggle weight reaches 6.5 in 3 steps (34b);
# the predictions still saturate, so its loss and touched rows carry the
# check
MESH_IO_LEGS = (((1, 2), True, "adagrad", True),
                ((2, 1), False, "adagrad", False),
                ((2, 1), False, "sgd", True))
MESH_STREAM_SGD_LR = 1e-3


def stream_matrix(model, stream):
    """The whole stream assembled (hashed) as one matrix on the card."""
    return torch.cat([model.assemble_device_input(x) for x, _ in stream()])


def swapped_halves(stream, seed):
    """``stream``'s chunks shuffled as the streamed fit shuffles them
    (``default_rng(seed)``, a permutation a chunk), each whole batch's
    halves then swapped: fitted with ``shuffle=False``, the steps of the
    shuffled fit with their halves added in the order two data ranks
    add them (a chunk's last, partial batch as it is)."""
    def make_iter():
        rng = np.random.default_rng(seed)
        for x, y in stream():
            order = rng.permutation(len(y))
            whole = len(y) // BATCH * BATCH
            order[:whole] = order[:whole].reshape(
                -1, 2, BATCH // 2)[:, ::-1].reshape(-1)
            yield {k: v[order] for k, v in x.items()}, y[order]
    return make_iter


def mesh_stream_leg(tsv, device, optimizer="adagrad", mesh=None,
                    shard=False, swap=False):
    """34d, one leg: phase 32's hashed-Criteo DeepFM (26 x 1M buckets, all
    on the sparse path) fitted one epoch from ``criteo_stream`` under
    ``optimizer`` on ``mesh`` (None: this process alone; ``swap``: with
    each batch's halves swapped, :func:`swapped_halves`); then the
    predictions of the stream's first MESH_STREAM_CHECKED rows and the
    touched rows of their ids (the leg's own block), the ms of each chunk
    (a chunk's steps, and the wait for the next chunk), a second epoch
    under the profiler for the device's busy ms, and the host half's ms a
    chunk."""
    model, cols = stream_model(
        device, optimizer, MESH_STREAM_SGD_LR if optimizer == "sgd" else None,
        mesh=mesh, shard_embeddings=shard)
    stream = pt.criteo_stream(tsv, cols, chunk_rows=STREAM_CHUNK)
    data, shuffle = ((swapped_halves(stream, model.seed), False) if swap
                     else (stream, True))
    marks = []
    ready = model._ready_steps

    def timed(n):   # called as each chunk's steps begin
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return ready(n)
    model._ready_steps = timed
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    hist = model.fit(data, batch_size=BATCH, epochs=1, verbose=0,
                     shuffle=shuffle)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    counts = read_counts()
    del model._ready_steps
    X = stream_matrix(model, stream)[:MESH_STREAM_CHECKED]
    out = {"loss": list(hist.history["loss"]),
           "pred": model.predict(X, BATCH),
           "rows": touched_rows(model, X), "launches": counts,
           "chunk_ms": [float(t) for t in np.diff(marks) * 1e3],
           "wall_ms": (marks[-1] - t0) * 1e3, "bytes": mesh_bytes(model),
           "blocks": {p: b[:2] for p, b in model._shards.items()}}
    out["busy_ms"], _ = profile_launches(
        lambda: model.fit(stream, batch_size=BATCH, epochs=1, verbose=0))
    out["host_ms"], _ = host_chunk_ms(model, stream)
    return out


def mesh_optim_checkpoint(device, directory):
    """34f: the Kaggle DeepFM on a (1, 2) mesh with its tables sharded,
    under ``torch.optim.Adagrad`` (lr 0.01; the tables dense), one epoch
    of MESH_STEPS batches, ``save_checkpoint`` (rank 0 writes), a second
    epoch; a fresh model loads the checkpoint and takes the second epoch
    too.  Returns whether the two second epochs agree bit for bit (loss,
    predictions, every tensor of the rank and every optimizer state), the
    file's bytes, save and load seconds and the first model's launches."""
    import torch.distributed as dist
    from deepctr_tpu_torch.parallel import make_mesh
    mesh = make_mesh((1, 2), devices="cuda")
    X, y, Xp = mesh_data("kaggle", device)
    Xp = Xp[:2 * BATCH]

    def build():
        return mesh_kaggle(
            device, lambda m: torch.optim.Adagrad(m.parameters(), lr=0.01),
            mesh=mesh, shard_embeddings=True)

    def second_epoch(model):
        hist = model.fit(X, y, batch_size=BATCH, epochs=2, initial_epoch=1,
                         verbose=0, shuffle=False)
        return hist.history["loss"][-1], model.predict(Xp, BATCH)
    whole = build()
    reset_counts()
    whole.fit(X, y, batch_size=BATCH, epochs=1, verbose=0, shuffle=False)
    t0 = time.perf_counter()
    whole.save_checkpoint(directory)
    save_s = time.perf_counter() - t0
    dist.barrier()
    loss, pred = second_epoch(whole)
    counts = read_counts()
    resumed = build()
    t0 = time.perf_counter()
    resumed.load_checkpoint(directory)
    load_s = time.perf_counter() - t0
    loss_r, pred_r = second_epoch(resumed)
    a, b = training_state(whole), training_state(resumed)
    same = (sorted(a) == sorted(b) and any("(state" in k for k in a)
            and all(tensor_bits_equal(a[k], b[k]) for k in a))
    path = Path(directory) / "checkpoint.pt"
    return {"same_loss": loss == loss_r, "same_pred": np.array_equal(
                pred, pred_r), "same_state": same,
            "loss": loss, "bytes": path.stat().st_size, "save_s": save_s,
            "load_s": load_s, "launches": counts,
            "blocks": len(whole._shards)}


def mesh_export(rank, device, directory):
    """34e: the Kaggle DeepFM on a (1, 2) mesh with its tables sharded,
    3 sgd steps (34b's leg), then ``export_predict`` on every rank and
    ``save_exported`` (rank 0 writes), and rank 0 writes the requests the
    fresh process scores; returns the mesh's predictions of them, the
    export and save seconds and the fit's launches."""
    from deepctr_tpu_torch.parallel import make_mesh
    mesh = make_mesh((1, 2), devices="cuda")
    model, res = mesh_leg("kaggle", "sgd", device, mesh, True)
    _, _, Xp = mesh_data("kaggle", device)
    n = max(SERVE_BATCHES)
    t0 = time.perf_counter()
    exported = serving.export_predict(model)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serving.save_exported(exported, str(Path(directory) / "mesh.pt2"))
    save_s = time.perf_counter() - t0
    if rank == 0:
        np.save(Path(directory) / "X.npy", Xp[:n].cpu().numpy())
    return {"pred": res["pred"][:n], "export_s": export_s, "save_s": save_s,
            "launches": res["launches"], "tables": res["bytes"][0]}


def mesh_io_rank(rank, world, device, tsv, directory):
    """A rank of phases 34d-f."""
    from deepctr_tpu_torch.parallel import make_mesh
    out = {"stream": []}
    for shape, shard, optimizer, _ in MESH_IO_LEGS:
        mesh = make_mesh(shape, devices="cuda")
        out["stream"].append(mesh_stream_leg(tsv, device, optimizer, mesh,
                                             shard))
        torch.cuda.empty_cache()
    out["checkpoint"] = mesh_optim_checkpoint(
        device, str(Path(directory) / "ckpt"))
    torch.cuda.empty_cache()
    out["export"] = mesh_export(rank, device, directory)
    return out


def phase_mesh_io(device):
    """Phases 34d-f on two gloo ranks of the card: the streamed fit on a
    mesh against this process's streamed fit, a torch.optim checkpoint's
    exact resume on a mesh, and a mesh's export scored in a fresh
    process."""
    from deepctr_tpu_torch.tools.multiprocess_sim import spawn
    pt.set_compute_dtype("float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = scratch_dir("mesh_io")
    try:
        tsv = d / "criteo.tsv"
        write_criteo_tsv(tsv, STREAM_ROWS, SEED + 800)
        t0 = time.perf_counter()
        with native_only():
            ranks = spawn(str(HERE / "chip_smoke.py") + ":mesh_io_rank", 2,
                          str(scratch_dir("mesh_io_ranks")),
                          {"tsv": str(tsv), "directory": str(d)},
                          timeout=MESH_TIMEOUT, backend="gloo",
                          device="cuda")
            log("34d-f: two gloo ranks on the card ran in %.1f s"
                % (time.perf_counter() - t0))
            want = {opt: mesh_stream_leg(str(tsv), device, opt)
                    for opt in ("adagrad", "sgd")}
            want["swapped"] = mesh_stream_leg(str(tsv), device, swap=True)
        for r in ranks:
            for part in r["stream"] + [r["checkpoint"], r["export"]]:
                add_rank_counts(part["launches"])
        mesh_checkpoint_line(ranks)
        mesh_export_line(ranks, d)
        mesh_stream_lines(ranks, want)
    finally:
        shutil.rmtree(d)


def mesh_stream_lines(ranks, want):
    """34d: each leg's ranks against this process's streamed fit under
    the same optimizer, and the swapped-halves witness of the data
    axis's reordering under adagrad."""
    failed = False
    for opt in ("adagrad", "sgd"):
        log("34d streamed fit without a mesh (graphed), %s, the reference: "
            "losses %s; %r ms a chunk (median; %s); launches %s"
            % (opt, want[opt]["loss"],
               statistics.median(want[opt]["chunk_ms"]),
               ["%.1f" % t for t in want[opt]["chunk_ms"]],
               {k: v for k, v in want[opt]["launches"].items() if v}))
    wp, (wb, wwhere, wscale) = mesh_leg_errors(
        "34d witness", [want["swapped"]], want["adagrad"])
    log("34d witness, adagrad, one process, each whole batch's halves "
        "swapped, against one process: losses %s, predictions %.3g, touched "
        "rows %.3g (%s, touched |w| up to %.3g)"
        % (want["swapped"]["loss"], wp, wb, wwhere, wscale))
    for i, (shape, shard, opt, held) in enumerate(MESH_IO_LEGS):
        got = [r["stream"][i] for r in ranks]
        label = "34d streamed fit %s%s %s" % (
            shape, " sharded" if shard else "", opt)
        for r in got:
            check(r["loss"] == got[0]["loss"], "%s: the ranks' losses "
                  "differ" % label)
            check(r["launches"]["row_update"] > 0, "%s: no row_update"
                  % label)
            if shard:
                check(len(r["blocks"]) == len(CRITEO_KAGGLE_VOCABS), "%s: "
                      "%d tables sharded" % (label, len(r["blocks"])))
        worst_p, (worst_b, where, scale) = mesh_leg_errors(label, got,
                                                           want[opt])
        tol, btol = MESH_TOL[opt], MESH_BLOCK_TOL[opt, shape[0]]
        if held:
            failed = failed or worst_p > tol or worst_b > btol
        bounds = ("bound %g" % tol, "bound %g" % btol) if held else (
            "not held: the witness above", "not held")
        log("%s (%s), %d rows in chunks of %d, one epoch: losses "
            "%s (one process %s); predictions of %d rows (%d at 0 or 1) "
            "%.3g from one "
            "process's (%s), touched rows %.3g (%s, %s, touched "
            "|w| up to %.3g); per rank: ms a chunk %s (median; every chunk "
            "%s), wall %s ms, device busy %s ms of the profiled epoch, idle "
            "share %s, host half %s ms a chunk, tables %s bytes, state %s "
            "bytes, launches %s (gloo through the host on one card, not a "
            "scaling figure)"
            % (label, card_line(), STREAM_ROWS, STREAM_CHUNK, got[0]["loss"],
               want[opt]["loss"], MESH_STREAM_CHECKED,
               check_predictions(got[0]["pred"], MESH_STREAM_CHECKED),
               worst_p, bounds[0],
               worst_b, bounds[1], where, scale,
               ["%.1f" % statistics.median(r["chunk_ms"]) for r in got],
               [["%.1f" % t for t in r["chunk_ms"]] for r in got],
               ["%.1f" % r["wall_ms"] for r in got],
               ["%.1f" % (r["busy_ms"] or float("nan")) for r in got],
               ["%.3f" % (1 - r["busy_ms"] / r["wall_ms"])
                if r["busy_ms"] else "not measured" for r in got],
               ["%.1f" % r["host_ms"] for r in got],
               [r["bytes"][0] for r in got], [r["bytes"][1] for r in got],
               [{k: v for k, v in r["launches"].items() if v} for r in got]))
    check(not failed, "34d: a leg is over its bound (the lines above)")


def mesh_checkpoint_line(ranks):
    """34f: the resumed epoch bit-equal on each rank."""
    for r in (x["checkpoint"] for x in ranks):
        for key in ("same_loss", "same_pred", "same_state"):
            check(r[key], "34f: the resumed epoch is not bit-equal to the "
                  "uninterrupted one (%s)" % key)
        check(r["blocks"] > 0, "34f: no table sharded")
    c = [x["checkpoint"] for x in ranks]
    log("34f torch.optim.Adagrad checkpoint on (1, 2), Kaggle DeepFM (%d "
        "tables sharded, dense under an optimizer object), %d steps an "
        "epoch (%s): the resumed second epoch bit-equal to the "
        "uninterrupted one on both ranks (loss %r, predictions, every "
        "table, weight and optimizer state); checkpoint %d bytes (written "
        "by rank 0), save %s s, load %s s by rank"
        % (c[0]["blocks"], MESH_STEPS, card_line(), c[0]["loss"],
           c[0]["bytes"], ["%.2f" % r["save_s"] for r in c],
           ["%.2f" % r["load_s"] for r in c]))


def mesh_export_line(ranks, d):
    """34e: the artifact written by rank 0, scored in a fresh process,
    against the mesh's predictions; its bytes cover every table whole."""
    e = [x["export"] for x in ranks]
    path = d / "mesh.pt2"
    full = sum(CRITEO_KAGGLE_VOCABS) * (EMB_DIM + 1) * 4
    size = path.stat().st_size
    check(size >= full, "34e: the artifact holds %d bytes, less than the "
          "%d of the whole tables" % (size, full))
    check(np.array_equal(e[0]["pred"], e[1]["pred"]), "34e: the ranks "
          "predict differently")
    report = fresh_process_serve(path, d / "X.npy", d / "out.npz")
    got = np.load(d / "out.npz")
    check(report["gather_launches"] == len(SERVE_BATCHES), "34e: the "
          "serving process launched the gather %d times for %d batches"
          % (report["gather_launches"], len(SERVE_BATCHES)))
    parts = []
    for b in SERVE_BATCHES:
        g = got["b%d" % b].astype("float64")
        check(g.shape == (b, 1), "34e: artifact output %s at B=%d"
              % (g.shape, b))
        diff = float(np.abs(g - e[0]["pred"][:b]).max())
        check(diff <= ATOL_CPU, "34e: artifact vs the mesh's predict at "
              "B=%d: max |dp| %r > %r" % (b, diff, ATOL_CPU))
        parts.append("B=%d max |dp| %r" % (b, diff))
    log("34e export on (1, 2), Kaggle DeepFM after 3 sgd steps (%s): "
        "export_predict on both ranks %s s, save_exported (rank 0 writes) "
        "%s s, %d bytes (the whole tables %d bytes; a rank held %s bytes of "
        "tables); a fresh process (no model, no mesh) loaded it in %.2f s "
        "on %s: %s against the mesh's predict (atol %r)"
        % (card_line(), ["%.2f" % r["export_s"] for r in e],
           ["%.2f" % r["save_s"] for r in e], size, full,
           [r["tables"] for r in e], report["load_s"], report["device"],
           "; ".join(parts), ATOL_CPU))


# ---------------------------------------------------------------------------
# phase 35: the rest of the feature set (adam's per-row step count on K2,
# Dice and PReLU in the CIN and the stacked experts, the example recipes)
# ---------------------------------------------------------------------------

ROWWISE_STEPS = 3
# counts drawn for the state's t in the kernel-vs-plain cases, and the
# rows of their table of (1 - b1^t, 1 - b2^t) pairs
ROWWISE_MAX_T = 40
ROWWISE_PAIRS = 64


def rowwise_k2_case(tables, grads, rows, l2s, what, seed, blocks=None):
    """K2 in rowwise mode against ``row_update_ref`` on copies of
    ``tables``, adam's moments uniform and each row's count t uniform in
    [0, ROWWISE_MAX_T) from ``seed``: every table, moment and count bit
    for bit, no row but the touched ones changed (its count included),
    each touched row's count one more.  ``blocks``: cut each table to one
    model rank's block ``(first row, stop, vocab, rows a block)`` and take
    the rows ``shard_local_rows`` gives it, as a mesh rank's step does.
    Returns max |err|."""
    from deepctr_tpu_torch.parallel.update import shard_local_rows
    device = tables[0].device
    gen = torch.Generator(device=device).manual_seed(seed)
    if blocks is not None:
        tables = [t[b[0]:b[1]] for t, b in zip(tables, blocks)]
        rows = [shard_local_rows(r, b) for r, b in zip(rows, blocks)]
    pairs = torch.from_numpy(rowup.bias_correction_table(
        ROWWISE_PAIRS)).to(device)
    plain_w = [t.clone() for t in tables]
    kern_w = [same_offset_copy(t) for t in tables]
    plain_s = [(torch.rand(t.shape, generator=gen, device=device),
                torch.rand(t.shape, generator=gen, device=device),
                torch.randint(0, ROWWISE_MAX_T, (t.shape[0],), generator=gen,
                              device=device, dtype=torch.int32))
               for t in tables]
    kern_s = [tuple(a.clone() for a in st) for st in plain_s]
    first = [tuple(a.clone() for a in st) for st in plain_s]
    args = (grads, rows, l2s, 0.001, [pairs] * len(tables))
    want_launches = len(rowup.launch_plan(
        [len(r) for r in rows],
        rowup.table_routes(kern_w, kern_s, grads, rows, l2s)))
    before = LAUNCHES["row_update"]
    rowup.row_update("adam", kern_w, kern_s, *args)
    launches = LAUNCHES["row_update"] - before
    check(launches == want_launches, "row_update (adam, rowwise) launched "
          "%d times at %s, its plan %d" % (launches, what, want_launches))
    rowup.row_update_ref("adam", plain_w, plain_s, *args)
    torch.cuda.synchronize()
    err = 0.0
    n_touched = 0
    for w, pw, st, ps, st0, w0, r in zip(kern_w, plain_w, kern_s, plain_s,
                                         first, tables, rows):
        for a, b in ((w, pw),) + tuple(zip(st, ps)):
            check(tensor_bits_equal(a, b), "row_update (adam, rowwise) "
                  "differs from its plain version at %s" % what)
        err = max(err, (w - pw).abs().max().item())
        touched = torch.zeros(w.shape[0], dtype=torch.bool, device=device)
        touched[r[r < w.shape[0]]] = True
        n_touched += int(touched.sum())
        check(torch.equal(st[2][touched], st0[2][touched] + 1),
              "row_update (adam, rowwise): a touched row's count did not "
              "advance by one at %s" % what)
        for a, a0 in ((w, w0),) + tuple(zip(st, st0)):
            check(tensor_bits_equal(a[~touched], a0[~touched]),
                  "row_update (adam, rowwise) changed other rows than the "
                  "touched ones at %s" % what)
    log("kernel vs plain: row_update (adam, rowwise) bit-equal at %s "
        "(max_abs_err %r): tables, m, v and t; %d touched rows' counts one "
        "more, every other row and count unchanged; %d launch(es) as planned"
        % (what, err, n_touched, want_launches))
    return err


def rowwise_bounds(tables, rows, pairs_rows):
    """The rowwise adam call's least time: table mode's bytes (k2_bounds)
    plus each touched row's count read and written (8 bytes) and the table
    of pairs read once."""
    n_ms, _, n_bytes, _ = k2_bounds("adam", tables, [
        (t, t) for t in tables], rows)
    touched = sum(valid_counts(rows, tables))
    n_bytes += 8 * touched + 8 * pairs_rows
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_bytes


def kaggle_adam(device, seed_model=None):
    """The Criteo Kaggle DeepFM under named adam, "auto": 8 sparse
    tables."""
    cols = criteo_columns()
    model = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                   seed=SEED, device=device)
    if seed_model is not None:
        model.set_weights(seed_model.get_weights())
    model.compile("adam", "binary_crossentropy")
    return model


def phase_adam_rowwise(device):
    """phase 35a: K2's rowwise mode.  Returns its entry for the kernels
    line."""
    from deepctr_tpu_torch.models import basemodel
    from deepctr_tpu_torch.parallel.sharding import table_block
    torch.backends.cuda.matmul.allow_tf32 = False
    pt.set_compute_dtype("float32")
    pt.set_adam_t("rowwise")
    try:
        graphed = kaggle_adam(device)
        paths = [p for p, _, _ in graphed._sparse_specs]
        check(len(paths) == 8 and all(
            len(graphed._table_state[p]) == 3 for p in paths),
            "rowwise adam: sparse tables %s, states of %s tensors"
            % (paths, [len(graphed._table_state[p]) for p in paths]))
        gen = torch.Generator(device=device).manual_seed(SEED + 900)
        X = criteo_requests(BATCH * ROWWISE_STEPS, gen, device)
        y = criteo_labels(BATCH * ROWWISE_STEPS, SEED + 901)
        touched = graphed._touched_rows(X[:BATCH])
        g = torch.Generator(device=device).manual_seed(SEED + 902)
        for grad in touched.grads:
            grad.normal_(generator=g)
        tables = [graphed._tables()[p].detach() for p in paths]
        l2s = [graphed._table_l2_vec(p) for p in paths]
        what = "Criteo Kaggle (%d touched rows in %d slots of %d tables)" % (
            sum(valid_counts(touched.rows, tables)),
            sum(len(r) for r in touched.rows), len(paths))
        err = rowwise_k2_case(tables, touched.grads, touched.rows, l2s, what,
                              SEED + 903)
        blocks = [table_block(2, 1, *t.shape) for t in tables]
        cut = [i for i, b in enumerate(blocks) if b is not None]
        check(cut, "no sparse Kaggle table shards at (1, 2)")
        err = max(err, rowwise_k2_case(
            [tables[i] for i in cut], [touched.grads[i] for i in cut],
            [touched.rows[i] for i in cut], [l2s[i] for i in cut],
            "model rank 1's block of the (1, 2) mesh (%d of the sparse "
            "tables)" % len(cut), SEED + 904,
            blocks=[(blocks[i][0], blocks[i][1], tables[i].shape[0],
                     blocks[i][2]) for i in cut]))

        # 3 captured steps against the same steps with the plain version
        eager = kaggle_adam(device, seed_model=graphed)
        _, loop, counts, replays = loop_fit(graphed, X, y, BATCH)
        check(counts["row_update"] == ROWWISE_STEPS and replays ==
              ROWWISE_STEPS - 1, "rowwise adam graphed fit: launches %s, "
              "%d replays" % (counts, replays))
        y_dev = torch.as_tensor(y, device=device).view(-1, 1)
        sw = torch.ones(BATCH, device=device)
        real = basemodel.row_update
        basemodel.row_update = rowup.row_update_ref
        try:
            eager._begin_steps(ROWWISE_STEPS)
            totals = [eager._train_step(X[i * BATCH:(i + 1) * BATCH],
                                        y_dev[i * BATCH:(i + 1) * BATCH],
                                        sw)[1]
                      for i in range(ROWWISE_STEPS)]
        finally:
            basemodel.row_update = real
        check(tensor_bits_equal(loop.losses, torch.stack(totals)),
              "rowwise adam: graphed losses %s, plain %s" % (
                  loop.losses.tolist(), [float(t) for t in totals]))
        check_same_state(training_state(graphed), training_state(eager),
                         "rowwise adam: graphed K2 vs the plain version")
        counts_t = [graphed._table_state[p][2] for p in paths]
        log("fit f32 rowwise adam, Criteo Kaggle: %d captured steps of %d "
            "(launches %s) bit-equal to the same steps with K2's plain "
            "version: losses %s, every weight, moment and count; rows "
            "touched %s, the most steps a row took %d"
            % (ROWWISE_STEPS, BATCH, counts, loop.losses.tolist(),
               [int((c > 0).sum()) for c in counts_t],
               max(int(c.max()) for c in counts_t)))
        del eager
        torch.cuda.empty_cache()

        # K2 timed in both modes at the touched rows of one batch
        log("timing on: %s" % card_line())
        pairs_rows = graphed._row_bias.shape[0]
        upd_row = (tables, [graphed._table_state[p] for p in paths],
                   touched.grads, touched.rows, l2s, 0.001)
        upd_tab = (tables, [graphed._table_state[p][:2] for p in paths],
                   touched.grads, touched.rows, l2s, 0.001)
        saved = [t.clone() for t in tables] + [
            a.clone() for p in paths for a in graphed._table_state[p]]
        t_row = k2_times("adam", upd_row, [graphed._row_bias] * len(paths))
        t_tab = k2_times("adam", upd_tab, k2_bias("adam", len(paths),
                                                  device))
        with torch.no_grad():
            for a, b in zip(tables + [a for p in paths
                                      for a in graphed._table_state[p]],
                            saved):
                a.copy_(b)
        row_bound, row_bytes = rowwise_bounds(tables, touched.rows,
                                              pairs_rows)
        tab_bound = k2_bounds("adam", tables, [(t, t) for t in tables],
                              touched.rows)
        log(k2_line("adam, rowwise", what, t_row, (row_bound, float("nan"),
                                                    row_bytes, 0)))
        log(k2_line("adam, per table", what, t_tab, tab_bound))
        del graphed
        torch.cuda.empty_cache()

        # the device-loop fit in both modes, alternating
        pt.set_compute_dtype("bfloat16")
        Xt = criteo_requests(BATCH * N_BATCHES, gen, device)
        yt = torch.as_tensor(criteo_labels(BATCH * N_BATCHES, SEED + 905),
                             device=device).view(-1, 1)
        models = {}
        for mode in ("table", "rowwise"):
            pt.set_adam_t(mode)
            models[mode] = kaggle_adam(device)
        times = {m: [] for m in models}
        for m in models.values():
            m.fit(Xt, yt, batch_size=BATCH, epochs=1, verbose=0)
        for _ in range(LOOP_RUNS):
            for mode, m in models.items():
                times[mode] += run_ms(lambda m=m: m.fit(
                    Xt, yt, batch_size=BATCH, epochs=1, verbose=0), runs=1)
        for mode in models:
            log("fit bf16 adam Criteo Kaggle, device-resident loop, %d steps "
                "of %d, %s step count on %s: %s" % (
                    N_BATCHES, BATCH, mode, card_line(),
                    rate_line(BATCH * N_BATCHES, times[mode])))
        del models
        torch.cuda.empty_cache()
    finally:
        pt.set_adam_t("table")
        pt.set_compute_dtype("float32")
    return dict(rowwise_max_abs_err=err, rowwise_ms=t_row["call cold"],
                rowwise_bound_ms=row_bound,
                adam_table_ms=t_tab["call cold"],
                adam_table_bound_ms=tab_bound[0])


# phase 35b: the activations with parameters, at CIN 256-256 (the bench's
# width with equal sizes) and the multi-task models at Criteo width
ACT_CIN = (256, 256)
ACT_STEPS = 2
ACT_CPU_BATCH = 512


def param_act_model(name, act, device):
    """xDeepFM with ``cin_activation=act`` at CIN 256-256, or MMOE/PLE
    with ``dnn_activation=act``, weights redrawn as phases 17 and 22 draw
    them; the activations' parameters and Dice's running statistics drawn
    from the seed too, so that they count."""
    if name == "xDeepFM":
        cols = xdeepfm_columns()
        model = xDeepFM(cols, cols, dnn_hidden_units=XD_HIDDEN,
                        cin_layer_size=ACT_CIN, cin_activation=act,
                        seed=SEED, device=device)
        gen = torch.Generator(device=device).manual_seed(SEED + 410)
        with torch.no_grad():
            for key, p in model.named_parameters():
                if key.startswith("dnn.") and p.dim() == 2:
                    p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
                elif "embedding_dict" in key:
                    p.normal_(0.0, XD_EMB_STD, generator=gen)
    else:
        model = zoo_model(name, device, dnn_activation=act)
    gen = torch.Generator(device=device).manual_seed(SEED + 950)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if key.endswith(".alpha"):
                t.normal_(0.0, 0.3, generator=gen)
            elif ".bn.mean" in key and ("Dice_" in key):
                t.normal_(0.0, 0.1, generator=gen)
            elif ".bn.var" in key and ("Dice_" in key):
                t.uniform_(0.5, 1.5, generator=gen)
    return model


def phase_param_activations(device):
    """phase 35b: xDeepFM with a Dice and a PReLU CIN, MMOE and PLE with
    Dice experts, float32: graphed predict of 8 batches (K6 twice a
    batch for xDeepFM), the first batch within 1e-5 of the same model on
    the CPU; then ACT_STEPS sgd steps on the card and on the CPU from the
    same weights: per-step losses within 1e-5 relative and the
    predictions after within 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_compute_dtype("float32")
    cases = [("xDeepFM", "dice"), ("xDeepFM", "prelu"), ("MMOE", "dice"),
             ("PLE", "dice")]
    n = BATCH * N_BATCHES
    for i, (name, act) in enumerate(cases):
        model = param_act_model(name, act, device)
        X = (xdeepfm_requests(n, SEED + 960 + i, device) if name ==
             "xDeepFM" else zoo_requests(name, n, SEED + 960 + i, device))
        reset_counts()
        pred = model.predict(X, batch_size=BATCH)
        counts = read_counts()
        if name == "xDeepFM":
            check(counts["cin_mix"] == 2 * N_BATCHES, "xDeepFM %s predict: "
                  "cin_mix launched %d times in %d batches" % (
                      act, counts["cin_mix"], N_BATCHES))
        check(counts["gather_rows"] == N_BATCHES, "%s %s predict: %d "
              "gathers" % (name, act, counts["gather_rows"]))
        check_predictions(pred, n, model.num_tasks)
        cpu = param_act_model(name, act, "cpu")
        cpu.set_weights(model.get_weights())
        pred_cpu = cpu.predict(X[:BATCH].cpu(), batch_size=BATCH)
        diff = float(np.abs(pred[:BATCH] - pred_cpu).max())
        check(diff <= ATOL_CPU, "%s %s: card vs CPU max |dp| %r > %r"
              % (name, act, diff, ATOL_CPU))
        m = ACT_CPU_BATCH * ACT_STEPS
        x = X[:m].cpu().numpy()
        y = (criteo_labels(m, SEED + 970 + i) if name == "xDeepFM"
             else zoo_labels(name, m, SEED + 970 + i))
        loss = ("binary_crossentropy" if name == "xDeepFM"
                else zoo_loss(name))
        runs = {}
        for where, mm in (("card", model), ("cpu", cpu)):
            mm.compile("sgd", loss)
            rec = record_losses(mm)
            if where == "card":
                reset_counts()
            mm.fit(x, y, batch_size=ACT_CPU_BATCH, epochs=1, verbose=0,
                   shuffle=False)
            if where == "card":
                fit_counts = read_counts()
            runs[where] = rec
        rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"],
                                                       runs["cpu"]))
        check(len(runs["card"]) == ACT_STEPS and rel <= 1e-5,
              "%s %s sgd: losses card %s, CPU %s" % (
                  name, act, runs["card"], runs["cpu"]))
        if name == "xDeepFM":
            check(fit_counts["cin_mix"] == 2 * ACT_STEPS, "xDeepFM %s fit: "
                  "cin_mix launched %d times" % (act, fit_counts["cin_mix"]))
        after = model.predict(X[:BATCH], batch_size=BATCH)
        after_cpu = cpu.predict(X[:BATCH].cpu(), batch_size=BATCH)
        diff_after = float(np.abs(after - after_cpu).max())
        check(diff_after <= ATOL_CPU, "%s %s after sgd: card vs CPU max "
              "|dp| %r" % (name, act, diff_after))
        log("%s %s on %s, float32: predict launches %s, predictions in "
            "[%.6f, %.6f], std %.6f, first batch vs CPU max |dp| %r; %d sgd "
            "steps of %d, launches %s, losses card %s CPU %s (max rel %r), "
            "predictions after vs CPU max |dp| %r (atol %r)"
            % (name, act, card_line(), counts, pred.min(), pred.max(),
               pred.std(), diff, ACT_STEPS, ACT_CPU_BATCH, fit_counts,
               runs["card"], runs["cpu"], rel, diff_after, ATOL_CPU))
        del model, cpu
        torch.cuda.empty_cache()


def phase_recipes(device):
    """phase 35c: the seven example recipes called in process,
    ``main(epochs=1, device="cuda")``, each printing its metrics; every
    metric finite (a batch of one class has no AUC), the launches each
    ran."""
    from deepctr_tpu_torch.examples import (
        run_classification_criteo, run_dien, run_din,
        run_multitask_learning, run_multivalue_movielens,
        run_regression_movielens, run_streaming_criteo)
    pt.set_compute_dtype("float32")
    need = {"run_dien": ("gather_rows", "scatter_add_rows", "gru_scan",
                         "gru_scan_bwd")}
    for recipe in (run_classification_criteo, run_regression_movielens,
                   run_multivalue_movielens, run_multitask_learning,
                   run_din, run_dien, run_streaming_criteo):
        short = recipe.__name__.split(".")[-1]
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = recipe.main(epochs=1, device=str(device))
        seconds = time.perf_counter() - t0
        counts = read_counts()
        for key, value in out.items():
            values = np.asarray(value, np.float64).reshape(-1)
            check(np.isfinite(values).all() or key == "auc",
                  "%s: %s = %r" % (short, key, value))
        for name in need.get(short, ("gather_rows", "scatter_add_rows")):
            check(counts[name] > 0, "%s: %s never launched" % (short, name))
        log("recipe %s on %s: %.2f s, launches %s, %s" % (
            short, card_line(), seconds,
            {k: v for k, v in counts.items() if v}, out))


# phase 36: the dense parameters' optimizer step in one launch.  Bytes a
# float each optimizer moves (parameter, gradient and state read;
# parameter and state written)
DENSE_BYTES_PER_FLOAT = {"sgd": 12, "adagrad": 20, "rmsprop": 20,
                         "adam": 28}
DENSE_LR = {"sgd": 0.01, "adagrad": 0.0123, "rmsprop": 0.01, "adam": 0.001}


def benchmark_dense_shapes(device):
    """The dense parameters of the benchmark's two models
    (``portbench/configs``), as their named optimizer steps them:
    ``{label: ([shape, ...], [L2 vector or None, ...], [(parameter, l2,
    column mask or None), ...])}``, the vectors the compiled rules give
    the dense optimizer (numpy) and the eager penalty's terms they
    replaced."""
    from portbench.harness import program
    out = {}
    for label, name in (("DeepFM Criteo Kaggle", "deepfm_criteo_kaggle"),
                        ("DIEN Amazon Books", "dien_amazon_books")):
        config = json.loads((HERE / "portbench" / "configs"
                             / ("%s.json" % name)).read_text())
        model = program.build(config, device, SEED)
        program.compile_model(model, config)
        index = {id(p): i for i, p in enumerate(model._dense_opt.params)}
        terms = [(index[id(w)], l2, None if mask is None
                  else mask.cpu().numpy())
                 for w, _, l2, mask in model._reg_entries() if l2 > 0]
        model._ensure_compiled()
        out[label] = ([tuple(p.shape) for p in model._dense_opt.params],
                      [None if v is None else v.cpu().numpy()
                       for v in model._dense_opt.l2], terms)
        del model
        torch.cuda.empty_cache()
    pt.set_compute_dtype("float32")
    return out


def drawn_l2(shapes, seed):
    """An L2 vector a parameter, as numpy: per column for a [rows, width]
    table of width under 32, [1] otherwise, None for every fifth."""
    rng = np.random.default_rng(seed)
    return [None if i % 5 == 4 else rng.uniform(1e-6, 1e-4, (
        s[1] if len(s) == 2 and s[1] < 32 else 1)).astype(np.float32)
        for i, s in enumerate(shapes)]


def dense_problem(name, shapes, seed, device, offsets=None):
    """Parameters, a state tuple each (random; the sums non-negative),
    gradients (every fourth None, a zero gradient) and adam's bias pair at
    step 3, each array ``offsets[i]`` floats past an allocation."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_state = rowup.MODES[name][1]

    def draw(shape, off, square=False):
        n = int(np.prod(shape))
        t = torch.empty(n + off, device=device)[off:].view(shape)
        t.normal_(generator=gen)
        return t.mul_(t) if square else t
    params, grads, states = [], [], []
    for i, shape in enumerate(shapes):
        off = offsets[i] if offsets else 0
        params.append(draw(shape, off))
        grads.append(None if i % 4 == 3 else draw(shape, off))
        states.append(tuple(draw(shape, off, j == n_state - 1)
                            for j in range(n_state)))
    bias = torch.tensor(rowup.adam_bias_corrections(3), device=device)
    return params, grads, states, bias


def phase_dense_update(device):
    """phase 36: ``dense_update`` against ``dense_update_ref`` on the card,
    bit for bit, for each optimizer at the benchmark models' dense shapes
    with their L2 vectors and at 3 x DIEN's with drawn ones (past a
    launch's capacity, every third array one float past a 16-byte
    boundary); then adam's device ms with a cold L2 at each model's
    shapes: the kernel alone (structs built beforehand), the whole call,
    and the chain of PyTorch operations it replaced, with the device
    operations of each, beside the bytes bound; then the penalty's launch
    (``phase_dense_penalty``).  Returns the entries of both for the
    kernels line."""
    models = benchmark_dense_shapes(device)
    cases = {label: (shp, l2s, None)
             for label, (shp, l2s, _) in models.items()}
    wide = models["DIEN Amazon Books"][0] * 3
    cases["3 x DIEN, one float past 16 bytes"] = (
        wide, drawn_l2(wide, SEED + 962),
        [int(i % 3 == 1) for i in range(len(wide))])
    for name in rowup.MODES:
        for label, (shp, l2_np, offsets) in cases.items():
            got_p, grads, got_s, bias = dense_problem(name, shp, SEED + 960,
                                                      device, offsets)
            l2s = [None if v is None else torch.from_numpy(v).to(device)
                   for v in l2_np]
            want_p = [p.clone() for p in got_p]
            want_s = [tuple(a.clone() for a in st) for st in got_s]
            plan = dense_update.launch_plan([int(np.prod(s)) for s in shp])
            before = LAUNCHES["dense_update"]
            for _ in range(3):
                dense_update.dense_update(name, got_p, grads, got_s,
                                          DENSE_LR[name], bias, l2s=l2s)
                dense_update.dense_update_ref(name, want_p, grads, want_s,
                                              DENSE_LR[name], bias, l2s=l2s)
            torch.cuda.synchronize()
            launches = LAUNCHES["dense_update"] - before
            what = ("dense_update %s at %s (%d parameters, %d floats, %d "
                    "L2 vectors)" % (name, label, len(shp),
                                     sum(int(np.prod(s)) for s in shp),
                                     sum(v is not None for v in l2s)))
            check(launches == 3 * len(plan), "%s: %d launches in 3 steps, "
                  "want %d" % (what, launches, 3 * len(plan)))
            check(all(same_bits(a, b) for a, b in zip(got_p, want_p)),
                  what + ": parameters differ from the plain version")
            check(all(same_bits(a, b) for sa, sb in zip(got_s, want_s)
                      for a, b in zip(sa, sb)),
                  what + ": state differs from the plain version")
            log("%s: 3 steps bit-equal to dense_update_ref on %s, %d "
                "launch(es) a step" % (what, card_line(), len(plan)))
    out = {}
    for label, (shp, l2_np, _) in models.items():
        params, grads, states, bias = dense_problem("adam", shp, SEED + 961,
                                                    device)
        l2s = [None if v is None else torch.from_numpy(v).to(device)
               for v in l2_np]
        n = sum(p.numel() for p in params)
        args = dense_update.kernel_args("adam", params, grads, states,
                                        DENSE_LR["adam"], bias, l2s)
        cache = DeviceArgs()
        fns = {
            "kernel": lambda: dense_update.launch(args, device),
            "call": lambda: dense_update.dense_update(
                "adam", params, grads, states, DENSE_LR["adam"], bias,
                cache=cache, l2s=l2s),
            "plain": lambda: dense_update.dense_update_ref(
                "adam", params, grads, states, DENSE_LR["adam"], bias,
                l2s=l2s)}
        ms = {k: device_ms(fn) for k, fn in fns.items()}
        ops = {k: profile_launches(fn)[1] for k, fn in fns.items()}
        bound = n * DENSE_BYTES_PER_FLOAT["adam"] / HBM_BYTES_PER_S * 1e3
        log("dense_update adam at %s on %s (%d parameters, %d floats, "
            "%d bytes): kernel %r ms, whole call %r ms, the PyTorch chain "
            "%r ms (device ms, cold L2, median of 20); device operations "
            "%s; bound %r ms (bytes at %g B/s)" % (
                label, card_line(), len(params), n,
                n * DENSE_BYTES_PER_FLOAT["adam"], ms["kernel"], ms["call"],
                ms["plain"], ops, bound, HBM_BYTES_PER_S))
        out[label] = dict(ms=ms["kernel"], call_ms=ms["call"],
                          plain_ms=ms["plain"], bound_ms=bound,
                          operations=ops)
    deepfm = out["DeepFM Criteo Kaggle"]
    return dict(max_abs_err=0.0, ms=deepfm["ms"],
                plain_ms=deepfm["plain_ms"], library_ms=None,
                bound_ms=deepfm["bound_ms"], bound_by="bytes",
                dien_ms=out["DIEN Amazon Books"]["ms"],
                dien_plain_ms=out["DIEN Amazon Books"]["plain_ms"],
                dien_bound_ms=out["DIEN Amazon Books"]["bound_ms"]), \
        phase_dense_penalty(device, *models["DeepFM Criteo Kaggle"])


def phase_dense_penalty(device, shapes, l2_np, terms):
    """phase 36, the penalty: ``dense_penalty`` at the benchmark DeepFM's
    dense parameters and L2 vectors, twice through one workspace and once
    through a fresh one, bit-equal, within 1e-6 of a float64 sum; its
    device ms with a cold L2 (the kernel alone, the whole call), the plain
    version's, and the eager autograd penalty it replaced (one term a
    rule, ``BaseModel._reg_loss`` and its backward into the gradients),
    the device operations of each, beside the bytes bound (4 a float of
    the parameters with L2).  Returns its entry for the kernels line."""
    gen = torch.Generator(device=device).manual_seed(SEED + 963)
    params = [torch.empty(s, device=device).normal_(generator=gen)
              .mul_(1e-2) for s in shapes]
    l2s = [None if v is None else torch.from_numpy(v).to(device)
           for v in l2_np]
    kept = [p for p, v in zip(params, l2s) if v is not None]
    plan = dense_update.launch_plan([p.numel() for p in kept])
    cache = DeviceArgs()
    before = LAUNCHES["dense_penalty"]
    runs = [dense_update.dense_penalty(params, l2s, cache).clone()
            for _ in range(2)]
    runs.append(dense_update.dense_penalty(params, l2s))
    torch.cuda.synchronize()
    launches = LAUNCHES["dense_penalty"] - before
    want = sum(float(torch.sum(v.double() * (p.double() ** 2).reshape(
        -1, v.numel()))) for p, v in zip(params, l2s) if v is not None)
    rel = abs(float(runs[0]) - want) / want
    what = "dense_penalty at DeepFM Criteo Kaggle (%d parameters with L2, " \
        "%d floats)" % (len(kept), sum(p.numel() for p in kept))
    check(launches == 3 * len(plan), "%s: %d launches in 3 calls, want %d"
          % (what, launches, 3 * len(plan)))
    check(same_bits(runs[0], runs[1]) and same_bits(runs[0], runs[2]),
          what + ": two calls differ")
    check(rel <= 1e-6, "%s: %r against the float64 sum %r" % (
        what, float(runs[0]), want))
    leaves = [p.clone().requires_grad_(True) for p in params]
    masks = [(i, l2, None if m is None else torch.from_numpy(m).to(device))
             for i, l2, m in terms]

    def eager():
        total = torch.zeros((), device=device)
        for i, l2, mask in masks:
            sq = leaves[i] * leaves[i]
            total = total + torch.sum(l2 * (sq if mask is None
                                            else sq * mask))
        total.backward()
        for w in leaves:
            w.grad = None
    work = dense_update.penalty_args(params, l2s)
    fns = {"kernel": lambda: dense_update.launch_penalty(work, device),
           "call": lambda: dense_update.dense_penalty(params, l2s, cache),
           "plain": lambda: dense_update.dense_penalty_ref(params, l2s),
           "eager": eager}
    ms = {k: device_ms(fn) for k, fn in fns.items()}
    ops = {k: profile_launches(fn)[1] for k, fn in fns.items()}
    n = sum(p.numel() for p in kept)
    bound = n * 4 / HBM_BYTES_PER_S * 1e3
    log("%s on %s: 3 calls bit-equal, %d launch(es) a call, %r against "
        "float64 (relative %r); kernel %r ms, whole call %r ms, plain %r "
        "ms, the eager autograd penalty it replaced (%d terms) %r ms "
        "(device ms, cold L2, median of 20); device operations %s; bound "
        "%r ms (bytes at %g B/s)" % (
            what, card_line(), len(plan), float(runs[0]), rel, ms["kernel"],
            ms["call"], ms["plain"], len(terms), ms["eager"], ops, bound,
            HBM_BYTES_PER_S))
    return dict(max_abs_err=rel, ms=ms["kernel"], plain_ms=ms["plain"],
                library_ms=None, bound_ms=bound, bound_by="bytes",
                call_ms=ms["call"], eager_ms=ms["eager"], operations=ops)


# phase 37: the CIN backward's kernels at the benchmark xDeepFM's layer
# shapes (arXiv:1803.05170 section 4.1.3: B=4096, E=10, F=26, three layers
# of 200 maps; layers 1 and 2 share a shape)
CIN_BWD_LAYERS = ((26, 200, 1), (200, 200, 2))
CIN_BWD_BATCH, CIN_BWD_EMB = 4096, 10


def cin_bwd_inputs(B, D, H, F, O, seed, device):
    """hidden [B, D, H], x0 [B, D, F], wt [F*H, O] and g [B, D, O] in
    bfloat16 at a trained layer's scales."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*size, std=1.0):
        return (torch.randn(*size, generator=gen, device=device)
                * std).to(torch.bfloat16)
    return (draw(B, D, H), draw(B, D, F), draw(F * H, O, std=(H * F) ** -0.5),
            draw(B, D, O, std=0.1))


def cin_bwd_float64(hidden, x0, wt, g):
    """(dh, dx, dwt) in float64 from the bfloat16 inputs."""
    B, D, H = hidden.shape
    F, O, M = x0.shape[2], g.shape[2], B * D
    h = hidden.reshape(M, H).double()
    x = x0.reshape(M, F).double()
    gg = g.reshape(M, O).double()
    dz = torch.matmul(gg, wt.double().t()).reshape(M, F, H)
    dh = torch.einsum("mfh,mf->mh", dz, x)
    dx = torch.einsum("mfh,mh->mf", dz, h)
    del dz
    z = (x[:, :, None] * h[:, None, :]).reshape(M, F * H)
    return dh.reshape(B, D, H), dx.reshape(B, D, F), torch.matmul(z.t(), gg)


def phase_cin_bwd(device):
    """phase 37: the CIN backward's kernels (``ops.cin.bwd_launch``)
    against a float64 evaluation from the same bfloat16 inputs, beside the
    einsums they replace (``cin_mix_bwd``): each of dh, dx and dwt, output
    by output, no further off than twice the einsums' largest error plus
    one bf16 ulp of the float64 value; a repeat bit-equal; then device ms
    with a cold L2 of
    the kernels and of the einsums at each layer shape and over the three
    layers, beside the bound (the two products at the bf16 rate).  A CIN
    of the cell's three layers trained one bf16 step counts its launches
    on the main path.  Returns its entry for the kernels line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for H, O, layers in CIN_BWD_LAYERS:
        shape = (CIN_BWD_BATCH, CIN_BWD_EMB, H, XD_FIELDS, O)
        hidden, x0, wt, g = cin_bwd_inputs(*shape, SEED + 970 + H, device)
        got = cin.bwd_launch(hidden, x0, wt, g)
        again = cin.bwd_launch(hidden, x0, wt, g)
        einsum = cin.cin_mix_bwd(hidden, x0, wt, g)
        want = cin_bwd_float64(hidden, x0, wt, g)
        torch.cuda.synchronize()
        what = "CIN backward B=%d D=%d H=%d F=%d O=%d" % shape
        errs = []
        for name, k, k2, e, w in zip(("dh", "dx", "dwt"), got, again, einsum,
                                     want):
            check(torch.equal(k.view(torch.int16), k2.view(torch.int16)),
                  "%s %s: a repeat differs" % (what, name))
            ulp = torch.exp2(torch.floor(torch.log2(
                w.abs().clamp_min(2.0 ** -126))) - 7)
            err_k = (k.double() - w).abs()
            err_e = (e.double() - w).abs().max().item()
            excess = (err_k - ulp).max().item()
            check(excess <= 2 * err_e, "%s %s: kernels off by %r past one "
                  "ulp, einsums by %r" % (what, name, excess, err_e))
            worst = max(worst, err_k.max().item())
            errs.append("%s %.3g (einsums %.3g)" % (name, err_k.max().item(),
                                                    err_e))
        ms = device_ms(lambda: cin.bwd_launch(hidden, x0, wt, g))
        plain_ms = device_ms(lambda: cin.cin_mix_bwd(hidden, x0, wt, g))
        B, D = CIN_BWD_BATCH, CIN_BWD_EMB
        bound = 4 * B * D * H * XD_FIELDS * O / BF16_FLOP_PER_S * 1e3
        ops = profile_launches(lambda: cin.bwd_launch(hidden, x0, wt, g))[1]
        log("%s on %s: max |err| vs float64 %s, repeat bit-equal; kernels "
            "%r ms, einsums %r ms (device ms, cold L2, median of 20), %d "
            "device operations a call; bound %r ms (products at %g FLOP/s)"
            % (what, card_line(), ", ".join(errs), ms, plain_ms, ops, bound,
               BF16_FLOP_PER_S))
        total["ms"] += layers * ms
        total["plain_ms"] += layers * plain_ms
        total["bound_ms"] += layers * bound
    log("CIN backward over the cell's three layers on %s: kernels %r ms, "
        "einsums %r ms, bound %r ms" % (card_line(), total["ms"],
                                        total["plain_ms"],
                                        total["bound_ms"]))
    # a bf16 training step of the cell's CIN on the main path's counters
    from deepctr_tpu_torch.layers.interaction import CIN
    pt.set_compute_dtype("bfloat16")
    pt.set_cin_dtype("bf16")
    gen = torch.Generator(device=device).manual_seed(SEED + 975)
    layer = CIN(XD_FIELDS, (200, 200, 200), activation="linear",
                split_half=False, device=device, generator=gen)
    xin = (torch.randn(1024, XD_FIELDS, CIN_BWD_EMB, device=device,
                       generator=gen) * 0.05).requires_grad_()
    reset_counts()
    einsums = LAUNCHES["cin_mix_bwd_einsum"]
    layer(xin, training=True).float().sum().backward()
    torch.cuda.synchronize()
    counts = read_counts()
    einsums = LAUNCHES["cin_mix_bwd_einsum"] - einsums
    check(counts["cin_mix_bwd"] == 21 and einsums == 0,
          "a bf16 CIN step of three layers: %d backward launches, %d einsum "
          "backwards" % (counts["cin_mix_bwd"], einsums))
    pt.set_compute_dtype("float32")
    return dict(max_abs_err=worst, ms=total["ms"],
                plain_ms=total["plain_ms"], library_ms=None,
                bound_ms=total["bound_ms"], bound_by="operations")


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
    phase_serve_kaggle(model, X_all)
    del model, X_all
    torch.cuda.empty_cache()
    phase_stream_fit(device)
    torch.cuda.empty_cache()
    phase_serve_models(device)
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
    for kind, variant in SEQ_STEP_KERNELS:
        phase_seq_fit_f32(kind, variant, device)
    phase_seq_fit_sparse(device)
    for kind, variant in SEQ_STEP_KERNELS:
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
    torch.cuda.empty_cache()

    phase_cin_f32_output(device)
    phase_checkpoint_resume(device)
    kaggle = phase_checkpoint_kaggle(device)
    phase_dropout_loops(device, kaggle)
    del kaggle
    torch.cuda.empty_cache()
    phase_load_model(device)
    phase_optimizer_objects(device)
    phase_cin_modes(device)
    torch.cuda.empty_cache()

    twin = mesh_one_rank(device)
    zero_fill = mesh_gather_zero_fill(twin)
    phase_mesh(device, twin)
    del twin
    torch.cuda.empty_cache()
    phase_mesh_io(device)
    torch.cuda.empty_cache()

    rowwise = phase_adam_rowwise(device)
    phase_param_activations(device)
    phase_recipes(device)
    torch.cuda.empty_cache()
    dense, penalty = phase_dense_update(device)
    torch.cuda.empty_cache()
    cin_bwd = phase_cin_bwd(device)

    log(card_line())
    measured = {"gather_rows": dict(max_abs_err=err, **timing, **zero_fill),
                "scatter_add_rows": dict(max_abs_err=k1_err,
                                         **train_timing["scatter_add_rows"]),
                "row_update": dict(max_abs_err=k2_err,
                                   **train_timing["row_update"],
                                   **rowwise)}
    for name in ("gru_scan", "gru_scan_bwd", "din_attention"):
        measured[name] = dict(max_abs_err=seq_errs[name], **seq_timing[name])
    measured["cin_mix"] = dict(max_abs_err=cin_err, **cin_timing)
    measured["static_scatter"] = scatter
    measured["dense_update"] = dense
    measured["dense_penalty"] = penalty
    measured["cin_mix_bwd"] = cin_bwd
    kernels = []
    for name in KERNELS:
        check(MAIN_PATH_TOTALS[name] > 0, "%s never launched on the main "
              "path" % name)
        kernels.append(dict(name=name, launches=MAIN_PATH_TOTALS[name],
                            artifact_launches=ARTIFACT_TOTALS[name],
                            mesh_launches=MESH_TOTALS[name],
                            **measured[name], **KERNELS[name]))
    log("chip_smoke: %.1f s in all" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
