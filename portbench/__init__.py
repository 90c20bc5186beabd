"""The benchmark of ``deepctr_tpu_torch`` (the PyTorch/CUDA port) on one
NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of is a file found by name:

- ``configs/<config>.json``: the model's sizes, its source and every size
  set by hand;
- ``traffic/<mix>.json``: the parameters the one generator
  (``harness/traffic.py``) and the cell's driver (``harness/<driver>.py``)
  read;
- ``reference/<config>.py``: the plain PyTorch model that decides
  ``correct``; it imports nothing of the program;
- ``limits/<cell>.json``: the limit of each number compared;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

Nothing here imports ``jax``, ``flax``, ``optax`` or ``deepctr_tpu``.
"""
