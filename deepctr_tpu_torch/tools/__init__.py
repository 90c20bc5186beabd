"""Measurement tools of the port, each run as ``python -m
deepctr_tpu_torch.tools.<name>`` on a machine with a CUDA card."""
