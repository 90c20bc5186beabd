"""Global framework configuration: the compute-dtype switch.

Counterpart of ``deepctr_tpu/config.py:11-26``.  Parameters stay float32;
the compute dtype is what every Dense layer casts its input and weights to.
There is no kernel switch: a kernel wrapper picks its plain PyTorch version
only for tensors on the CPU (see ``ops/gather.py``).
"""

import torch

_COMPUTE_DTYPE = torch.float32


def set_compute_dtype(dtype):
    """Set the activation/matmul compute dtype (params stay float32).

    Accepts a ``torch.dtype`` or its name, e.g. ``set_compute_dtype(
    'bfloat16')``.  Read on every forward.
    """
    global _COMPUTE_DTYPE
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError("compute dtype must be a floating torch dtype, "
                         "got %r" % (dtype,))
    _COMPUTE_DTYPE = dtype


def compute_dtype():
    return _COMPUTE_DTYPE
