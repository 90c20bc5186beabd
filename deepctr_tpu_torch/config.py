"""Global framework configuration: the compute dtype and the CIN's
compute-dtype mode.

Counterpart of ``deepctr_tpu/config.py:11-26`` and of the JAX CIN's
``DEEPCTR_CIN_DTYPE`` (``deepctr_tpu/layers/interaction.py:136-150``).
Parameters stay float32; the compute dtype is what every Dense layer casts
its input and weights to.  There is no kernel switch: a kernel wrapper
picks its plain PyTorch version only for tensors on the CPU (see
``ops/gather.py``).
"""

import torch

_COMPUTE_DTYPE = torch.float32
_CIN_DTYPES = ("bf16", "carry", "f32")
_CIN_DTYPE = "bf16"


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


def set_cin_dtype(mode):
    """The CIN's compute-dtype mode in bfloat16 training: ``"bf16"`` (the
    default: operands and carried hidden maps in bfloat16), ``"carry"``
    (bfloat16 operands, float32 carried maps and kernel output) or
    ``"f32"`` (the whole stack in float32).  At other compute dtypes and
    at inference the CIN runs in the compute dtype whatever the mode.
    Read on every forward; any other value raises."""
    global _CIN_DTYPE
    if mode not in _CIN_DTYPES:
        raise ValueError("CIN dtype mode must be one of %s, got %r"
                         % (", ".join(_CIN_DTYPES), mode))
    _CIN_DTYPE = mode


def cin_dtype():
    return _CIN_DTYPE
