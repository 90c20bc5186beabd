"""Global framework configuration: the compute dtype, the CIN's
compute-dtype mode, adam's step count on the sparse tables and the lookup
exchange of row-sharded tables.

Counterpart of ``deepctr_tpu/config.py:11-26`` and ``:270-308`` and of the
JAX CIN's ``DEEPCTR_CIN_DTYPE`` (``deepctr_tpu/layers/interaction.py:
136-150``).
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


_ADAM_T_MODES = ("table", "rowwise")
_ADAM_T = "table"


def set_adam_t(mode):
    """Adam's bias-correction step count on the sparse tables (the tables
    that ``compile``'s ``sparse_table_updates`` sends to the touched-rows
    update): ``"table"`` (the default: one count a table, advanced every
    step) or ``"rowwise"`` (an int32 count a row, advanced only on the
    steps that touch the row, as ``torch.optim.SparseAdam`` does).  Dense
    parameters and dense tables keep the global count either way.  Read by
    ``compile``, as the JAX package reads ``DEEPCTR_ADAM_T`` when it builds
    the table state (``deepctr_tpu/models/basemodel.py:538-540``); the port
    reads no environment variable.  Any other value raises."""
    global _ADAM_T
    if mode not in _ADAM_T_MODES:
        raise ValueError("adam step count must be one of %s, got %r"
                         % (", ".join(_ADAM_T_MODES), mode))
    _ADAM_T = mode


def adam_t():
    return _ADAM_T


# --------------------------------------------------------------------------
# The lookup exchange of row-sharded embedding tables on a device mesh
# (``deepctr_tpu/config.py:270-308``; ``parallel/embedding.py``).
#   "gspmd" - the default.  The port has no GSPMD: this is its default
#             exchange, which is the psum exchange.
#   "psum"  - every rank of the 'model' axis gathers the rows it owns
#             (zeros for the others) and one all-reduce sums them.
#   "a2a"   - ids bucketed by owner at a fixed capacity ceil(n/M) * slack,
#             exchanged with all_to_all, gathered there and sent back;
#             ids past a bucket's capacity are dropped (see
#             ``on_overflow``).
# --------------------------------------------------------------------------
_EXCHANGE_MODES = ("gspmd", "psum", "a2a")
_OVERFLOW_MODES = ("error", "drop")
_EMBEDDING_EXCHANGE = "gspmd"
_EXCHANGE_MESH = None
_A2A_SLACK = 2.0
_A2A_ON_OVERFLOW = "error"


def set_embedding_exchange(mode, mesh=None, a2a_slack=2.0,
                           on_overflow="error"):
    """Select how row-sharded embedding lookups exchange rows on a mesh:
    ``"gspmd"`` (the default, which runs the psum exchange here), ``"psum"``
    or ``"a2a"``.  The explicit modes need the ``mesh``.  Read at every
    lookup.

    ``on_overflow`` (a2a only): an id past its bucket's capacity is
    dropped, and then
      "error" (default): every looked-up row of the call is NaN, so that
          the first overflowing step gives a NaN loss; raise ``a2a_slack``
          to fix it;
      "drop": the dropped ids embed as zero rows.
    Any other mode or overflow setting raises ValueError."""
    global _EMBEDDING_EXCHANGE, _EXCHANGE_MESH, _A2A_SLACK, \
        _A2A_ON_OVERFLOW
    if mode not in _EXCHANGE_MODES:
        raise ValueError("embedding exchange must be one of %s, got %r"
                         % (", ".join(_EXCHANGE_MODES), mode))
    if on_overflow not in _OVERFLOW_MODES:
        raise ValueError("on_overflow must be one of %s, got %r"
                         % (", ".join(_OVERFLOW_MODES), on_overflow))
    if mode != "gspmd" and mesh is None:
        raise ValueError("explicit exchange modes need the mesh")
    _EMBEDDING_EXCHANGE = mode
    _EXCHANGE_MESH = mesh
    _A2A_SLACK = float(a2a_slack)
    _A2A_ON_OVERFLOW = on_overflow


def embedding_exchange():
    """``(mode, mesh, a2a slack)``."""
    return _EMBEDDING_EXCHANGE, _EXCHANGE_MESH, _A2A_SLACK


def a2a_on_overflow():
    return _A2A_ON_OVERFLOW
