"""Model base: device, seeded init, batch assembly, predict, weights, and
the Keras-style training engine.

Counterpart of ``deepctr_tpu/models/basemodel.py``: ``__init__``
(:144-210), regularization rules (:186-194, :215-287), ``compile``
(:311-367), the sparse-table gate (:374-479), lane masks and lazy L2
(:650-722), the active-rows train step (:724-1277) and the train step
(:1331-1378), ``_assemble_x`` (:1413-1444), ``assemble_device_input``
(:1446-1451), ``fit`` on host arrays (:1846-1991) and on a device tensor
(``_fit_device``, :1509-1656) with ``profile`` (:1488-1507),
``evaluate`` (:1993-2018), ``predict`` (:2020-2053),
``get_weights``/``set_weights`` (:2125-2134) and the persistence methods
(:2150-2186, ``utils/serialization.py``).  The model is the ``nn.Module``
itself; its ``state_dict`` is its weights.

A train step, per batch, on the device alone (it uploads nothing and reads
nothing back, so that a CUDA graph can replay it: ``graphs.py``):

1. the touched rows of every sparse table: the distinct ids of the
   batch's id columns for that table plus a synthetic id 0, from one sort
   over all sparse tables (``_TouchedRows``), at a fixed capacity a table
   and padded past it;
2. the forward, whose gathers run without a graph back to the tables
   (``TableHolder._capture``): the gathered rows are leaves;
3. loss + the eager L1/L2 of the dense parameters + the model's auxiliary
   term (DIEN's, ``aux_loss``), ``backward``;
4. one ``scatter_add_rows`` launch a gather: each row's cotangent goes
   into its dense table's ``[V, W]`` gradient, or into the ``[n, W]``
   gradient of its sparse table's touched rows (a ``VarLenSparseFeat``
   is ``maxlen`` fields of its table);
5. the dense optimizer on the dense parameters, and one ``row_update``
   launch on the touched rows of every sparse table (lazy L2 and the
   optimizer's row step, in place; adam's bias corrections for the step
   read on the device from a table uploaded once for the steps ahead,
   ``_begin_steps``; under ``config.set_adam_t("rowwise")`` each sparse
   row's own step count, advanced by the kernel, picks its pair from a
   table of the pairs of every count).

``fit`` on host arrays runs these steps eagerly, uploading each batch and
reading its loss.  ``fit`` on a device tensor is the device-resident loop:
the padded data, the permutation and every step stay on the device, each
step a replay of one captured graph on the card (``graphs.StepGraph``),
and the host reads one loss vector an epoch.  ``predict`` replays a
captured forward a batch on the card (``graphs.ForwardGraph``).

On a mesh (``mesh=``, ``parallel/``; ``deepctr_tpu/models/basemodel.py:
1389-1408``) every rank runs these steps on its rows of the global batch:
the touched rows come from the global batch's ids (one all-reduce over
``data`` of a zero-filled id matrix), the row-sharded tables are looked up
through an exchange (``inputs.TableHolder``), the touched rows' and the
dense gradients are summed over ``data``, the penalty counts once, and the
row update runs on the rank's blocks.  No graph is captured there.

Unlike the JAX package, which stores tables of >= 131072 rows packed into
128-lane rows and updates them by packed row, the port updates logical
rows; see ``ROADMAP.md`` section 3.
"""

import contextlib
import functools
import os
import queue
import re
import threading
import time
import warnings
from itertools import accumulate

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None

from .. import config, native
from ..callbacks import CallbackList, History
from ..features import SparseFeat, VarLenSparseFeat
from ..inputs import EmbeddingDict, TableHolder, stored_rows
from ..layers.core import Dropout, dropout_generator
from ..layers.utils import slice_arrays
from ..losses import resolve_loss
from ..ops import row_update as _row_update
from ..ops._args import DeviceArgs, device_array
from ..ops.row_update import (adam_bias_corrections, bias_correction_table,
                              row_update)
from ..ops.scatter_add import scatter_add_rows
from ..parallel.context import data_shard
from ..parallel.sharding import (Axes, batch_sharding, gather_data,
                                 shard_variables)
from ..parallel.update import shard_local_rows
from ..tracing import span
from ..utils import serialization
from ..utils.jax_weights import jax_path
from ..utils.metrics import resolve_metrics
from .base_module import BaseModule, fused_wide_names
from .graphs import ForwardGraph, StepGraph

# torch-default learning rates, as deepctr_tpu/models/basemodel.py:52-53;
# one source for the dense parameters and the sparse tables
_OPT_DEFAULT_LR = {"sgd": 0.01, "adam": 0.001, "adagrad": 0.01,
                   "rmsprop": 0.01}
_SPARSE_OPTIMIZERS = ("sgd", "adagrad", "adam", "rmsprop")
# the "auto" gate (basemodel.py:392, :408-412)
_AUTO_MIN_MODEL_ROWS = 1_000_000
_AUTO_MIN_TABLE_ROWS = 16384


def resolve_device(device):
    """``None`` means ``"cuda"``; a CUDA device on a host without CUDA
    raises rather than falling back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to "
                           "run the model on the CPU")
    return device


class DenseOptimizer:
    """Torch-form optimizer step over the dense parameters, in the JAX
    package's arithmetic (``basemodel.py:59-136`` and ``optax.adam``):

    - sgd: ``p += -lr * g``;
    - adagrad: ``a += g^2; p += -lr * g / (sqrt(a) + 1e-10)``;
    - rmsprop: ``v = 0.99 v + 0.01 g^2; p += -lr * g / (sqrt(v) + 1e-8)``;
    - adam: ``m, v`` moments, bias corrections ``bias`` (a float32 [2]
      on the device, the step's ``(1 - b1^t, 1 - b2^t)``),
      ``p += -lr * m_hat / (sqrt(v_hat) + 1e-8)``.

    A parameter without a gradient steps with a zero one, as optax does.
    ``count`` is the steps taken, and those made ready on the device
    (``BaseModel._begin_steps``).  A CUDA graph captures its step.
    """

    capturable = True

    def __init__(self, name, lr, params):
        self.name = name
        self.lr = lr
        self.params = list(params)
        n_state = _row_update.MODES[name][1]
        self.state = [tuple(torch.zeros_like(p) for _ in range(n_state))
                      for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, bias=None):
        lr = self.lr
        if self.name == "adam" and self.params:
            # device tensors: CUDA divides by a host scalar as a multiply
            # by its reciprocal
            bc1, bc2 = bias[0], bias[1]
        for p, st in zip(self.params, self.state):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if self.name == "sgd":
                u = -lr * g
            elif self.name == "adagrad":
                st[0].add_(g * g)
                u = -lr * g / (torch.sqrt(st[0]) + _row_update.ADAGRAD_EPS)
            elif self.name == "rmsprop":
                v = st[0]
                v.copy_(_row_update.RMS_DECAY * v
                        + (1 - _row_update.RMS_DECAY) * (g * g))
                u = -lr * g / (torch.sqrt(v) + _row_update.RMS_EPS)
            else:
                m, v = st
                b1, b2 = _row_update.ADAM_B1, _row_update.ADAM_B2
                m.copy_((1 - b1) * g + b1 * m)
                v.copy_((1 - b2) * (g * g) + b2 * v)
                u = -lr * ((m / bc1) / (torch.sqrt(v / bc2)
                                        + _row_update.ADAM_EPS))
            p.add_(u)


class TorchOptimizer:
    """A caller's ``torch.optim.Optimizer`` as the train step's dense
    optimizer, the port's counterpart of an optax transform passed to the
    JAX package's ``compile`` (``basemodel.py:121-135``).

    ``params`` are the model's parameters it steps: before each step every
    one without a gradient gets a zero one, as optax steps every leaf.
    ``capturable`` is True where every parameter group has
    ``capturable=True``: then a CUDA graph holds ``step()``, else the
    device loop runs each step eagerly on the card.  ``Adam``, ``AdamW``
    and ``RMSprop`` take that option; ``SGD`` and ``Adagrad`` do not
    (``chip_smoke.py`` phase 30 holds ``Adam(capturable=True)`` and
    ``Adagrad`` on the card; ``PERF.md`` section 6).
    ``state`` is each parameter's state tensors, by key order;
    ``count`` the steps made ready, as :class:`DenseOptimizer`'s.

    The optimizer keeps its own state, as a ``torch.optim`` optimizer
    does: ``compile`` and ``set_weights`` leave it as it is, where the JAX
    package starts an optax state afresh (some classes, such as
    ``Adagrad``, build theirs when they are made and cannot start
    again); ``load_checkpoint`` restores it."""

    def __init__(self, optimizer, params):
        self.optimizer = optimizer
        self.params = list(params)
        self.count = 0

    @property
    def capturable(self):
        return all(g.get("capturable", False)
                   for g in self.optimizer.param_groups)

    @property
    def state(self):
        return [tuple(v for _, v in sorted(
                    self.optimizer.state.get(p, {}).items())
                    if isinstance(v, torch.Tensor))
                for p in self.params]

    def stale_params(self, model):
        """The optimizer's parameters that are not ``model``'s."""
        own = {id(p) for p in model.parameters()}
        return [p for g in self.optimizer.param_groups for p in g["params"]
                if id(p) not in own]

    def step(self, bias=None):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()


class _StepPlan:
    """What a train step at batch size ``B`` needs beside its batch, built
    once on the device and kept, so that a step uploads nothing and its
    buffers stay where a captured graph found them.

    For the sparse tables (``specs``): their id columns ``cols`` [C], each
    column's table ``tcol`` [C] and first key ``col_base`` [C] (the tables'
    rows laid end to end from ``bases`` [T + 1]), the table of each key of
    a step's sort ``key_table`` [T + C*B], each table's capacity
    ``cap_t = min(1 + B * C_t, V_t)`` (its synthetic row 0 and every id of
    its C_t columns, or all its rows) and first slot ``slot_base`` [T] in
    one flat row list, the padding of that list ``pad_rows``
    (``V_t, V_t + 1, ...`` for each table, and a last slot that takes the
    sort's repeats), and the touched rows' gradients ``grads`` [cap_t, W_t],
    views of one buffer.  For the dense tables, their gradients
    ``dense_grads``.  For each gather of the forward, the scatter's targets
    and rows (``groups``, filled by the first step)."""

    def __init__(self, model, B, device):
        tables = model._tables()
        specs = model._sparse_specs
        self.index = {p: t for t, (p, _, _) in enumerate(specs)}
        self.dense_grads = {
            p: torch.zeros_like(w) for p, w in tables.items()
            if p not in self.index}
        self.groups = {}
        self.caps = []
        if not specs:
            return
        cols, table_of_col = [], []
        for t, (_, spans, _) in enumerate(specs):
            for s, e in spans:
                cols.extend(range(s, e))
                table_of_col.extend([t] * (e - s))
        self.col_index = {c: i for i, c in enumerate(cols)}
        vocabs = [n for _, _, n in specs]
        starts = list(accumulate(vocabs, initial=0))
        self.caps = [min(1 + B * table_of_col.count(t), v)
                     for t, v in enumerate(vocabs)]
        offs = list(accumulate(self.caps, initial=0))
        self.offs = offs[:-1]
        widths = [tables[p].shape[1] for p, _, _ in specs]
        i64 = torch.int64
        self.cols = device_array(cols, i64, device)
        self.tcol = device_array(table_of_col, i64, device)
        self.bases = device_array(starts, i64, device)
        self.col_base = device_array([starts[t] for t in table_of_col], i64,
                                     device)
        self.key_table = device_array(
            list(range(len(specs))) + [t for t in table_of_col
                                       for _ in range(B)], i64, device)
        self.slot_base = device_array(self.offs, i64, device)
        self.pad_rows = device_array(
            [v + k for v, c in zip(vocabs, self.caps) for k in range(c)]
            + [0], i64, device)
        self.dump = offs[-1]
        self.grad_flat = torch.zeros(
            sum(c * w for c, w in zip(self.caps, widths)), device=device)
        self.grads, off = [], 0
        for c, w in zip(self.caps, widths):
            self.grads.append(self.grad_flat[off:off + c * w].view(c, w))
            off += c * w


class _TouchedRows:
    """The rows a batch touches in each sparse table, at the fixed sizes of
    its :class:`_StepPlan`, from one sort of the ``T + B*C`` keys (the
    JAX package sorts them with ``jax.lax.sort``, ``basemodel.py:812-901``):
    first-of-run flags, a ``cumsum`` for the runs, and a compaction of each
    run's row into its table's slot.  No count leaves the device.

    ``rows[t]`` [cap_t] are table t's touched row ids, ascending (row 0
    always among them), then padding past the table (``V_t + k``), which
    ``row_update`` drops; ``grads[t]`` the plan's zeroed [cap_t, W_t]
    gradient for them; ``slots[:, c]`` the position in its table's
    ``rows`` of the id in the c-th sparse id column of X.  Every id must lie
    in its table (``BaseModel._check_sparse_ids``).  ``ids`` [B, C] are X's
    values at the plan's columns where the caller has them (on a mesh,
    those of the global batch)."""

    def __init__(self, X, plan, ids=None):
        n_tables = len(plan.caps)
        if ids is None:
            ids = X.index_select(1, plan.cols)
        ids = ids.to(torch.int32).to(torch.int64)
        keys = ids + plan.col_base                                # [B, C]
        # the synthetic id 0 of every table first, then the id columns
        all_keys = torch.cat([plan.bases[:-1], keys.t().reshape(-1)])
        sorted_keys, order = torch.sort(all_keys)
        first = torch.ones_like(sorted_keys, dtype=torch.bool)
        first[1:] = sorted_keys[1:] != sorted_keys[:-1]
        run = torch.cumsum(first, 0) - 1
        inv = torch.empty_like(run).scatter_(0, order, run)
        lo = inv[:n_tables]               # the run of each table's row 0
        table = plan.key_table.index_select(0, order)
        slot = run - lo.index_select(0, table)
        # each run's first key writes its row into its table's slot; the
        # repeats write into the last slot, which no table owns
        dst = torch.where(first, plan.slot_base.index_select(0, table) + slot,
                          plan.dump)
        flat = plan.pad_rows.clone()
        flat.scatter_(0, dst, sorted_keys - plan.bases.index_select(0, table))
        self.rows = [flat[o:o + c] for o, c in zip(plan.offs, plan.caps)]
        self.slots = (inv[n_tables:].view(-1, ids.shape[0]).t()
                      - lo.index_select(0, plan.tcol))            # [B, C]
        plan.grad_flat.zero_()
        self.grads = plan.grads
        self.index = plan.index
        self.col_index = plan.col_index


class BaseModel(BaseModule):
    """Feature plumbing, seeded init, training and inference around a
    model's layers.

    Every parameter is drawn at construction from one ``torch.Generator``
    on the model's device, seeded with ``seed``; subclasses draw their own
    layers from ``self._init_generator`` after this ``__init__``, and
    record their constructor's arguments first (``_capture_init_args``).

    Dropout masks come from another generator on the model's device,
    reseeded at every epoch from ``(seed + 1, epoch)``
    (:meth:`_begin_steps`), the JAX loops' ``PRNGKey(seed + 1)`` with the
    epoch folded in; each step of the epoch draws after the one before.  So
    a step's masks are a function of (seed, epoch, step) in both loops: two
    fits from the same weights draw the same masks, and so does a
    ``fit(initial_epoch=e)`` after ``load_checkpoint``.  The JAX host loop
    folds in a step count that restarts at every ``fit``; here it is the
    epoch and the step within it.
    """

    def __init_subclass__(cls, **kwargs):
        """A model class's constructor, once it has built every layer,
        applies the mesh's sharding (:meth:`_apply_sharding`): the tables
        are drawn whole from the seed on every rank, then cut to the
        rank's block."""
        super().__init_subclass__(**kwargs)
        init = cls.__dict__.get("__init__")
        if init is None:
            return

        @functools.wraps(init)
        def __init__(self, *args, **kw):
            init(self, *args, **kw)
            # the outermost constructor: the instance's own class's, or
            # the one it inherits
            if type(self).__init__ is cls.__init__:
                self._apply_sharding()
        cls.__init__ = __init__

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 l2_reg_linear=1e-5, l2_reg_embedding=1e-5, init_std=1e-4,
                 seed=1024, task="binary", device=None, gpus=None,
                 mesh=None, shard_embeddings=False):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError("mesh must be a torch.distributed DeviceMesh "
                            "(parallel.make_mesh), got %r" % (mesh,))
        if shard_embeddings and mesh is None:
            raise ValueError("shard_embeddings=True row-shards the tables "
                             "over a mesh: pass mesh=")
        device = resolve_device(device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        super().__init__(linear_feature_columns, dnn_feature_columns, task,
                         init_std, device=device, generator=generator)
        self._init_generator = generator
        self.input_dim = (max(e for _, e in self.feature_index.values())
                          if self.feature_index else 0)
        self.seed = seed
        self.task = task
        self.gpus = gpus
        self.l2_reg_linear = l2_reg_linear
        self.l2_reg_embedding = l2_reg_embedding
        self.num_tasks = 1
        self.stop_training = False
        self.history = History()
        self.optim = None
        # a training forward's auxiliary loss term (DIEN's, scaled by its
        # alpha), which the train step adds to the total loss; else None
        self.aux_loss = None
        # per-group regularization rules (path_regex, l1, l2, part), with
        # paths the JAX package's; part: None = whole parameter,
        # "deep"/"wide" = the column split of a fused table
        self.regularization_rules = []
        self.add_regularization_rule(r"^embedding_dict/",
                                     l2=l2_reg_embedding, part="deep")
        self.add_regularization_rule(r"^embedding_dict/",
                                     l2=l2_reg_linear, part="wide")
        self.add_regularization_rule(r"^linear_model/", l2=l2_reg_linear)
        # what captured graphs and train steps hold the addresses of:
        # {key: StepGraph or ForwardGraph}, {batch size: _StepPlan}
        self._graphs = {}
        self._plans = {}
        self._dropout_gen = None
        # the mesh (parallel/): its axes, and {table path: (first row,
        # stop, vocab, rows a block)} of the row-sharded tables
        self.mesh = mesh
        self.shard_embeddings = bool(shard_embeddings)
        self._axes = None if mesh is None else Axes(mesh)
        self._shards = {}

    # ------------------------------------------------------------------
    # the mesh (deepctr_tpu/models/basemodel.py:1389-1408)
    # ------------------------------------------------------------------
    def _apply_sharding(self):
        """Cut every table that ``shard_embeddings`` row-shards to this
        rank's block (``parallel.shard_variables``) and tell its holder.
        Runs once, when the constructor is done."""
        if self.mesh is None or not self.shard_embeddings or self._shards:
            return
        self._shards = shard_variables(self.mesh, self._tables())
        for prefix, holder in self._table_holders():
            holder._axes = self._axes
            holder._shards = {p[len(prefix):]: b
                              for p, b in self._shards.items()
                              if p.startswith(prefix)
                              and p[len(prefix):] in holder.tables}
        self._invalidate_graphs()

    def _put_batch(self, *arrays):
        """This rank's rows of each global batch in ``arrays`` (all of
        them without a mesh): its contiguous share of the ``data`` axis
        (``parallel.batch_sharding``, which raises on a batch the axis
        does not divide)."""
        if self.mesh is not None:
            arrays = tuple(a[batch_sharding(self.mesh, a.shape[0])]
                           for a in arrays)
        return arrays if len(arrays) > 1 else arrays[0]

    def _block(self, path, full):
        """This rank's block of the full rows ``full`` of table ``path``,
        ``full`` itself for a table that is not row-sharded."""
        shard = self._shards.get(path)
        if shard is None or full.shape[0] != shard[2]:
            return full
        return full[shard[0]:shard[1]]

    def _gather_table(self, path, block):
        """The full rows of table ``path`` (or of its optimizer state)
        from every rank's ``block``: one all-reduce over the ``model`` axis
        of a zero-filled full buffer.  ``block`` itself for a table that is
        not row-sharded."""
        shard = self._shards.get(path)
        if shard is None:
            return block
        base, stop, vocab, per = shard
        ax = self._axes
        out = block.new_zeros((per * ax.n_model,) + tuple(block.shape[1:]))
        out[base:stop] = block
        if ax.n_model > 1:
            dist.all_reduce(out, group=ax.model_group)
        return out[:vocab]

    def _param_paths(self):
        """``{state_dict key: JAX path}``."""
        return {k: jax_path(k) for k, _ in self.named_parameters()}

    def full_state_dict(self):
        """The ``state_dict`` with every row-sharded table whole (gathered
        over the ``model`` axis: every rank of the mesh must call it)."""
        paths = self._param_paths()
        return {k: self._gather_table(paths.get(k), v.detach())
                for k, v in self.state_dict().items()}

    def full_shapes(self):
        """``{state_dict key: shape}`` with row-sharded tables at their full
        size, as the JAX package's tree and the files hold them."""
        paths = self._param_paths()
        out = {}
        for k, v in self.state_dict().items():
            shape = tuple(v.shape)
            shard = self._shards.get(paths.get(k))
            if shard is not None:
                shape = (shard[2],) + shape[1:]
            out[k] = shape
        return out

    @property
    def _hash_feats(self):
        """``{name: feature}`` of the columns declaring ``use_hash``, which
        ``_assemble_x`` hashes on the host (``deepctr_tpu/models/
        basemodel.py:152-157``)."""
        return {f.name: f
                for f in self.linear_feature_columns + self.dnn_feature_columns
                if isinstance(f, (SparseFeat, VarLenSparseFeat))
                and f.use_hash}

    def _capture_init_args(self, local_vars):
        """Record the constructor's arguments, so that ``load_model`` can
        rebuild the model (``deepctr_tpu/models/basemodel.py:2180-2186``).
        ``mesh`` is left out, as there, and so is ``shard_embeddings``,
        which needs a mesh here (the JAX package ignores it without one):
        a model rebuilt from them runs on one process.  ``device`` stays as
        the caller gave it."""
        drop = {"self", "__class__", "mesh", "shard_embeddings"}
        self._init_kwargs = {k: v for k, v in local_vars.items()
                             if k not in drop}

    def _dropout_generator(self):
        """The generator the train step draws its dropout masks from, on
        the model's device (made anew after a move)."""
        g = self._dropout_gen
        if g is None or g.device != self._device:
            g = self._dropout_gen = torch.Generator(device=self._device)
        return g

    def _has_dropout(self):
        return any(isinstance(m, Dropout) and m.rate > 0
                   for m in self.modules())

    # ------------------------------------------------------------------
    # regularization
    # ------------------------------------------------------------------
    def add_regularization_rule(self, pattern, l1=0.0, l2=0.0, part=None):
        """Register explicit L1/L2 on every parameter whose JAX path
        (``utils/jax_weights.jax_path``, e.g. ``dnn/dense_0/kernel``)
        matches ``pattern``."""
        if l1 > 0 or l2 > 0:
            self.regularization_rules.append(
                (pattern, float(l1), float(l2), part))

    add_regularization_weight = add_regularization_rule

    @property
    def _device(self):
        return next(self.parameters()).device

    @staticmethod
    def _graph_key(*parts):
        """A captured graph's cache key: ``parts``, and the global settings
        that a capture bakes in (the compute dtype, the CIN's mode, TF32
        matmuls)."""
        return parts + (config.compute_dtype(), config.cin_dtype(),
                        torch.backends.cuda.matmul.allow_tf32)

    def _drop_graphs(self):
        """Drop every captured graph: they hold the addresses of tensors
        that are being replaced."""
        for g in getattr(self, "_graphs", {}).values():
            g.release()
        self._graphs = {}

    def _invalidate_graphs(self):
        """Drop every captured graph and step plan."""
        self._drop_graphs()
        self._plans = {}
        self._holders = None

    def _apply(self, fn, *args, **kwargs):
        # .to(), .cuda(), .float(): new parameter tensors
        out = super()._apply(fn, *args, **kwargs)
        self._invalidate_graphs()
        return out

    def load_state_dict(self, *args, **kwargs):
        out = super().load_state_dict(*args, **kwargs)
        self._invalidate_graphs()
        return out

    def _named_params(self):
        """``[(JAX path, parameter)]`` sorted by path, as the JAX package
        flattens its tree."""
        return sorted(((jax_path(k), p) for k, p in self.named_parameters()),
                      key=lambda kv: kv[0])

    def _tables(self):
        """``{JAX path: table}`` of every table a gather reads: the
        embedding tables and any other (ONN's pair tables)."""
        return {prefix + n: t for prefix, holder in self._table_holders()
                for n, t in holder.tables.items()}

    def _table_layouts(self):
        """``{table path: (width, fused deep dim or None)}`` of every
        embedding table."""
        return {prefix + name: (t.shape[1], ed.table_dims[name]
                                if name in ed.wide_names else None)
                for prefix, ed in self._table_holders()
                if isinstance(ed, EmbeddingDict)
                for name, t in ed.tables.items()}

    @staticmethod
    def _lane_masks(layout):
        """(deep, wide) 0/1 column vectors of a table: the fused wide
        column carries the linear L2, the others the embedding L2."""
        width, fused_dim = layout
        deep = np.zeros((width,), np.float32)
        wide = np.zeros((width,), np.float32)
        if fused_dim is None:
            deep[:] = 1.0
        else:
            deep[:fused_dim] = 1.0
            wide[fused_dim:] = 1.0
        return deep, wide

    def _reg_entries(self):
        """``[(parameter, l1, l2, column mask or None)]`` of the eager
        term; tables on the sparse path are left out, their L2 is lazy."""
        layouts = self._table_layouts()
        sparse = {s[0] for s in getattr(self, "_sparse_specs", [])}
        entries = []
        for pattern, l1, l2, part in self.regularization_rules:
            rx = re.compile(pattern)
            for path, w in self._named_params():
                if not rx.search(path) or path in sparse:
                    continue
                if path in layouts:
                    deep, wide = self._lane_masks(layouts[path])
                    mask = (wide if part == "wide" else
                            deep if part == "deep" else deep + wide)
                    if not mask.any():
                        continue
                    mask = (None if mask.all() else
                            device_array(mask, torch.float32, w.device))
                elif part == "wide":
                    continue
                else:
                    mask = None
                entries.append((w, l1, l2, mask))
        return entries

    def _reg_loss(self, entries):
        total = torch.zeros((), dtype=torch.float32, device=self._device)
        for w, l1, l2, mask in entries:
            if l1 > 0:
                aw = torch.abs(w)
                total = total + torch.sum(
                    l1 * (aw if mask is None else aw * mask))
            if l2 > 0:
                sq = w * w
                total = total + torch.sum(
                    l2 * (sq if mask is None else sq * mask))
        return total

    def get_regularization_loss(self):
        """The current eager L1/L2 penalty, as a python float.  Tables on
        the sparse path apply their L2 lazily in the row update and are
        not part of it."""
        with torch.no_grad():
            return float(self._reg_loss(self._reg_entries()))

    def _table_l2_vec(self, path):
        """Per-column lazy L2 of a sparse table: the fused wide column
        carries l2_reg_linear, the deep columns l2_reg_embedding."""
        deep, wide = self._lane_masks(self._table_layouts()[path])
        vec = np.zeros_like(deep)
        for pattern, _, l2, part in self.regularization_rules:
            if not re.compile(pattern).search(path):
                continue
            if part == "wide":
                vec += l2 * wide
            elif part == "deep":
                vec += l2 * deep
            else:
                vec += l2 * (deep + wide)
        return device_array(vec, torch.float32, self._tables()[path].device)

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------
    def compile(self, optimizer, loss=None, metrics=None,
                learning_rate=None, sparse_table_updates="auto"):
        """Configure the optimizer, the loss (name, callable, or per-task
        list) and the metrics (names).

        ``optimizer``: a name (``sgd``, ``adagrad``, ``rmsprop``, ``adam``,
        with torch-default learning rates that ``learning_rate`` overrides
        for both the dense parameters and the sparse tables), or a
        ``torch.optim.Optimizer`` the caller built over
        ``model.parameters()`` (:class:`TorchOptimizer`), the counterpart
        of the JAX package's optax transform: its tables stay dense, and a
        ``learning_rate`` beside it raises ``ValueError``.

        ``sparse_table_updates``: True / False / "auto".  Tables on the
        sparse path never get a dense gradient: each step updates only the
        rows its batch touched, with their L2 applied lazily.  "auto"
        turns it on when the model holds >= 1M table rows, and then only
        for tables of >= 16384 rows.  It needs a named optimizer: with an
        optimizer object, True warns and falls back to dense updates."""
        if isinstance(optimizer, str):
            if optimizer not in _OPT_DEFAULT_LR:
                raise NotImplementedError("unknown optimizer %r" % optimizer)
            self._optimizer_name = optimizer
            self._learning_rate = (float(learning_rate)
                                   if learning_rate is not None
                                   else _OPT_DEFAULT_LR[optimizer])
        elif isinstance(optimizer, torch.optim.Optimizer):
            if learning_rate is not None:
                raise ValueError("learning_rate is only meaningful with a "
                                 "named optimizer; configure the "
                                 "torch.optim optimizer directly")
            self._optimizer_name = None
            self._learning_rate = None
        else:
            raise TypeError("optimizer must be a name (%s) or a "
                            "torch.optim.Optimizer built over "
                            "model.parameters(), got %r"
                            % (", ".join(sorted(_OPT_DEFAULT_LR)), optimizer))
        self.optim = optimizer
        self.loss_func = resolve_loss(loss)
        self.metrics = resolve_metrics(metrics)
        self.metrics_names = ["loss"] + list(self.metrics)
        self._sparse_specs = self._resolve_sparse_specs(sparse_table_updates)
        # adam's step count on the sparse tables (config.set_adam_t), read
        # here as the JAX package reads DEEPCTR_ADAM_T for its table state
        self._adam_t = config.adam_t() if optimizer == "adam" else None
        self._eager_step_warned = False
        self._init_optimizer_state()
        return self

    def _init_optimizer_state(self):
        """Fresh optimizer state for the dense parameters and the sparse
        tables (at compile, and when ``set_weights`` loads new weights)."""
        tables = self._tables()
        sparse = {p for p, _, _ in self._sparse_specs}
        dense = [p for path, p in self._named_params() if path not in sparse]
        if self._optimizer_name is None:
            self._dense_opt = TorchOptimizer(self.optim, dense)
            n_state = 0
        else:
            self._dense_opt = DenseOptimizer(self._optimizer_name,
                                             self._learning_rate, dense)
            n_state = _row_update.MODES[self._optimizer_name][1]
        self._dense_paths = [path for path, _ in self._named_params()
                             if path not in sparse]
        # rowwise adam: each table's state gains t, int32 [rows], the
        # rows of this rank's block on a mesh
        rowwise = self._adam_t == "rowwise"
        self._table_state = {
            p: tuple(torch.zeros_like(tables[p]) for _ in range(n_state))
            + ((torch.zeros(tables[p].shape[0], dtype=torch.int32,
                            device=tables[p].device),) if rowwise else ())
            for p, _, _ in self._sparse_specs}
        # a row-sharded table on the sparse path takes the exact (psum)
        # exchange in a train step (inputs.TableHolder)
        for prefix, holder in self._table_holders():
            holder._exact = frozenset(p[len(prefix):] for p in sparse
                                      if p.startswith(prefix))
        self._table_t = {p: 0 for p, _, _ in self._sparse_specs}
        # the step within the steps made ready by _begin_steps, on the
        # device, and adam's bias corrections for those steps
        self._step_i = torch.zeros(1, dtype=torch.int64, device=self._device)
        self._bias_table = None
        # rowwise adam: the pairs of every count (bias_correction_table)
        self._row_bias = None
        self._step_rules = None
        self._invalidate_graphs()

    def _begin_steps(self, n, epoch=0):
        """Ready the device for the next ``n`` train steps, those of epoch
        ``epoch``: :meth:`_begin_epoch` and :meth:`_ready_steps`.  Each
        ``fit`` epoch calls it; so must a caller of ``_train_step``."""
        self._begin_epoch(epoch)
        self._ready_steps(n)

    def _begin_epoch(self, epoch):
        """The dropout generator reseeded from ``(seed + 1, epoch)``: the
        epoch's steps then draw their masks one after the other."""
        state = np.random.SeedSequence([self.seed + 1, epoch])
        self._dropout_generator().manual_seed(
            int(state.generate_state(1, np.uint64)[0]))

    def _ready_steps(self, n):
        """The next ``n`` steps made ready, after those taken: the step
        counter at 0 and, for adam, the ``(1 - b1^t, 1 - b2^t)`` of those
        steps (``adam_bias_corrections``, the JAX package's float32
        formula) uploaded at once, which the steps read on the device.  A
        streamed epoch calls it for each chunk, without reseeding the
        dropout generator, so that the chunks carry on the epoch's masks
        and adam's step count."""
        self._reserve_steps(n)
        t0 = self._dense_opt.count
        self._dense_opt.count += n
        for p in self._table_t:
            self._table_t[p] += n
        self._step_i.zero_()
        if self._optimizer_name != "adam":
            return
        values = [c for t in range(t0 + 1, t0 + n + 1)
                  for c in adam_bias_corrections(t)]
        self._bias_table[:n].copy_(
            device_array(values, torch.float32, self._device).view(n, 2))

    def _reserve_steps(self, n):
        """adam's table of bias corrections, made (or made larger) for
        the next ``n`` steps; under rowwise adam also the table of the
        pairs of every count up to the steps taken and ``n`` more (no
        row's count exceeds the steps taken), at least doubled when it
        grows.  A new table drops the captured graphs, which read the old
        one: the device loop reserves it before it looks up its graph."""
        if self._optimizer_name != "adam":
            return
        if self._bias_table is None or self._bias_table.shape[0] < n:
            self._drop_graphs()
            self._bias_table = torch.empty(n, 2, device=self._device)
        if self._adam_t != "rowwise" or not self._sparse_specs:
            return
        need = self._dense_opt.count + n + 1
        have = 0 if self._row_bias is None else self._row_bias.shape[0]
        if have < need:
            self._drop_graphs()
            self._row_bias = device_array(
                bias_correction_table(max(need, 2 * have, 1024)),
                torch.float32, self._device)

    def _step_plan(self, B):
        plan = self._plans.get(B)
        if plan is None:
            plan = self._plans[B] = _StepPlan(self, B, self._device)
        return plan

    def _ensure_compiled(self):
        """The eager regularization term and the sparse tables' lazy L2,
        fixed at the first fit after ``compile`` (as the JAX package builds
        its train step), so that rules added in between apply.  Raises if
        an optimizer object holds tensors that are not the model's
        parameters (built over another model, or before a conversion that
        made new parameters)."""
        if self.optim is None:
            raise RuntimeError("call model.compile(...) before fit()")
        if self._optimizer_name is None:
            stale = self._dense_opt.stale_params(self)
            if stale:
                raise ValueError(
                    "the optimizer holds %d tensor(s) that are not this "
                    "model's parameters (it was built over another model, "
                    "or before .to() made new ones): build it over "
                    "model.parameters() and compile again" % len(stale))
        if self._step_rules is None:
            self._step_rules = (
                self._reg_entries(),
                {p: self._table_l2_vec(p) for p, _, _ in self._sparse_specs})
        return self._step_rules

    def _table_vocabs(self):
        """{table path: vocabulary_size} over both column lists."""
        fused = set(fused_wide_names(self.linear_feature_columns,
                                     self.dnn_feature_columns))
        out = {}
        for f in self.dnn_feature_columns:
            if isinstance(f, (SparseFeat, VarLenSparseFeat)):
                out["embedding_dict/%s" % f.embedding_name] = \
                    f.vocabulary_size
        for f in self.linear_feature_columns:
            if isinstance(f, (SparseFeat, VarLenSparseFeat)):
                if f.embedding_name not in fused:
                    out["linear_model/embedding_dict/%s"
                        % f.embedding_name] = f.vocabulary_size
        return out

    def _table_id_spans(self):
        """{table path: [column spans]}: the flat-matrix columns that hold
        ids for each table (a fused table collects the deep and the linear
        features' spans)."""
        fused = set(fused_wide_names(self.linear_feature_columns,
                                     self.dnn_feature_columns))
        spans = {}

        def add(f, path):
            spans.setdefault(path, []).append(self.feature_index[f.name])

        for f in self.dnn_feature_columns:
            if isinstance(f, (SparseFeat, VarLenSparseFeat)):
                add(f, "embedding_dict/%s" % f.embedding_name)
        for f in self.linear_feature_columns:
            if isinstance(f, (SparseFeat, VarLenSparseFeat)):
                if f.embedding_name in fused:
                    add(f, "embedding_dict/%s" % f.embedding_name)
                else:
                    add(f, "linear_model/embedding_dict/%s"
                        % f.embedding_name)
        return {p: sorted(set(map(tuple, s))) for p, s in spans.items()}

    def _resolve_sparse_specs(self, mode):
        """``[(table path, id column spans, rows)]`` of the tables on the
        sparse path (``basemodel.py:374-437``)."""
        if mode is False:
            return []
        if self._optimizer_name not in _SPARSE_OPTIMIZERS:
            if mode is True:
                warnings.warn(
                    "sparse_table_updates=True requires a named optimizer "
                    "in %r (got %r) — falling back to DENSE table updates"
                    % (_SPARSE_OPTIMIZERS, self._optimizer_name
                       or type(self.optim).__name__))
            return []
        tables = self._tables()
        vocabs = self._table_vocabs()
        spans_map = {p: s for p, s in self._table_id_spans().items()
                     if p in tables and p in vocabs}
        if mode == "auto":
            # rows as the JAX package stores them (inputs.stored_rows)
            def stored(p):
                return stored_rows(vocabs[p], tables[p].shape[1])[0]
            if sum(stored(p) for p in spans_map) < _AUTO_MIN_MODEL_ROWS:
                return []
            spans_map = {p: s for p, s in spans_map.items()
                         if vocabs[p] >= _AUTO_MIN_TABLE_ROWS}
        specs = [(p, tuple(map(tuple, spans)), vocabs[p])
                 for p, spans in sorted(spans_map.items())]
        # a span read by two sparse tables stays dense (the JAX package
        # rewrites each sparse table's id columns in X)
        span_owners = {}
        for spec in specs:
            for sp in spec[1]:
                span_owners.setdefault(sp, []).append(spec[0])
        contested = {p for owners in span_owners.values()
                     if len(owners) > 1 for p in owners}
        if contested and mode is True:
            warnings.warn(
                "sparse_table_updates: tables %s share id columns and "
                "fall back to dense updates" % sorted(contested))
        return [s for s in specs if s[0] not in contested]

    # ------------------------------------------------------------------
    # the train step
    # ------------------------------------------------------------------
    def _table_holders(self):
        """``(JAX path prefix, TableHolder)`` of every holder of tables:
        the shared tables, the linear part's own, those of any other
        linear model (MLR's ``region_linear_<i>``, ...) and ONN's pair
        tables; found once after a compile or a move, as the model's
        modules stay."""
        if getattr(self, "_holders", None) is None:
            self._holders = tuple((jax_path(name) + "/", m)
                                  for name, m in self.named_modules()
                                  if isinstance(m, TableHolder))
        return self._holders

    def _compute_loss(self, y_pred, y, sw):
        loss_func = self.loss_func
        if isinstance(loss_func, list):
            if len(loss_func) != self.num_tasks:
                raise ValueError("the length of `loss_func` should be equal "
                                 "with `self.num_tasks`")
            return sum(loss_func[i](y_pred[:, i], y[:, i], sw)
                       for i in range(self.num_tasks))
        if self.num_tasks > 1:
            return loss_func(y_pred, y, sw[:, None])
        return loss_func(y_pred.reshape(-1), y.reshape(-1), sw)

    def _train_step(self, X, y, sw):
        """One step on a device batch: X [B, input_dim] float32, y [B, 1],
        sw [B].  Returns (data loss, total loss, predictions), detached.

        It uploads nothing and reads nothing back (a CUDA graph replays
        it): its index arrays and gradient buffers come from the batch
        size's :class:`_StepPlan`, adam's bias corrections from the table
        ``_begin_steps`` uploaded, at the device step counter, which the
        step advances.

        On a mesh the batch is this rank's rows of a global batch, and
        the step is the global batch's (:meth:`_mesh_step`).

        Its spans (``tracing.span``) are ``train_step`` and, inside it in
        this order, ``train_step.forward`` (the touched rows and the
        forward), ``.loss``, ``.backward``, ``.scatter_grads``,
        ``.all_reduce`` (on a mesh), ``.dense_update`` and
        ``.row_update``."""
        with span("train_step"):
            reg, l2_vecs = self._ensure_compiled()
            ax = self._axes
            B = X.shape[0] * (1 if ax is None else ax.n_data)
            plan = self._step_plan(B)
            tables = self._tables()
            touched = None
            captures = {}
            holders = self._table_holders()
            with span("train_step.forward"):
                if self._sparse_specs:
                    ids = None
                    if ax is not None and ax.n_data > 1:
                        # the global batch's ids: every rank touches its
                        # rows
                        ids = gather_data(X.index_select(1, plan.cols), ax)
                    touched = _TouchedRows(X, plan, ids)
                    if ids is not None:
                        n = X.shape[0]
                        touched.slots = touched.slots[ax.data * n:
                                                      (ax.data + 1) * n]
                for prefix, holder in holders:
                    holder._capture = captures.setdefault(prefix, [])
                self.aux_loss = None
                shard = (contextlib.nullcontext() if ax is None else
                         data_shard(ax.data_group, ax.n_data, ax.data))
                try:
                    with dropout_generator(self._dropout_generator()), shard:
                        y_pred = self(X, training=True)
                finally:
                    for _, holder in holders:
                        holder._capture = None
                    aux, self.aux_loss = self.aux_loss, None
            with span("train_step.loss"):
                data_loss = self._compute_loss(y_pred.float(), y, sw)
                reg_loss = self._reg_loss(reg)
                # on a mesh the penalty counts once: on the data axis's
                # first rank (the gradients are summed over the data axis)
                total = data_loss
                if ax is None or ax.data == 0:
                    total = total + reg_loss
                if aux is not None:
                    total = total + aux
            with span("train_step.backward"):
                for p in self._dense_opt.params:
                    p.grad = None
                # a dense table's gradient is the plan's buffer: the L2
                # term's gradient adds into it in place, then the rows'
                # cotangents
                for path, g in plan.dense_grads.items():
                    tables[path].grad = g.zero_()
                total.backward()
            with torch.no_grad():
                mesh_report = (ax is not None and ax.n_data * ax.n_model > 1)
                if mesh_report:   # the penalty's parts, before the update
                    reg_parts = self._reg_parts(reg)
                with span("train_step.scatter_grads"):
                    self._scatter_row_grads(X, captures, touched, plan)
                if ax is not None and ax.n_data > 1:
                    with span("train_step.all_reduce"):
                        self._sum_gradients(plan)
                bias = None
                with span("train_step.dense_update"):
                    if self._optimizer_name == "adam":
                        if self._bias_table is None:
                            raise RuntimeError("adam's train step reads its "
                                               "bias corrections from "
                                               "_begin_steps")
                        bias = self._bias_table.index_select(
                            0, self._step_i).view(2)
                    self._dense_opt.step(bias)
                if touched is not None:
                    with span("train_step.row_update"):
                        self._update_touched_rows(tables, touched, l2_vecs,
                                                  bias)
                self._step_i.add_(1)
                if mesh_report:
                    return self._mesh_results(data_loss, reg_parts, aux,
                                              y_pred, B)
            return data_loss.detach(), total.detach(), y_pred.detach()

    def _sum_gradients(self, plan):
        """Sum the gradients over the mesh's ``data`` axis: the touched
        rows' buffer, then every dense parameter's (a parameter the step
        left without one gets zeros) as one flat buffer."""
        ax = self._axes
        if self._sparse_specs:
            dist.all_reduce(plan.grad_flat, group=ax.data_group)
        params = self._dense_opt.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if params:
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            dist.all_reduce(flat, group=ax.data_group)
            off = 0
            for p in params:
                n = p.grad.numel()
                p.grad.copy_(flat[off:off + n].view_as(p.grad))
                off += n

    def _reg_parts(self, reg):
        """The eager penalty of the row-sharded tables' blocks and of the
        other (replicated) parameters."""
        sharded = {id(self._tables()[p]) for p in self._shards}
        return (self._reg_loss([e for e in reg if id(e[0]) in sharded]),
                self._reg_loss([e for e in reg if id(e[0]) not in sharded]))

    def _mesh_results(self, data_loss, reg_parts, aux, y_pred, B):
        """The global batch's data loss, total loss and predictions on
        every rank, from one all-reduce over the mesh of a zero-filled
        buffer: the predictions of the ``model`` axis's first ranks at
        their rows, each data loss once, the penalty of the replicated
        parameters once and each rank's block of the row-sharded tables'
        once (and DIEN's auxiliary term once a data rank)."""
        ax = self._axes
        pred = y_pred.detach().float().reshape(y_pred.shape[0], -1)
        n, n_out = pred.shape
        reg_shard, reg_rep = reg_parts
        buf = pred.new_zeros(B * n_out + 3)
        if ax.model == 0:
            buf[ax.data * n * n_out:(ax.data + 1) * n * n_out] = \
                pred.reshape(-1)
            buf[-3] = data_loss.detach()
            if aux is not None:
                buf[-1] = aux.detach()
        if ax.data == 0:
            buf[-2] = reg_shard + (reg_rep if ax.model == 0 else 0.0)
        dist.all_reduce(buf)
        preds = buf[:-3].view((B,) + tuple(y_pred.shape[1:]))
        return buf[-3], buf[-3] + buf[-2] + buf[-1], preds

    def _touched_rows(self, X):
        """The touched rows of the batch ``X``, as a train step builds
        them."""
        return _TouchedRows(X, self._step_plan(X.shape[0]))

    def _scatter_row_grads(self, X, captures, touched, plan):
        """One ``scatter_add_rows`` launch for each gather of the forward:
        a dense table's rows into its gradient, a sparse table's into the
        gradient of its touched rows, at their slots."""
        for prefix, groups in captures.items():
            for names, cols, rows, kept in groups:
                if rows.grad is None:
                    continue
                grad = rows.grad
                if kept is not None:   # an a2a exchange's dropped ids
                    grad = grad * kept[..., None].to(grad.dtype)
                targets, idx, args = self._scatter_targets(
                    X, prefix, names, cols, touched, plan)
                scatter_add_rows(grad, targets, idx, args)

    def _scatter_targets(self, X, prefix, names, cols, touched, plan):
        """``scatter_add_rows``' targets, ``[B, F]`` rows and cached
        argument array for the fields of one gather, field i reading table
        ``prefix + names[i]`` at id column ``cols[i]`` (a
        ``VarLenSparseFeat`` is ``maxlen`` fields): the plan's gradient of
        a dense table, viewed as ``[V, W]`` and indexed by id, the touched
        rows' gradient of a sparse one indexed by slot.  A dense row-sharded
        table's gradient is its block's, indexed by id less the block's
        first row, and -1 (nothing added) for ids of other blocks."""
        key = (prefix, tuple(names), tuple(cols))
        group = plan.groups.get(key)
        if group is None:
            targets, slot_cols, sparse_fields = [], [], []
            bases, sizes, blocked = [], [], []
            for name, col in zip(names, cols):
                path = prefix + name
                sparse = touched is not None and path in touched.index
                target = (touched.grads[touched.index[path]] if sparse
                          else plan.dense_grads[path].flatten(1))
                targets.append(target)
                slot_cols.append(touched.col_index[col] if sparse else 0)
                sparse_fields.append(sparse)
                shard = None if sparse else self._shards.get(path)
                bases.append(0 if shard is None else shard[0])
                sizes.append(0 if shard is None else shard[1] - shard[0])
                blocked.append(shard is not None)
            device = X.device
            slots = blocks = None
            if any(sparse_fields):
                slots = (device_array(slot_cols, torch.int64, device),
                         device_array(sparse_fields, torch.bool, device))
            if any(blocked):
                blocks = (device_array(bases, torch.int64, device),
                          device_array(sizes, torch.int64, device),
                          device_array(blocked, torch.bool, device))
            group = (targets, device_array(cols, torch.int64, device), slots,
                     blocks, DeviceArgs())
            plan.groups[key] = group
        targets, cols, slots, blocks, args = group
        idx = X.index_select(1, cols).to(torch.int32).to(torch.int64)
        if blocks is not None:
            local = idx - blocks[0]
            inside = (local >= 0) & (local < blocks[1])
            idx = torch.where(blocks[2], torch.where(inside, local, -1), idx)
        if slots is not None:
            idx = torch.where(slots[1], touched.slots.index_select(1, slots[0]),
                              idx)
        return targets, idx, args

    def _update_touched_rows(self, tables, touched, l2_vecs, bias):
        """One ``row_update`` launch over every sparse table (on a mesh,
        over this rank's blocks, at the rows ``parallel.update.
        shard_local_rows`` gives)."""
        paths = [p for p, _, _ in self._sparse_specs]
        rows = [shard_local_rows(r, self._shards.get(p))
                for r, p in zip(touched.rows, paths)]
        if bias is not None and self._adam_t == "rowwise":
            bias = self._row_bias     # each row's pair by its own count
        row_update(self._optimizer_name, [tables[p] for p in paths],
                   [self._table_state[p] for p in paths], touched.grads,
                   rows, [l2_vecs[p] for p in paths], self._learning_rate,
                   None if bias is None else [bias] * len(paths))

    def _check_sparse_ids(self, X):
        """Raise ValueError if an id in a sparse table's columns of ``X``
        (a numpy matrix, or a tensor: one reduction on its device and one
        read) lies outside the table, truncated as a step reads it."""
        cols, vocabs = [], []
        for _, spans, n in self._sparse_specs:
            for s, e in spans:
                cols.extend(range(s, e))
                vocabs.extend([n] * (e - s))
        if not cols:
            return
        if isinstance(X, torch.Tensor):
            ids = X.index_select(1, torch.tensor(cols, device=X.device))
            ids = ids.to(torch.int32).to(torch.int64)
            bad = bool(((ids < 0) | (ids >= torch.tensor(
                vocabs, device=X.device))).any())
        else:
            with np.errstate(invalid="ignore"):
                ids = X[:, cols].astype(np.int32).astype(np.int64)
            bad = bool(((ids < 0) | (ids >= np.asarray(vocabs))).any())
        if bad:
            raise ValueError("a sparse id lies outside its table's "
                             "vocabulary")

    # ------------------------------------------------------------------
    # data plumbing
    # ------------------------------------------------------------------
    def _assemble_x(self, x):
        """dict/list of arrays -> one [N, input_dim] float32 matrix
        (``deepctr_tpu/models/basemodel.py:1413-1444``).

        The columns are concatenated by the native batcher
        (``native.assemble``); features with ``use_hash`` are hashed onto
        ``[0, vocabulary_size)`` here on the host, strings or ints
        (:meth:`_hash_feature`).  Spans: ``assemble`` over the whole,
        ``assemble.batcher`` over the batcher."""
        with span("assemble"):
            if isinstance(x, dict):
                x = [x[feature] for feature in self.feature_index]
            if isinstance(x, np.ndarray):
                x = [x]
            hashed = self._hash_feats
            arrays = []
            for name, a in zip(self.feature_index, x):
                a = np.asarray(a)
                if a.ndim == 1:
                    a = a[:, None]
                feat = hashed.get(name)
                if feat is not None:
                    a = self._hash_feature(feat, a)
                arrays.append(np.asarray(a, dtype=np.float32))
            if not arrays:
                raise ValueError("the model has no input features")
            lens = {a.shape[0] for a in arrays}
            if len(lens) > 1:
                detail = ", ".join(
                    "%s: %d" % (n, a.shape[0])
                    for n, a in zip(self.feature_index, arrays))
                raise ValueError(
                    "input features have inconsistent sample counts (%s)"
                    % detail)
            with span("assemble.batcher"):
                X = native.assemble(arrays)
            if X.shape[1] != self.input_dim:
                raise ValueError("input width %d != expected %d"
                                 % (X.shape[1], self.input_dim))
            return X

    @staticmethod
    def _hash_feature(feat, a):
        """The ids of a ``use_hash`` column ``a`` (``deepctr_tpu/models/
        basemodel.py:1453-1467``): floats cast to int64, then FNV-1a onto
        ``[0, vocabulary_size)``; for a ``VarLenSparseFeat`` the padding id
        0 and empty strings stay 0."""
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.int64)
        ids = native.hash_to_bucket(a, feat.vocabulary_size)
        if isinstance(feat, VarLenSparseFeat):
            if np.issubdtype(a.dtype, np.integer):
                empty = a == 0
            else:
                empty = np.vectorize(lambda v: len(str(v)) == 0,
                                     otypes=[bool])(a)
            ids = np.where(empty, 0, ids)
        return ids

    def input_from_feature_columns(self, x, feature_columns=None):
        """Embed a raw input dict/list/matrix: returns
        ``(sparse_embedding_list, dense_value_list)`` as numpy arrays, each
        embedding ``[N, 1, E]`` (the sparse columns, then the pooled varlen
        ones), each dense value ``[N, d]``.  ``feature_columns`` defaults to
        ``dnn_feature_columns``.  The JAX wrapper's hook
        (``deepctr_tpu/models/basemodel.py:289-306``); the forward's own
        step on a device batch is :meth:`embed_columns`."""
        if feature_columns is None:
            feature_columns = self.dnn_feature_columns
        X = torch.from_numpy(self._assemble_x(x)).to(self._device)
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                se, dv = self.embed_columns(X, list(feature_columns))
        finally:
            self.train(was_training)
        return ([e.float().cpu().numpy() for e in se],
                [d.float().cpu().numpy() for d in dv])

    # ------------------------------------------------------------------
    # fit / evaluate / predict
    # ------------------------------------------------------------------
    def fit(self, x=None, y=None, batch_size=None, epochs=1, verbose=1,
            initial_epoch=0, validation_split=0., validation_data=None,
            shuffle=True, callbacks=None, profile=None,
            steps_per_epoch=None):
        """Keras-style training loop; returns the ``History``.

        ``x`` a dict/list of host arrays: an eager loop that uploads each
        batch and reads its loss.  Batches have a fixed size; the last is
        padded with sample 0 at sample weight 0.  The shuffle is
        ``np.random.default_rng(seed).permutation``, as the JAX package's,
        one permutation an epoch from epoch 0, so that a fit from
        ``initial_epoch`` shuffles its epochs as a fit from 0 did.

        ``x`` a flat [N, input_dim] tensor (``assemble_device_input``):
        the device-resident loop, :meth:`_fit_device`.

        ``x`` a zero-argument callable that returns an iterator of
        ``(x_chunk, y_chunk)`` pairs (``data.criteo_stream``): the streamed
        fit, :meth:`_fit_stream`, for data larger than host memory; it is
        called once an epoch, and ``steps_per_epoch`` caps the steps an
        epoch takes from it (read only with a callable ``x``, as in the JAX
        package).

        ``profile``: a directory; ``torch.profiler`` traces the whole call
        (host, and the card where the model is on one) and writes its
        trace there as TensorBoard reads it, stopping in a ``finally``.

        On a mesh every rank calls ``fit`` with the same arguments and
        trains on its rows of each global batch of ``batch_size`` (which
        the ``data`` axis must divide); the losses, metrics and history are
        the global batch's, the same on every rank.  Its steps run eagerly:
        no CUDA graph is captured under a mesh.  So it is with a callable
        ``x``: every rank reads the whole stream, shuffles each chunk
        alike and stops at the same ``steps_per_epoch``, and each step
        takes the rank's rows of its global batch, as the JAX package's
        streamed fit puts each chunk on the mesh (``deepctr_tpu/models/
        basemodel.py:1793``)."""
        if callable(x):
            def run():
                return self._fit_stream(x, batch_size, epochs, verbose,
                                        initial_epoch, validation_data,
                                        callbacks, steps_per_epoch, shuffle)
        else:
            def run():
                return self._fit(x, y, batch_size, epochs, verbose,
                                 initial_epoch, validation_split,
                                 validation_data, shuffle, callbacks)
        if not profile:
            return run()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self._device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                os.fspath(profile)))
        prof.start()
        try:
            return run()
        finally:
            prof.stop()

    def _fit(self, x, y, batch_size, epochs, verbose, initial_epoch,
             validation_split, validation_data, shuffle, callbacks):
        self._ensure_compiled()
        if isinstance(x, torch.Tensor):
            return self._fit_device(x, y, batch_size, epochs, verbose,
                                    initial_epoch, validation_split,
                                    validation_data, shuffle, callbacks)
        if isinstance(x, dict):
            x = [x[feature] for feature in self.feature_index]
        if isinstance(x, np.ndarray):
            x = [x]
        x = [np.asarray(a) for a in x]
        y = np.asarray(y)

        do_validation = False
        if validation_data:
            do_validation = True
            if len(validation_data) == 2:
                val_x, val_y = validation_data
            elif len(validation_data) == 3:
                val_x, val_y, _ = validation_data
            else:
                raise ValueError(
                    "When passing a `validation_data` argument, it must "
                    "contain either 2 items (x_val, y_val), or 3 items "
                    "(x_val, y_val, val_sample_weights)")
            if isinstance(val_x, dict):
                val_x = [val_x[feature] for feature in self.feature_index]
        elif validation_split and 0. < validation_split < 1.:
            do_validation = True
            split_at = int(x[0].shape[0] * (1. - validation_split))
            x, val_x = (slice_arrays(x, 0, split_at),
                        slice_arrays(x, split_at))
            y, val_y = (slice_arrays(y, 0, split_at),
                        slice_arrays(y, split_at))
        else:
            val_x, val_y = [], []

        X = self._assemble_x(x)
        y = np.asarray(y, dtype=np.float32)
        if y.ndim == 1:
            y = y[:, None]
        if y.shape[0] != X.shape[0]:
            raise ValueError(
                "x and y have different sample counts: %d vs %d"
                % (X.shape[0], y.shape[0]))
        if batch_size is None:
            batch_size = 256
        self._check_sparse_ids(X)

        device = self._device
        rng_shuffle = np.random.default_rng(self.seed)
        sample_num = len(X)
        steps_per_epoch = (sample_num - 1) // batch_size + 1
        if shuffle:
            for _ in range(initial_epoch):
                rng_shuffle.permutation(sample_num)

        callbacks = CallbackList((callbacks or []) + [self.history])
        callbacks.set_model(self)
        callbacks.on_train_begin()
        self.stop_training = False

        if verbose > 0:
            print("Train on {0} samples, validate on {1} samples, {2} steps "
                  "per epoch".format(sample_num, len(val_y),
                                     steps_per_epoch))

        for epoch in range(initial_epoch, epochs):
            callbacks.on_epoch_begin(epoch)
            epoch_logs = {}
            start_time = time.time()
            total_loss_epoch = 0.0
            train_result = {}

            order = (rng_shuffle.permutation(sample_num) if shuffle
                     else np.arange(sample_num))
            self._begin_steps(steps_per_epoch, epoch)
            iterator = range(steps_per_epoch)
            if verbose == 1 and tqdm is not None:
                iterator = tqdm(iterator, disable=False)
            try:
                for step in iterator:
                    idx = order[step * batch_size:(step + 1) * batch_size]
                    n_valid = len(idx)
                    if n_valid < batch_size:  # pad to the batch size
                        pad = np.zeros(batch_size - n_valid, dtype=idx.dtype)
                        idx = np.concatenate([idx, pad])
                    sw = np.zeros(batch_size, np.float32)
                    sw[:n_valid] = 1.0
                    rows, sw = self._put_batch(idx, sw)
                    xb = torch.from_numpy(X[rows]).to(device)
                    yb = torch.from_numpy(y[rows]).to(device)
                    swb = torch.from_numpy(sw).to(device)
                    _, total_loss, y_pred = self._train_step(xb, yb, swb)
                    total_loss_epoch += float(total_loss)
                    if verbose > 0 and self.metrics:
                        y_np = y[idx][:n_valid]
                        p_np = y_pred.cpu().numpy().astype(
                            "float64")[:n_valid]
                        if self.num_tasks == 1:
                            y_np = y_np.reshape(-1)
                            p_np = p_np.reshape(-1)
                        for name, metric_fun in self.metrics.items():
                            train_result.setdefault(name, []).append(
                                metric_fun(y_np, p_np))
            finally:
                if hasattr(iterator, "close"):
                    iterator.close()

            epoch_logs["loss"] = total_loss_epoch / sample_num
            for name, result in train_result.items():
                epoch_logs[name] = np.sum(result) / steps_per_epoch

            if do_validation:
                eval_result = self.evaluate(val_x, val_y, batch_size)
                for name, result in eval_result.items():
                    epoch_logs["val_" + name] = result

            if verbose > 0:
                epoch_time = int(time.time() - start_time)
                print("Epoch {0}/{1}".format(epoch + 1, epochs))
                eval_str = "{0}s - loss: {1: .4f}".format(
                    epoch_time, epoch_logs["loss"])
                for name in self.metrics:
                    eval_str += " - " + name + ": {0: .4f}".format(
                        epoch_logs[name])
                if do_validation:
                    for name in self.metrics:
                        eval_str += (" - val_" + name + ": {0: .4f}".format(
                            epoch_logs["val_" + name]))
                print(eval_str)
            callbacks.on_epoch_end(epoch, epoch_logs)
            if self.stop_training:
                break
        callbacks.on_train_end()
        return self.history

    def assemble_device_input(self, x):
        """dict/list of host arrays -> one flat [N, input_dim] float32
        tensor on the model's device.  Feed it to :meth:`fit` and
        :meth:`predict` for the device-resident loops: one upload, and no
        host traffic a step."""
        return torch.from_numpy(self._assemble_x(x)).to(self._device)

    def _fit_device(self, X, y, batch_size, epochs, verbose, initial_epoch,
                    validation_split, validation_data, shuffle, callbacks):
        """The device-resident training loop (``deepctr_tpu/models/
        basemodel.py:1509-1656``): ``X`` a flat [N, input_dim] tensor
        (column order = ``feature_index``), moved once to the model's
        device.  The data is padded to ``steps * B`` rows with zero rows at
        sample weight 0, an epoch's permutation is drawn on the device
        (``torch.randperm`` from a generator seeded with ``seed``), and
        every step gathers its batch and trains on the device: on the card
        a replay of one captured graph (``graphs.StepGraph``).  The host
        reads one loss vector an epoch; the epoch loss is its sum over N.

        As the JAX package's loop: train metrics (``verbose > 0``) are
        computed once over the epoch's predictions, not averaged over
        batches; epoch callbacks, History, EarlyStopping and validation
        are kept."""
        if batch_size is None:
            batch_size = 256
        device = self._device
        if X.dim() != 2 or X.shape[1] != self.input_dim:
            raise ValueError("tensor input must be [N, %d], got %r"
                             % (self.input_dim, tuple(X.shape)))
        X = X.to(device, torch.float32)
        y = torch.as_tensor(y if isinstance(y, torch.Tensor)
                            else np.asarray(y)).to(device, torch.float32)
        if y.dim() == 1:
            y = y[:, None]
        if y.shape[0] != X.shape[0]:
            raise ValueError(
                "x and y have different sample counts: %d vs %d"
                % (X.shape[0], y.shape[0]))

        do_validation = False
        val_x, val_y = [], []
        if validation_data:
            do_validation = True
            val_x, val_y = validation_data[:2]
        elif validation_split and 0. < validation_split < 1.:
            do_validation = True
            split_at = int(X.shape[0] * (1. - validation_split))
            X, val_x = X[:split_at], X[split_at:]
            y, val_y = y[:split_at], y[split_at:]

        B = batch_size
        sample_num = X.shape[0]
        steps_per_epoch = (sample_num - 1) // B + 1
        n_pad = steps_per_epoch * B
        need_preds = bool(verbose > 0 and self.metrics)
        self._check_sparse_ids(X)
        self._reserve_steps(steps_per_epoch)
        key = self._graph_key("fit", B, steps_per_epoch, n_pad,
                              bool(shuffle), need_preds)
        loop = self._graphs.get(key)
        if loop is None:
            loop = self._graphs[key] = StepGraph(
                self, B, steps_per_epoch, n_pad, y.shape[1], bool(shuffle),
                need_preds)
        loop.load(X, y)
        self._warn_if_eager(loop, "the device-resident loop")
        generator = torch.Generator(device=device)

        callbacks = CallbackList((callbacks or []) + [self.history])
        callbacks.set_model(self)
        callbacks.on_train_begin()
        self.stop_training = False

        if verbose > 0:
            print("Train on {0} samples, validate on {1} samples, {2} steps "
                  "per epoch (device-resident loop)".format(
                      sample_num, len(val_y), steps_per_epoch))

        for epoch in range(initial_epoch, epochs):
            callbacks.on_epoch_begin(epoch)
            start_time = time.time()
            with span("fit.epoch_begin"):
                state = np.random.SeedSequence([self.seed, epoch])
                generator.manual_seed(
                    int(state.generate_state(1, np.uint64)[0]))
                loop.begin_epoch(generator, epoch)
            losses = loop.run()
            with span("fit.epoch_end"):
                epoch_logs = {"loss": float(losses.sum()) / sample_num}
                self._epoch_metrics(
                    epoch_logs, y[:sample_num] if need_preds else None,
                    loop.preds[:sample_num] if need_preds else None,
                    (val_x, val_y) if do_validation else None, batch_size)
            if verbose > 0:
                print("Epoch {0}/{1} - {2}s - loss: {3:.4f}".format(
                    epoch + 1, epochs, int(time.time() - start_time),
                    epoch_logs["loss"]) +
                    "".join(" - %s: %.4f" % (k, v)
                            for k, v in epoch_logs.items() if k != "loss"))
            callbacks.on_epoch_end(epoch, epoch_logs)
            if self.stop_training:
                break
        callbacks.on_train_end()
        return self.history

    def _fit_stream(self, make_iter, batch_size, epochs, verbose,
                    initial_epoch, validation_data, callbacks,
                    steps_per_epoch, shuffle=True):
        """The streamed fit (``deepctr_tpu/models/basemodel.py:1658-1845``):
        one pass over ``make_iter()`` an epoch, each ``(x_chunk, y_chunk)``
        trained as it comes, for data larger than host memory.

        The host half runs on a background thread, one chunk ahead of the
        device, through a queue of two: it takes a chunk from the iterator,
        assembles and hashes it (``_assemble_x``), checks its sparse ids,
        shuffles it within the chunk (one ``np.random.default_rng(seed)``
        for the whole fit, one permutation a chunk, as the JAX package); it
        makes no CUDA call (one could meet a graph capture on the main
        thread).  The device half copies the chunk into pinned memory and
        uploads it once, without blocking, into the static buffers of the
        loop for its geometry
        (``graphs.StepGraph`` at ``nb`` steps of ``batch_size``, no
        shuffle; the last rows padded with zeros at sample weight 0) and
        trains its ``nb`` steps: replays of one captured graph on the card,
        eager steps on the CPU.  Nothing is read back inside a chunk; the
        losses stay on the device until the epoch ends, and the epoch loss
        is their sum over the samples seen.  The dropout generator is
        reseeded once an epoch and adam's step count runs on across the
        chunks (``_ready_steps``), so a step's masks and bias corrections
        are those of its place in the epoch.

        ``steps_per_epoch`` caps an epoch's steps, cutting the chunk that
        reaches it (the worker then stops taking chunks, so the shuffle's
        draws do not depend on how far it ran ahead).  An error in the
        worker is raised here; the worker is stopped and joined whatever
        happens.  Train metrics (``verbose > 0``) are computed over the
        epoch's predictions; validation and callbacks as in
        :meth:`_fit_device`.  A model keeps the loops of its last
        ``_STREAM_LOOPS`` chunk geometries."""
        if batch_size is None:
            batch_size = 256
        self._ensure_compiled()
        B = batch_size
        device = self._device
        pin = device.type == "cuda"
        rng_shuffle = np.random.default_rng(self.seed)
        need_preds = bool(verbose > 0 and self.metrics)
        n_out = self.num_tasks

        def prep_chunk(x_chunk, y_chunk):
            X = self._assemble_x(x_chunk)
            yc = np.asarray(y_chunk, dtype=np.float32)
            if yc.ndim == 1:
                yc = yc[:, None]
            if yc.shape[0] != X.shape[0]:
                raise ValueError("a chunk's x and y have different sample "
                                 "counts: %d vs %d"
                                 % (X.shape[0], yc.shape[0]))
            self._check_sparse_ids(X)
            if shuffle:
                order = rng_shuffle.permutation(len(X))
                X, yc = X[order], yc[order]
            return X, yc, len(X), (len(X) - 1) // B + 1

        def produce(q, stop):
            def put(item):
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        pass
                return False

            chunks = None
            try:
                chunks = iter(make_iter())
                steps = 0
                for x_chunk, y_chunk in chunks:
                    if stop.is_set():
                        return
                    item = prep_chunk(x_chunk, y_chunk)
                    if item[2] == 0:
                        continue
                    if not put(item):
                        return
                    steps += item[3]
                    if steps_per_epoch and steps >= steps_per_epoch:
                        break
                put(None)
            except BaseException as e:   # raised again on the main thread
                put(e)
            finally:
                close = getattr(chunks, "close", None)
                if close is not None:
                    close()

        callbacks = CallbackList((callbacks or []) + [self.history])
        callbacks.set_model(self)
        callbacks.on_train_begin()
        self.stop_training = False

        for epoch in range(initial_epoch, epochs):
            callbacks.on_epoch_begin(epoch)
            start_time = time.time()
            self._begin_epoch(epoch)
            sample_num, steps = 0, 0
            loss_parts, pred_parts, y_parts = [], [], []
            q = queue.Queue(maxsize=2)
            stop = threading.Event()
            worker = threading.Thread(target=produce, args=(q, stop),
                                      daemon=True)
            worker.start()
            try:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    X, yc, n, nb = item
                    if steps_per_epoch and steps + nb > steps_per_epoch:
                        nb = steps_per_epoch - steps
                        n = min(n, nb * B)
                    Xt, yt = torch.from_numpy(X[:n]), torch.from_numpy(yc[:n])
                    if pin:   # not on the worker: see the docstring
                        Xt, yt = Xt.pin_memory(), yt.pin_memory()
                    loop = self._stream_loop(B, nb, n_out, need_preds)
                    loop.load(Xt, yt)
                    self._ready_steps(nb)
                    loss_parts.append(loop.run().clone())
                    if need_preds:
                        pred_parts.append(loop.preds[:n].clone())
                        y_parts.append(yc[:n])
                    steps += nb
                    sample_num += n
                    if steps_per_epoch and steps >= steps_per_epoch:
                        break
            finally:
                stop.set()
                worker.join(timeout=60)
                if worker.is_alive():
                    warnings.warn("the streamed fit's reader thread is still "
                                  "inside the chunk iterator after 60 s")
            total = float(sum(l.sum() for l in loss_parts)) \
                if loss_parts else 0.0
            epoch_logs = {"loss": total / max(sample_num, 1)}
            seen = need_preds and pred_parts
            self._epoch_metrics(
                epoch_logs, np.concatenate(y_parts) if seen else None,
                torch.cat(pred_parts) if seen else None,
                validation_data[:2] if validation_data else None,
                batch_size)
            if verbose > 0:
                print("Epoch {0}/{1} - {2}s - {3} samples - loss: {4:.4f}"
                      .format(epoch + 1, epochs,
                              int(time.time() - start_time), sample_num,
                              epoch_logs["loss"]) +
                      "".join(" - %s: %.4f" % (k, v)
                              for k, v in epoch_logs.items() if k != "loss"))
            callbacks.on_epoch_end(epoch, epoch_logs)
            if self.stop_training:
                break
        callbacks.on_train_end()
        return self.history

    # the streamed fit's loops a model keeps, one for each chunk geometry
    # (full chunks, the last one, one cut by steps_per_epoch, ...)
    _STREAM_LOOPS = 4

    def _stream_loop(self, B, nb, n_out, need_preds):
        """The streamed fit's loop of ``nb`` steps of ``B``: kept among the
        model's graphs, the least recently used dropped past
        ``_STREAM_LOOPS``.  adam's table of bias corrections is made large
        enough first, since a new one drops the graphs."""
        self._reserve_steps(nb)
        key = self._graph_key("stream", B, nb, n_out, need_preds)
        loop = self._graphs.pop(key, None)
        if loop is None:
            streams = [k for k in self._graphs if k[0] == "stream"]
            if len(streams) >= self._STREAM_LOOPS:
                self._graphs.pop(streams[0]).release()
            loop = StepGraph(self, B, nb, nb * B, n_out, False, need_preds)
            self._warn_if_eager(loop, "the streamed fit")
        self._graphs[key] = loop
        return loop

    def _warn_if_eager(self, loop, what):
        """Warn, once a compile, that ``what`` runs its steps eagerly on
        the card: an optimizer object whose ``step()`` cannot be captured
        (``TorchOptimizer.capturable``)."""
        if (self._device.type == "cuda" and not loop.capturable
                and self.mesh is None and not self._eager_step_warned):
            self._eager_step_warned = True
            warnings.warn(
                "%s cannot be captured in a CUDA graph (it needs "
                "capturable=True, which its parameter groups do not set): "
                "%s runs each step eagerly on the card"
                % (type(self.optim).__name__, what))

    def _epoch_metrics(self, logs, y, pred, validation, batch_size):
        """Into ``logs``: each train metric over the epoch's labels ``y``
        and predictions ``pred`` (arrays or tensors; None for none), once
        for the whole epoch as the JAX package's device and streamed loops
        compute them, and each metric of ``validation`` = ``(x, y)`` (or
        None) as ``val_<name>``."""
        if pred is not None:
            y_np = y.cpu().numpy() if isinstance(y, torch.Tensor) else y
            p_np = pred.cpu().numpy().astype("float64")
            if self.num_tasks == 1:
                y_np, p_np = y_np.reshape(-1), p_np.reshape(-1)
            for name, metric_fun in self.metrics.items():
                logs[name] = metric_fun(y_np, p_np)
        if validation is not None:
            val_x, val_y = validation
            for name, result in self.evaluate(val_x, val_y,
                                              batch_size).items():
                logs["val_" + name] = result

    def evaluate(self, x, y, batch_size=256):
        """``{metric: value}`` over the predictions of ``x``.  A multi-task
        model with a label column a task also reports each task as
        ``<task name>_<metric>``, the bare name being the mean over the
        tasks (``deepctr_tpu/models/basemodel.py:1993-2018``), so that
        ``History``, ``EarlyStopping`` and ``ModelCheckpoint`` can follow
        ``val_<task>_<metric>``."""
        pred_ans = self.predict(x, batch_size)
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        eval_result = {}
        for name, metric_fun in self.metrics.items():
            if self.num_tasks > 1 and y.ndim > 1 and y.shape[-1] > 1:
                task_names = list(getattr(self, "task_names", []) or
                                  ["task%d" % i for i in range(y.shape[-1])])
                vals = []
                for i in range(y.shape[-1]):
                    v = metric_fun(y[:, i], pred_ans[:, i])
                    eval_result["%s_%s" % (task_names[i], name)] = v
                    vals.append(v)
                eval_result[name] = float(np.mean(vals))
            else:
                eval_result[name] = metric_fun(y.reshape(-1),
                                               pred_ans.reshape(-1))
        return eval_result

    def predict(self, x, batch_size=256):
        """Batched inference -> float64 ndarray [N, out_dim].

        ``x`` is a dict/list of host arrays, or a flat [N, input_dim]
        tensor on any device.  Every batch has ``batch_size`` rows, the
        last padded with zero rows, as the JAX package's
        (``basemodel.py:2020-2053``).  On the card each batch is copied
        into a static buffer and replays one captured forward
        (``graphs.ForwardGraph``); the predictions are read back once at
        the end.  On a mesh every rank calls it with the same ``x``, runs
        its rows of each batch eagerly and gets every prediction.

        Spans: ``predict`` over the call; inside it ``assemble`` (host
        arrays), then a batch's ``predict.upload`` (its copy to the
        device and the padding) and ``predict.forward`` (the replay or
        the eager forward), then ``predict.readback`` (the predictions to
        the host, which waits for the device)."""
        with span("predict"):
            device = self._device
            if isinstance(x, torch.Tensor):
                X = x
                if X.dim() != 2 or X.shape[1] != self.input_dim:
                    raise ValueError("tensor input must be [N, %d], got %r"
                                     % (self.input_dim, tuple(X.shape)))
            else:
                X = torch.from_numpy(self._assemble_x(x))
            forward = None
            if device.type == "cuda" and self.mesh is None:
                key = self._graph_key("predict", batch_size)
                forward = self._graphs.get(key)
                if forward is None:
                    forward = self._graphs[key] = ForwardGraph(self,
                                                               batch_size)
            outs = []
            with torch.no_grad():
                for start in range(0, X.shape[0], batch_size):
                    xb = X[start:start + batch_size]
                    if forward is not None:
                        outs.append(forward.run(xb))
                        continue
                    n = xb.shape[0]
                    with span("predict.upload"):
                        xb = xb.to(device, torch.float32)
                        if n < batch_size:
                            xb = torch.cat([xb, xb.new_zeros(batch_size - n,
                                                             xb.shape[1])])
                        xb = self._put_batch(xb)   # a mesh rank's rows
                    with span("predict.forward"):
                        out = self(xb, training=False).float()
                        if self.mesh is not None:
                            out = gather_data(out, self._axes)
                        outs.append(out[:n])
            with span("predict.readback"):
                out = torch.cat(outs).cpu().numpy().astype("float64")
                if out.ndim == 1:
                    out = out[:, None]
                return out

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def get_weights(self):
        """``{state_dict key: numpy array}``, row-sharded tables whole
        (:meth:`full_state_dict`: every rank of the mesh calls it)."""
        return {k: v.cpu().numpy()
                for k, v in self.full_state_dict().items()}

    def set_weights(self, weights):
        """Load ``{state_dict key: array or tensor}``; every key must match,
        shape included, a row-sharded table's at its full size (this rank
        keeps its block).  Copies into the existing parameters; a compiled
        model's optimizer state starts afresh, as in the JAX package (an
        optimizer object keeps its own: ``TorchOptimizer``)."""
        paths = self._param_paths()
        state = {}
        for k, v in weights.items():
            v = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                np.array(v))
            state[k] = self._block(paths.get(k), v)
        self.load_state_dict(state, strict=True)
        if self.optim is not None:
            self._init_optimizer_state()

    # ------------------------------------------------------------------
    # persistence (deepctr_tpu/models/basemodel.py:2150-2172)
    # ------------------------------------------------------------------
    def save_weights(self, path):
        serialization.save_weights(self, path)

    def load_weights(self, path):
        serialization.load_weights(self, path)

    def save(self, path):
        serialization.save_model(self, path)

    def save_checkpoint(self, directory, include_optimizer=True):
        """Train-state checkpoint (weights, and the dense and sparse
        optimizer state) for an exact resume with ``fit(initial_epoch=)``
        (``utils/serialization.py``)."""
        serialization.save_checkpoint(self, directory, include_optimizer)

    def load_checkpoint(self, directory):
        return serialization.load_checkpoint(self, directory)
