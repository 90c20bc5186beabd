"""Model base: device, seeded init, batch assembly, predict, weights, and
the Keras-style training engine.

Counterpart of ``deepctr_tpu/models/basemodel.py``: ``__init__``
(:144-210), regularization rules (:186-194, :215-287), ``compile``
(:311-367), the sparse-table gate (:374-479), lane masks and lazy L2
(:650-722), the active-rows train step (:724-1277) and the train step
(:1331-1378), ``_assemble_x`` (:1413-1444), ``fit`` on host arrays
(:1846-1991), ``evaluate`` (:1993-2018), ``predict`` (:2020-2053) and
``get_weights``/``set_weights`` (:2125-2134).  The model is the
``nn.Module`` itself; its ``state_dict`` is its weights.

A train step, per batch:

1. the touched rows of every sparse table: the unique ids of the batch's
   id columns for that table plus a synthetic id 0, from one library
   sort (``torch.unique``) over all sparse tables;
2. the forward, whose gathers run without a graph back to the tables
   (``EmbeddingDict._capture``): the gathered rows are leaves;
3. loss + the eager L1/L2 of the dense parameters + the model's auxiliary
   term (DIEN's, ``aux_loss``), ``backward``;
4. one ``scatter_add_rows`` launch a gather: each row's cotangent goes
   into its dense table's ``[V, W]`` gradient, or into the ``[n, W]``
   gradient of its sparse table's touched rows (a ``VarLenSparseFeat``
   is ``maxlen`` fields of its table);
5. the dense optimizer on the dense parameters, and one ``row_update``
   launch on the touched rows of every sparse table (lazy L2 and the
   optimizer's row step, in place).

Unlike the JAX package, which stores tables of >= 131072 rows packed into
128-lane rows and updates them by packed row, the port updates logical
rows; see ``ROADMAP.md`` section 3.
"""

import re
import time
import warnings

import numpy as np
import torch

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None

from ..callbacks import CallbackList, History
from ..features import SparseFeat, VarLenSparseFeat
from ..layers.utils import slice_arrays
from ..losses import resolve_loss
from ..ops import row_update as _row_update
from ..ops._args import device_array
from ..ops.row_update import adam_bias_corrections, row_update
from ..ops.scatter_add import scatter_add_rows
from ..utils.jax_weights import jax_path
from ..utils.metrics import resolve_metrics
from .base_module import BaseModule, fused_wide_names

# torch-default learning rates, as deepctr_tpu/models/basemodel.py:52-53;
# one source for the dense parameters and the sparse tables
_OPT_DEFAULT_LR = {"sgd": 0.01, "adam": 0.001, "adagrad": 0.01,
                   "rmsprop": 0.01}
_SPARSE_OPTIMIZERS = ("sgd", "adagrad", "adam", "rmsprop")
# the "auto" gate (basemodel.py:392, :408-412)
_AUTO_MIN_MODEL_ROWS = 1_000_000
_AUTO_MIN_TABLE_ROWS = 16384
# the JAX package's packed storage (deepctr_tpu/inputs.py:302-313), used
# only to count table rows as the JAX package's "auto" gate counts them
_PACKED_VOCAB_THRESHOLD = 131072


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
    - adam: ``m, v`` moments, bias corrections from a step count,
      ``p += -lr * m_hat / (sqrt(v_hat) + 1e-8)``.

    A parameter without a gradient steps with a zero one, as optax does.
    """

    def __init__(self, name, lr, params):
        self.name = name
        self.lr = lr
        self.params = list(params)
        n_state = _row_update.MODES[name][1]
        self.state = [tuple(torch.zeros_like(p) for _ in range(n_state))
                      for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        self.count += 1
        lr = self.lr
        if self.name == "adam" and self.params:
            # device tensors: CUDA divides by a host scalar as a multiply
            # by its reciprocal
            bc1, bc2 = device_array(adam_bias_corrections(self.count),
                                    torch.float32, self.params[0].device)
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


class _TouchedRows:
    """The rows a batch touches in each sparse table, from one sort.

    ``rows[t]`` are table t's touched row ids (sorted, unique, row 0
    always among them), ``grads[t]`` a zero ``[len(rows[t]), W_t]``
    gradient for them, and ``slots[:, c]`` the position in its table's
    ``rows`` of the id in the c-th sparse id column of X."""

    def __init__(self, X, specs, tables):
        device = X.device
        cols, table_of_col = [], []
        for t, (_, spans, _) in enumerate(specs):
            for s, e in spans:
                cols.extend(range(s, e))
                table_of_col.extend([t] * (e - s))
        self.col_index = {c: i for i, c in enumerate(cols)}
        starts = np.concatenate([[0], np.cumsum([n for _, _, n in specs])]
                                ).tolist()       # tables laid end to end
        bases = device_array(starts, torch.int64, device)
        tcol = device_array(table_of_col, torch.int64, device)
        ids = X[:, cols].to(torch.int32).to(torch.int64)          # [B, C]
        keys = ids + bases[tcol]
        # the synthetic id 0 of every table first, then the id columns
        all_keys = torch.cat([bases[:-1], keys.t().reshape(-1)])
        uniq, inv = torch.unique(all_keys, sorted=True, return_inverse=True)
        lo_d = torch.searchsorted(uniq, bases)
        bad = ((ids < 0) | (ids >= (bases[1:] - bases[:-1])[tcol])).any()
        host = torch.cat([lo_d, bad.view(1).to(torch.int64)]).tolist()
        if host[-1]:
            raise ValueError("a sparse id lies outside its table's "
                             "vocabulary")
        lo = host[:-1]
        n_tables = len(specs)
        self.slots = (inv[n_tables:].view(len(cols), -1).t()
                      - lo_d[:-1][tcol])                          # [B, C]
        self.counts = [lo[t + 1] - lo[t] for t in range(n_tables)]
        widths = [tables[p].shape[1] for p, _, _ in specs]
        self.rows = [uniq[lo[t]:lo[t + 1]] - starts[t]
                     for t in range(n_tables)]
        flat = torch.zeros(sum(n * w for n, w in zip(self.counts, widths)),
                           dtype=torch.float32, device=device)
        self.grads, off = [], 0
        for n, w in zip(self.counts, widths):
            self.grads.append(flat[off:off + n * w].view(n, w))
            off += n * w
        self.index = {p: t for t, (p, _, _) in enumerate(specs)}


class BaseModel(BaseModule):
    """Feature plumbing, seeded init, training and inference around a
    model's layers.

    Every parameter is drawn at construction from one ``torch.Generator``
    on the model's device, seeded with ``seed``; subclasses draw their own
    layers from ``self._init_generator`` after this ``__init__``.
    """

    def __init__(self, linear_feature_columns, dnn_feature_columns,
                 l2_reg_linear=1e-5, l2_reg_embedding=1e-5, init_std=1e-4,
                 seed=1024, task="binary", device=None, gpus=None):
        device = resolve_device(device)
        hashed = [f.name for f in list(linear_feature_columns)
                  + list(dnn_feature_columns)
                  if isinstance(f, (SparseFeat, VarLenSparseFeat))
                  and f.use_hash]
        if hashed:
            raise NotImplementedError(
                "use_hash features %s are not ported yet (they need the "
                "native batcher)" % hashed)
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

    def _named_params(self):
        """``[(JAX path, parameter)]`` sorted by path, as the JAX package
        flattens its tree."""
        return sorted(((jax_path(k), p) for k, p in self.named_parameters()),
                      key=lambda kv: kv[0])

    def _tables(self):
        """``{JAX path: table}`` of every embedding table."""
        out = {"embedding_dict/%s" % n: t
               for n, t in self.embedding_dict.tables.items()}
        out.update({"linear_model/embedding_dict/%s" % n: t
                    for n, t in self.linear_model.embedding_dict.tables.items()})
        return out

    def _table_layouts(self):
        """``{table path: (width, fused deep dim or None)}``."""
        layouts = {}
        for name, t in self.embedding_dict.tables.items():
            fused = name in self.embedding_dict.wide_names
            layouts["embedding_dict/%s" % name] = (
                t.shape[1], self.embedding_dict.table_dims[name]
                if fused else None)
        for name, t in self.linear_model.embedding_dict.tables.items():
            layouts["linear_model/embedding_dict/%s" % name] = (t.shape[1],
                                                                None)
        return layouts

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
                    mask = (None if mask.all()
                            else torch.from_numpy(mask).to(w.device))
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
        return torch.from_numpy(vec).to(self._tables()[path].device)

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------
    def compile(self, optimizer, loss=None, metrics=None,
                learning_rate=None, sparse_table_updates="auto"):
        """Configure the optimizer (a name: ``sgd``, ``adagrad``,
        ``rmsprop``, ``adam``, with torch-default learning rates that
        ``learning_rate`` overrides for both the dense parameters and the
        sparse tables), the loss (name, callable, or per-task list) and
        the metrics (names).

        ``sparse_table_updates``: True / False / "auto".  Tables on the
        sparse path never get a dense gradient: each step updates only the
        rows its batch touched, with their L2 applied lazily.  "auto"
        turns it on when the model holds >= 1M table rows, and then only
        for tables of >= 16384 rows."""
        if not isinstance(optimizer, str):
            raise NotImplementedError(
                "the port takes optimizers by name (%s); optimizer objects "
                "are not ported" % ", ".join(sorted(_OPT_DEFAULT_LR)))
        if optimizer not in _OPT_DEFAULT_LR:
            raise NotImplementedError("unknown optimizer %r" % optimizer)
        self._optimizer_name = optimizer
        self._learning_rate = (float(learning_rate)
                               if learning_rate is not None
                               else _OPT_DEFAULT_LR[optimizer])
        self.optim = optimizer
        self.loss_func = resolve_loss(loss)
        self.metrics = resolve_metrics(metrics)
        self.metrics_names = ["loss"] + list(self.metrics)
        self._sparse_specs = self._resolve_sparse_specs(sparse_table_updates)
        self._init_optimizer_state()
        return self

    def _init_optimizer_state(self):
        """Fresh optimizer state for the dense parameters and the sparse
        tables (at compile, and when ``set_weights`` loads new weights)."""
        tables = self._tables()
        sparse = {p for p, _, _ in self._sparse_specs}
        self._dense_opt = DenseOptimizer(
            self._optimizer_name, self._learning_rate,
            [p for path, p in self._named_params() if path not in sparse])
        n_state = _row_update.MODES[self._optimizer_name][1]
        self._table_state = {
            p: tuple(torch.zeros_like(tables[p]) for _ in range(n_state))
            for p, _, _ in self._sparse_specs}
        self._table_t = {p: 0 for p, _, _ in self._sparse_specs}
        self._step_rules = None

    def _ensure_compiled(self):
        """The eager regularization term and the sparse tables' lazy L2,
        fixed at the first fit after ``compile`` (as the JAX package builds
        its train step), so that rules added in between apply."""
        if self.optim is None:
            raise RuntimeError("call model.compile(...) before fit()")
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
            return []
        tables = self._tables()
        vocabs = self._table_vocabs()
        spans_map = {p: s for p, s in self._table_id_spans().items()
                     if p in tables and p in vocabs}
        if mode == "auto":
            # rows as the JAX package stores them: a table of >= 131072
            # rows and width <= 64 packs 128 // width rows into one
            def stored(p):
                v, w = tables[p].shape
                if v >= _PACKED_VOCAB_THRESHOLD and w <= 64:
                    return -(-v // (128 // w))
                return v
            if sum(stored(p) for p in spans_map) < _AUTO_MIN_MODEL_ROWS:
                return []
            spans_map = {p: s for p, s in spans_map.items()
                         if vocabs[p] >= _AUTO_MIN_TABLE_ROWS}
        specs = [(p, tuple(map(tuple, spans)), tables[p].shape[0])
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
    def _embedding_dicts(self):
        return (("embedding_dict/", self.embedding_dict),
                ("linear_model/embedding_dict/",
                 self.linear_model.embedding_dict))

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
        sw [B].  Returns (data loss, total loss, predictions), detached."""
        tables = self._tables()
        touched = (_TouchedRows(X, self._sparse_specs, tables)
                   if self._sparse_specs else None)
        captures = {}
        for prefix, ed in self._embedding_dicts():
            ed._capture = captures.setdefault(prefix, [])
        self.aux_loss = None
        try:
            y_pred = self(X, training=True)
        finally:
            for _, ed in self._embedding_dicts():
                ed._capture = None
            aux, self.aux_loss = self.aux_loss, None
        reg, _ = self._ensure_compiled()
        data_loss = self._compute_loss(y_pred.float(), y, sw)
        total = data_loss + self._reg_loss(reg)
        if aux is not None:
            total = total + aux
        for p in self._dense_opt.params:
            p.grad = None
        total.backward()
        with torch.no_grad():
            self._scatter_row_grads(X, captures, tables, touched)
            self._dense_opt.step()
            if touched is not None:
                self._update_touched_rows(tables, touched)
        return data_loss.detach(), total.detach(), y_pred.detach()

    def _scatter_row_grads(self, X, captures, tables, touched):
        """One ``scatter_add_rows`` launch for each gather of the forward:
        a dense table's rows into its ``.grad``, a sparse table's into the
        gradient of its touched rows, at their slots."""
        def dense_grad(table):
            if table.grad is None:
                table.grad = torch.zeros_like(table)
            return table.grad

        for prefix, groups in captures.items():
            for fcs, rows in groups:
                if rows.grad is None:
                    continue
                targets, idx = self._scatter_targets(X, prefix, fcs, tables,
                                                     touched, dense_grad)
                scatter_add_rows(rows.grad, targets, idx)

    def _scatter_targets(self, X, prefix, fcs, tables, touched, dense_target):
        """``scatter_add_rows``'s targets and ``[B, F]`` rows for the fields
        of one gather of the columns ``fcs``, in the gather's field order
        (a ``VarLenSparseFeat`` is ``maxlen`` fields, one an id column):
        ``dense_target(table)`` indexed by id for a dense table, the
        touched rows' gradient indexed by slot for a sparse one."""
        targets, cols, fields, slot_cols = [], [], [], []
        for fc in fcs:
            path = prefix + fc.embedding_name
            start, end = self.feature_index[fc.name]
            if not isinstance(fc, VarLenSparseFeat):
                end = start + 1
            sparse = touched is not None and path in touched.index
            target = (touched.grads[touched.index[path]] if sparse
                      else dense_target(tables[path]))
            for col in range(start, end):
                if sparse:
                    fields.append(len(cols))
                    slot_cols.append(touched.col_index[col])
                cols.append(col)
                targets.append(target)
        idx = X[:, cols].to(torch.int32).to(torch.int64)
        if fields:
            idx[:, fields] = touched.slots[:, slot_cols]
        return targets, idx

    def _update_touched_rows(self, tables, touched):
        """One ``row_update`` launch over every sparse table."""
        paths = [p for p, _, _ in self._sparse_specs]
        _, l2_vecs = self._ensure_compiled()
        bias = None
        if self._optimizer_name == "adam":
            bias = []
            for p in paths:
                self._table_t[p] += 1
                bias.append(adam_bias_corrections(self._table_t[p]))
        row_update(self._optimizer_name, [tables[p] for p in paths],
                   [self._table_state[p] for p in paths], touched.grads,
                   touched.rows, touched.counts,
                   [l2_vecs[p] for p in paths], self._learning_rate,
                   bias)

    # ------------------------------------------------------------------
    # data plumbing
    # ------------------------------------------------------------------
    def _assemble_x(self, x):
        """dict/list of arrays -> one [N, input_dim] float32 matrix."""
        if isinstance(x, dict):
            x = [x[feature] for feature in self.feature_index]
        if isinstance(x, np.ndarray):
            x = [x]
        arrays = []
        for a in x:
            a = np.asarray(a)
            if a.ndim == 1:
                a = a[:, None]
            arrays.append(np.asarray(a, dtype=np.float32))
        lens = {a.shape[0] for a in arrays}
        if len(lens) > 1:
            detail = ", ".join(
                "%s: %d" % (n, a.shape[0])
                for n, a in zip(self.feature_index, arrays))
            raise ValueError(
                "input features have inconsistent sample counts (%s)"
                % detail)
        X = np.concatenate(arrays, axis=1)
        if X.shape[1] != self.input_dim:
            raise ValueError("input width %d != expected %d"
                             % (X.shape[1], self.input_dim))
        return X

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
        """Keras-style training loop over host arrays; returns the
        ``History``.  Batches have a fixed size; the last is padded with
        sample 0 at sample weight 0.  The shuffle is
        ``np.random.default_rng(seed).permutation``, as the JAX package's.

        Not ported yet, and raising: a tensor or a callable ``x``
        (device-resident and streaming fits), ``profile`` and
        ``steps_per_epoch``."""
        if isinstance(x, torch.Tensor):
            raise NotImplementedError("fit on a device tensor is not ported "
                                      "yet: pass host arrays")
        if callable(x):
            raise NotImplementedError("streaming fit (a callable x) is not "
                                      "ported yet")
        if profile is not None:
            raise NotImplementedError("fit(profile=...) is not ported yet")
        if steps_per_epoch is not None:
            raise NotImplementedError("steps_per_epoch goes with streaming "
                                      "fit, which is not ported yet")
        self._ensure_compiled()
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

        device = self._device
        rng_shuffle = np.random.default_rng(self.seed)
        sample_num = len(X)
        steps_per_epoch = (sample_num - 1) // batch_size + 1

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
                    xb = torch.from_numpy(X[idx]).to(device)
                    yb = torch.from_numpy(y[idx]).to(device)
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

    def evaluate(self, x, y, batch_size=256):
        """``{metric: value}`` over the predictions of ``x``."""
        pred_ans = self.predict(x, batch_size)
        y = np.asarray(y)
        return {name: metric_fun(y.reshape(-1), pred_ans.reshape(-1))
                for name, metric_fun in self.metrics.items()}

    def predict(self, x, batch_size=256):
        """Batched inference -> float64 ndarray [N, out_dim].

        ``x`` is a dict/list of host arrays, or a flat [N, input_dim]
        float32 tensor (which may already be on the model's device).
        """
        device = self._device
        if isinstance(x, torch.Tensor):
            X = x
            if X.dim() != 2 or X.shape[1] != self.input_dim:
                raise ValueError("tensor input must be [N, %d], got %r"
                                 % (self.input_dim, tuple(X.shape)))
        else:
            X = torch.from_numpy(self._assemble_x(x))
        outs = []
        with torch.no_grad():
            for start in range(0, X.shape[0], batch_size):
                xb = X[start:start + batch_size].to(device, torch.float32)
                outs.append(self(xb, training=False).float())
        out = torch.cat(outs).cpu().numpy().astype("float64")
        if out.ndim == 1:
            out = out[:, None]
        return out

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def get_weights(self):
        """``{state_dict key: numpy array}``."""
        return {k: v.detach().cpu().numpy()
                for k, v in self.state_dict().items()}

    def set_weights(self, weights):
        """Load ``{state_dict key: array}``; every key must match, shape
        included.  Copies into the existing parameters; a compiled model's
        optimizer state starts afresh, as in the JAX package."""
        self.load_state_dict({k: torch.as_tensor(np.array(v))
                              for k, v in weights.items()}, strict=True)
        if self.optim is not None:
            self._init_optimizer_state()
