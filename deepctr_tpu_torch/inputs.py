"""Embedding engine + flat-matrix lookup helpers.

Counterpart of ``deepctr_tpu/inputs.py``.  Tables live in one
``EmbeddingDict`` whose parameters are logical ``[vocab, width]`` float32
tables keyed by ``embedding_name``.  The JAX package stores big tables
packed into 128-lane rows for the TPU; here every table is stored as it
is read, and ``utils/jax_weights.py`` unpacks JAX weights.

A forward gathers the rows of every field in one kernel launch per row
width (:meth:`EmbeddingDict.gather`); the deep part of a fused table reads
``rows[..., :dim]`` and the wide part ``rows[..., dim:]`` of that one
gather, as the JAX package's ``_row_cache`` shares one gather between them.
A ``VarLenSparseFeat`` spans ``maxlen`` columns of the flat matrix and
gathers as ``maxlen`` fields of its table in the same launch.  On a mesh, a
row-sharded table holds only its block and its rows come through a lookup
exchange (:class:`TableHolder`).
"""

from collections import defaultdict
from itertools import chain

import torch
from torch import nn

from . import config
from .features import SparseFeat, DenseFeat, VarLenSparseFeat
from .layers.sequence import masked_pooling
from .layers.utils import concat_fun
from .ops.gather import gather_rows
from .parallel.embedding import A2ALookup, ShardedRows, a2a_rows, psum_rows
from .parallel.sharding import gather_data

# the JAX package stores a table of at least this many rows packed into
# 128-lane rows (``deepctr_tpu/inputs.py:302-313``); the port stores every
# table as it is read, and counts rows as the JAX package does where a rule
# depends on them (the "auto" sparse gate, the mesh's row sharding)
PACKED_VOCAB_THRESHOLD = 131072


# the JAX package's bfloat16 lowerings of a small-table lookup
# (``deepctr_tpu/inputs.py:190-233``, ``deepctr_tpu/config.py:131-180``,
# ``deepctr_tpu/ops/onehot_lookup.py:100-111``): tables of at most this
# many stored rows, a model-level lookup of at least this many ids
_GATHER_CAST_MAX_ROWS = 65536
_ONEHOT_MIN_IDS = 32768


def rounds_to_bf16(vocab, width, n_ids, substituted):
    """Whether the JAX package's ``"auto"`` gather mode, at bfloat16
    compute, returns this table's rows rounded to bfloat16: ``"cast"``
    for the touched rows of a packed table in a train step
    (``substituted``; at most 65536 of them), ``"onehot"`` (an exact
    bfloat16 one-hot product) for a full unpacked table of at most 65536
    rows when the model's largest lookup (``n_ids``, B times its longest
    sequence) reaches 32768 ids or the table factorizes; ``"off"`` (a
    float32 gather) otherwise."""
    rows, pack = stored_rows(vocab, width)
    if substituted:
        return pack > 1
    if pack > 1 or rows > _GATHER_CAST_MAX_ROWS:
        return False
    if n_ids >= _ONEHOT_MIN_IDS:
        return True
    v2 = min(max(1, 1024 // max(width, 1)), rows)
    return v2 > 1 and rows // v2 >= 2


def stored_rows(vocab, width):
    """``(rows, pack)``: the rows of a ``[vocab, width]`` table as the JAX
    package stores it, and the logical rows each of them packs (1 where it
    does not pack: fewer rows than ``PACKED_VOCAB_THRESHOLD``, or wider
    than 64)."""
    if vocab >= PACKED_VOCAB_THRESHOLD and width <= 64:
        pack = 128 // width
        return -(-vocab // pack), pack
    return vocab, 1


class TableHolder(nn.Module):
    """A module whose forward takes rows of its tables with
    ``gather_rows``.  Around a train step's forward the engine sets
    ``_capture`` to a list: a gather then runs without a graph back to the
    tables, its rows become leaves, and ``(table names, X columns, rows,
    kept)`` goes into the list, one name and column a field (``kept`` None,
    or a [B, F] bool of the rows whose cotangent counts: an a2a exchange's
    dropped ids get none); the engine scatters the rows' cotangent into
    each table's gradient itself (``models/basemodel.py``).  ``tables``
    maps each name to its table.

    On a mesh (``BaseModel._apply_sharding``) ``_axes`` is the mesh's
    ``parallel.sharding.Axes`` and ``_shards`` maps each row-sharded
    table's name to ``(first row, stop, vocab, rows a block)``: such a
    table holds only its block, and its rows come through the configured
    lookup exchange (``config.set_embedding_exchange``,
    ``parallel/embedding.py``).  In a train step the tables of ``_exact``
    (those on the sparse path) take the psum exchange whatever the mode,
    as the JAX package's active-rows step gathers them from the touched
    rows and runs no exchange (``deepctr_tpu/inputs.py:168-188``)."""

    def __init__(self):
        super().__init__()
        self._capture = None
        self._axes = None
        self._shards = {}
        self._exact = frozenset()

    def _gather(self, X, tables, names, cols):
        """``gather_rows`` of the fields ``(names[i], cols[i])``, whose
        ``[V, W]`` tables are ``tables``; the psum exchange where they are
        row-sharded (every name in ``_shards``)."""
        bases = None
        if names[0] in self._shards:
            bases = [self._shards[n][0] for n in names]
            ax = self._axes

            def lookup():
                if (torch.is_grad_enabled()
                        and any(t.requires_grad for t in tables)):
                    return ShardedRows.apply(X, cols, bases, ax.model_group,
                                             ax.n_model, *tables)
                return psum_rows(X, tables, cols, bases, ax.model_group,
                                 ax.n_model)
        else:
            def lookup():
                return gather_rows(X, tables, cols)
        if self._capture is None:
            return lookup()
        with torch.no_grad():
            rows = lookup()
        rows.requires_grad_()
        self._capture.append((names, cols, rows, None))
        return rows

    def _exchange_a2a(self, X, name, span):
        """Rows of table ``name`` (row-sharded) at the id columns ``span``
        of X through the a2a exchange -> [B, n, W].  The exchange sees the
        global batch's ids, as the JAX package's ``shard_map`` does: the
        data axis's ranks sum a zero-filled global matrix of their ids, and
        each keeps its rows of the result.  An overflow poisons every row
        with NaN (``on_overflow="error"``) or leaves the dropped ids zero
        rows."""
        ax = self._axes
        table = self.tables[name]
        base, _, _, rows_per = self._shards[name]
        n, width = X.shape[0], span[1] - span[0]
        ids = gather_data(X[:, span[0]:span[1]], ax)
        flat = ids.to(torch.int32).to(torch.int64).reshape(-1)
        keep = slice(ax.data * n * width, (ax.data + 1) * n * width)
        _, _, slack = config.embedding_exchange()
        args = (table, flat, base, rows_per, ax.model_group, ax.n_model,
                slack, keep)
        grad = (self._capture is None and torch.is_grad_enabled()
                and table.requires_grad)
        if grad:
            rows, ok, n_dropped = A2ALookup.apply(*args)
        else:
            with torch.no_grad():
                rows, ok, n_dropped = a2a_rows(*args)
        if config.a2a_on_overflow() == "error":
            rows = rows + torch.where(n_dropped > 0, float("nan"),
                                      0.0).to(rows.dtype)
        rows = rows.view(n, width, table.shape[1])
        if self._capture is not None:
            rows.requires_grad_()
            self._capture.append(([name] * width, list(range(*span)), rows,
                                  ok.view(n, width)))
        return rows


class EmbeddingDict(TableHolder):
    """All embedding tables for a feature-column list, deduped by
    ``embedding_name`` (shared tables).  ``linear=True`` builds dim-1
    tables for the wide/linear part.

    Tables named in ``wide_names`` carry ONE extra trailing column holding
    the wide/linear weight of that feature (the JAX package's fused wide
    column): width ``dim + 1``.  Tables are drawn from normal(init_std)
    with ``generator``.
    """

    def __init__(self, feature_columns, init_std=1e-4, linear=False,
                 wide_names=(), device=None, generator=None):
        super().__init__()
        self.wide_names = tuple(wide_names)
        self.tables = nn.ParameterDict()
        self.table_dims = {}
        for feat in feature_columns:
            if not isinstance(feat, (SparseFeat, VarLenSparseFeat)):
                continue
            name = feat.embedding_name
            if name in self.tables:
                continue
            dim = 1 if linear else feat.embedding_dim
            width = dim + 1 if name in self.wide_names else dim
            table = torch.empty(feat.vocabulary_size, width, device=device)
            table.normal_(0.0, init_std, generator=generator)
            self.tables[name] = nn.Parameter(table)
            self.table_dims[name] = dim
        # the longest lookup a row makes, as the JAX package's gather mode
        # counts it (``deepctr_tpu/inputs.py:108``)
        self._max_maxlen = max([f.maxlen for f in feature_columns
                                if isinstance(f, VarLenSparseFeat)] + [1])

    def _route(self, fc):
        """How feature ``fc``'s rows are looked up: ``"gather"`` (a
        replicated table), ``"psum"`` or ``"a2a"`` (a row-sharded one, by
        the configured exchange; the psum exchange for a table of
        ``_exact`` in a train step)."""
        name = fc.embedding_name
        if name not in self._shards:
            return "gather"
        if (config.embedding_exchange()[0] == "a2a"
                and not (self._capture is not None and name in self._exact)):
            return "a2a"
        return "psum"

    def gather(self, X, feature_index, feature_columns):
        """Full-width rows (incl. any wide column) of every feature in
        ``feature_columns``, one kernel launch per row width:
        ``{feature name: [B, 1, width]}``, ``[B, maxlen, width]`` for a
        ``VarLenSparseFeat``.  On a mesh the row-sharded tables take one
        more launch per row width and the psum exchange, or one a2a
        exchange per feature, as the JAX package's lookups are one a
        feature."""
        groups = defaultdict(list)
        for fc in feature_columns:
            width = self.tables[fc.embedding_name].shape[1]
            route = self._route(fc)
            groups[(width, route, fc.name if route == "a2a" else None)
                   ].append(fc)
        out = {}
        for (_, route, _), fcs in groups.items():
            names, cols, spans = [], [], []
            for fc in fcs:
                start, end = feature_index[fc.name]
                if not isinstance(fc, VarLenSparseFeat):
                    end = start + 1
                spans.append((len(cols), end - start))
                names += [fc.embedding_name] * (end - start)
                cols += range(start, end)
            if route == "a2a":
                rows = self._exchange_a2a(X, names[0],
                                          (cols[0], cols[-1] + 1))
            else:
                rows = self._gather(X, [self.tables[n] for n in names],
                                    names, cols)
            if config.compute_dtype() == torch.bfloat16:
                rows = self._round_like_jax(X, rows, names)
            for fc, (first, n) in zip(fcs, spans):
                out[fc.name] = rows[:, first:first + n]
        return out

    def _round_like_jax(self, X, rows, names):
        """``rows`` [B, F, W] with the fields whose table the JAX package
        looks up in bfloat16 (:func:`rounds_to_bf16`) rounded to bfloat16
        values, kept float32: the forward reads what the JAX package's
        lookup returns, and each row's cotangent is rounded to bfloat16
        on its way back, as the one-hot lowering's backward rounds it
        (whose float32 sums K1 then repeats; the ``"cast"`` lowering sums
        a batch's duplicate ids in bfloat16, the port in float32)."""
        n_data = 1 if self._axes is None else self._axes.n_data
        n_ids = X.shape[0] * n_data * self._max_maxlen
        train = self._capture is not None
        flags = {n: rounds_to_bf16(*self.tables[n].shape, n_ids,
                                   train and n in self._exact)
                 for n in set(names)}
        if not any(flags.values()):
            return rows
        rounded = rows.to(torch.bfloat16).to(rows.dtype)
        if all(flags.values()):
            return rounded
        # runs of fields alike, sliced (no index tensor: a captured step
        # uploads nothing)
        parts, first = [], 0
        for i in range(1, len(names) + 1):
            if i == len(names) or flags[names[i]] != flags[names[first]]:
                src = rounded if flags[names[first]] else rows
                parts.append(src[:, first:i])
                first = i
        return torch.cat(parts, dim=1)

    def forward(self, name, rows):
        """Deep columns of gathered full-width rows: [..., dim]."""
        if name in self.wide_names:
            return rows[..., :self.table_dims[name]]
        return rows

    def wide(self, name, rows):
        """The fused wide column of gathered full-width rows: [..., 1]."""
        return rows[..., self.table_dims[name]:]


def sparse_ids(X, span):
    """Static column slice -> int32 ids (truncating, as the JAX package)."""
    return X[:, span[0]:span[1]].to(torch.int32)


def embedding_lookup(X, embedding_dict, feature_index, sparse_feature_columns,
                     return_feat_list=(), mask_feat_list=(), to_list=False,
                     rows=None):
    """[B,1,E] embeddings per sparse feature, grouped by group_name.

    ``rows`` are full-width rows from :meth:`EmbeddingDict.gather` that the
    caller shares with other readers of the same tables; without them this
    gathers the selected features itself."""
    selected = [fc for fc in sparse_feature_columns
                if len(return_feat_list) == 0
                or fc.name in return_feat_list]
    if rows is None:
        rows = embedding_dict.gather(X, feature_index, selected)
    group_embedding_dict = defaultdict(list)
    for fc in selected:
        group_embedding_dict[fc.group_name].append(
            embedding_dict(fc.embedding_name, rows[fc.name]))
    if to_list:
        return list(chain.from_iterable(group_embedding_dict.values()))
    return group_embedding_dict


def varlen_embedding_lookup(X, embedding_dict, feature_index,
                            varlen_sparse_feature_columns, rows=None):
    """[B, maxlen, E] sequences per varlen feature: ``{name: tensor}``.

    ``rows`` as for :func:`embedding_lookup`."""
    if len(varlen_sparse_feature_columns) == 0:
        return {}
    if rows is None:
        rows = embedding_dict.gather(X, feature_index,
                                     varlen_sparse_feature_columns)
    return {fc.name: embedding_dict(fc.embedding_name, rows[fc.name])
            for fc in varlen_sparse_feature_columns}


def get_varlen_pooling_list(embedding_vec_dict, X, feature_index,
                            varlen_sparse_feature_columns):
    """Masked-pool each varlen sequence to [B, 1, E], masking by
    ``ids != 0`` or by the feature's length column."""
    pooled = []
    for feat in varlen_sparse_feature_columns:
        seq_emb = embedding_vec_dict[feat.name]
        if feat.length_name is None:
            mask = sparse_ids(X, feature_index[feat.name]) != 0    # [B,T]
            emb = masked_pooling([seq_emb, mask], feat.combiner,
                                 supports_masking=True)
        else:
            length = X[:, feature_index[feat.length_name][0]:
                       feature_index[feat.length_name][1]]
            emb = masked_pooling([seq_emb, length], feat.combiner,
                                 supports_masking=False)
        pooled.append(emb)
    return pooled


def get_dense_input(X, feature_index, feature_columns):
    """Slice dense columns to a list of [B, d] float tensors."""
    dense_feature_columns = [f for f in feature_columns
                             if isinstance(f, DenseFeat)]
    return [X[:, feature_index[fc.name][0]:feature_index[fc.name][1]]
            for fc in dense_feature_columns]


def combined_dnn_input(sparse_embedding_list, dense_value_list):
    """Flatten+concat sparse embeddings and dense values to the [B, D] DNN
    input."""
    if len(sparse_embedding_list) > 0 and len(dense_value_list) > 0:
        sparse_dnn_input = torch.cat(sparse_embedding_list, dim=-1).reshape(
            sparse_embedding_list[0].shape[0], -1)
        dense_dnn_input = torch.cat(dense_value_list, dim=-1).reshape(
            dense_value_list[0].shape[0], -1)
        return concat_fun([sparse_dnn_input,
                           dense_dnn_input.to(sparse_dnn_input.dtype)])
    elif len(sparse_embedding_list) > 0:
        return torch.cat(sparse_embedding_list, dim=-1).reshape(
            sparse_embedding_list[0].shape[0], -1)
    elif len(dense_value_list) > 0:
        return torch.cat(dense_value_list, dim=-1).reshape(
            dense_value_list[0].shape[0], -1)
    raise NotImplementedError


def maxlen_lookup(X, feature_index, maxlen_column):
    """The behaviour-length column (DIN/DIEN) as int32 [B, 1], truncating
    as :func:`sparse_ids` does."""
    if maxlen_column is None or len(maxlen_column) == 0:
        raise ValueError("please add max length column for VarLenSparseFeat "
                         "of DIN/DIEN input")
    return sparse_ids(X, feature_index[maxlen_column[0]])


def compute_input_dim(feature_columns, include_sparse=True,
                      include_dense=True, feature_group=False):
    """DNN input width implied by a feature-column list."""
    sparse_feature_columns = [f for f in feature_columns
                              if isinstance(f, (SparseFeat, VarLenSparseFeat))]
    dense_feature_columns = [f for f in feature_columns
                             if isinstance(f, DenseFeat)]
    dense_input_dim = sum(f.dimension for f in dense_feature_columns)
    if feature_group:
        sparse_input_dim = len(sparse_feature_columns)
    else:
        sparse_input_dim = sum(f.embedding_dim for f in sparse_feature_columns)
    input_dim = 0
    if include_sparse:
        input_dim += sparse_input_dim
    if include_dense:
        input_dim += dense_input_dim
    return input_dim


def embedding_size_of(feature_columns):
    """Shared embedding dim; raises if sparse features disagree."""
    sparse_feature_columns = [f for f in feature_columns
                              if isinstance(f, (SparseFeat, VarLenSparseFeat))]
    sizes = set(f.embedding_dim for f in sparse_feature_columns)
    if len(sizes) > 1:
        raise ValueError("embedding_dim of SparseFeat and VarlenSparseFeat "
                         "must be same in this model!")
    return list(sizes)[0]
