"""The lookup exchanges of row-sharded embedding tables.

Counterpart of ``deepctr_tpu/parallel/embedding.py``.  A table sharded
over the mesh's ``model`` axis of ``M`` ranks keeps on rank ``m`` its
block of logical rows ``[m * rows_per, (m + 1) * rows_per)`` (the last
block may be shorter, ``sharding.table_block``); an id is owned by rank
``id // rows_per``.  Every rank of the axis holds the same ids, as every
device of the JAX package's ``shard_map`` holds the replicated ``P()`` ids.

* :func:`psum_lookup` - each rank gathers the rows it owns and zeros for
  the others, in one launch of the gather kernel in its shard-local mode
  (``ops/gather.py``), and one ``all_reduce`` over the axis sums them.
  The sum adds zeros to the owner's row, so the rows are exact.
* :func:`a2a_lookup` - the ids are bucketed by owner in flat order at a
  fixed capacity ``ceil(n / M) * slack`` a bucket, exchanged with
  ``all_to_all_single``, gathered by their owners (the same kernel) and
  sent back with a second ``all_to_all_single``.  An id past its bucket's
  capacity is dropped and gets a zero row; ``return_overflow=True`` also
  returns how many were dropped.  The buckets, their order and so the ids
  dropped are the JAX package's.

Both are ``torch.autograd.Function``s.  Their backward adds each
looked-up row's cotangent into the gradient of this rank's block, for the
ids it owns (``ops/scatter_add.py``), with no collective: every rank of
the axis holds the same ids and the same cotangent (its output is
replicated over the axis), so each owner already has every contribution
to its rows.  The training engine does not go through them: it looks rows
up without a graph (``psum_rows``, ``a2a_rows``) and scatters their
cotangent into the touched rows itself (``models/basemodel.py``).
"""

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.gather import gather_rows
from ..ops.scatter_add import scatter_add_rows
from .sharding import Axes


def psum_rows(X, tables, cols, bases, group, size):
    """Rows of every field in one gather launch and one all-reduce: field
    f reads column ``cols[f]`` of X [B, D] from the block ``tables[f]``
    whose first logical row is ``bases[f]`` -> [B, F, W], the same on
    every rank of ``group`` (``size`` ranks; one rank skips the
    collective)."""
    rows = gather_rows(X, tables, cols, bases)
    if size > 1:
        dist.all_reduce(rows, group=group)
    return rows


def _bucket(ids, n_ranks, rows_per, slack):
    """The a2a's buckets of the flat int64 ``ids``: each id's owner and its
    slot in the owner's bucket (ids in flat order), which fit the capacity
    ``ceil(n / M) * slack``, the ``[M, cap]`` buckets of ids (0 in empty
    slots) and ``cap``."""
    n = ids.shape[0]
    cap = int(math.ceil(n / n_ranks) * slack)
    owner = torch.clamp(torch.div(ids, rows_per, rounding_mode="floor"),
                        0, n_ranks - 1)
    onehot = F.one_hot(owner, n_ranks)
    slot = torch.cumsum(onehot, 0).gather(1, owner[:, None])[:, 0] - 1
    ok = slot < cap
    # overflow writes go to a last slot past the buckets, cut off after
    where = torch.where(ok, owner * cap + slot, n_ranks * cap)
    buckets = ids.new_zeros(n_ranks * cap + 1).scatter_(0, where, ids)
    return owner, slot, ok, buckets[:-1].view(n_ranks, cap), cap


def a2a_rows(table, ids, base, rows_per, group, size, slack, keep=None):
    """The a2a exchange of the flat int64 ``ids`` (the same on every rank
    of ``group``, ``size`` ranks) against this rank's block ``table`` of
    ``rows_per``-row blocks, first row ``base``.  Returns the rows of the
    ids at positions ``keep`` (a slice, all by default) [n, W] with zero
    rows for the dropped ids, whether each was kept, and the count of ids
    dropped over all of ``ids`` (an int64 scalar tensor)."""
    width = table.shape[1]
    owner, slot, ok, buckets, cap = _bucket(ids, size, rows_per, slack)
    recv = buckets
    if size > 1:
        recv = torch.empty_like(buckets)
        dist.all_to_all_single(recv, buckets, group=group)
    x = recv.reshape(-1, 1).to(torch.float32)
    rows = gather_rows(x, [table], [0], [base]).view(size, cap, width)
    back = rows
    if size > 1:
        back = torch.empty_like(rows)
        dist.all_to_all_single(back, rows, group=group)
    n_dropped = (~ok).sum()
    if keep is not None:
        owner, slot, ok = owner[keep], slot[keep], ok[keep]
    pick = owner * cap + torch.where(ok, slot, 0)
    out = back.view(size * cap, width).index_select(0, pick)
    return out * ok[:, None].to(out.dtype), ok, n_dropped


def _local_ids(ids, bases, sizes, keep=None):
    """Ids [B, F] as rows of their field's block (first row ``bases[f]``,
    ``sizes[f]`` rows), -1 outside it and where ``keep`` is False: the rows
    ``scatter_add_rows`` adds nothing to."""
    base = torch.tensor(bases, dtype=torch.int64, device=ids.device)
    size = torch.tensor(sizes, dtype=torch.int64, device=ids.device)
    local = ids - base
    inside = (local >= 0) & (local < size)
    if keep is not None:
        inside = inside & keep
    return torch.where(inside, local, -1)


class ShardedRows(torch.autograd.Function):
    """:func:`psum_rows` with a gradient for the blocks: the backward adds
    each ``(b, f)`` cotangent into the zero gradient of field f's block
    where it owns the id (one ``scatter_add_rows`` call)."""

    @staticmethod
    def forward(ctx, X, cols, bases, group, size, *tables):
        ctx.save_for_backward(X)
        ctx.cols, ctx.bases = list(cols), list(bases)
        ctx.shapes = [t.shape for t in tables]
        return psum_rows(X, list(tables), ctx.cols, ctx.bases, group, size)

    @staticmethod
    def backward(ctx, grad):
        (X,) = ctx.saved_tensors
        grads = [torch.zeros(s, dtype=torch.float32, device=grad.device)
                 for s in ctx.shapes]
        ids = X[:, ctx.cols].to(torch.int32).to(torch.int64)
        local = _local_ids(ids, ctx.bases, [s[0] for s in ctx.shapes])
        scatter_add_rows(grad.contiguous(), grads, local)
        return (None,) * 5 + tuple(grads)


class A2ALookup(torch.autograd.Function):
    """:func:`a2a_rows` with a gradient for the block: the backward adds
    the cotangent of each kept id it owns into the zero gradient of the
    block.  Returns ``(rows, kept, dropped count)``."""

    @staticmethod
    def forward(ctx, table, ids, base, rows_per, group, size, slack,
                keep=None):
        rows, ok, n_dropped = a2a_rows(table, ids, base, rows_per, group,
                                       size, slack, keep)
        ctx.save_for_backward(ids if keep is None else ids[keep], ok)
        ctx.base, ctx.shape = base, table.shape
        ctx.mark_non_differentiable(ok, n_dropped)
        return rows, ok, n_dropped

    @staticmethod
    def backward(ctx, grad, *_):
        ids, ok = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=torch.float32, device=grad.device)
        local = _local_ids(ids[:, None], [ctx.base], [ctx.shape[0]],
                           ok[:, None])
        scatter_add_rows(grad.contiguous()[:, None, :], [out], local)
        return (out,) + (None,) * 7


def _axis(mesh, axis, table, rows_per):
    if axis != "model":
        raise ValueError("tables are row-sharded over the 'model' axis, "
                         "got %r" % (axis,))
    ax = Axes(mesh)
    rows_per = table.shape[0] if rows_per is None else int(rows_per)
    return ax, rows_per, ax.model * rows_per


def psum_lookup(mesh, table, ids, axis="model", rows_per=None):
    """``table`` [rows, E]: this rank's block of a table row-sharded over
    ``axis`` (blocks of ``rows_per`` rows, ``rows`` by default); ``ids``
    int [...], the same on every rank of the axis.  Returns [..., E], the
    same on every rank of the axis.  Ids ride as float32 through the
    gather, exact below 2**24."""
    ax, rows_per, base = _axis(mesh, axis, table, rows_per)
    x = ids.reshape(-1, 1).to(torch.float32)
    out = ShardedRows.apply(x, [0], [base], ax.model_group, ax.n_model,
                            table)
    return out.reshape(tuple(ids.shape) + (table.shape[1],))


def a2a_lookup(mesh, table, ids, axis="model", slack=2.0,
               return_overflow=False, rows_per=None):
    """The all_to_all exchange: each id routed to its owner, gathered
    there, its row routed back.  Arguments as :func:`psum_lookup`; static
    capacity ``ceil(n / M) * slack`` a bucket, and an id past it gets a
    zero row and no gradient.  With ``return_overflow=True`` also returns
    the number of ids dropped (an int64 scalar tensor, the same on every
    rank)."""
    ax, rows_per, base = _axis(mesh, axis, table, rows_per)
    flat = ids.reshape(-1).to(torch.int64)
    out, _, n_dropped = A2ALookup.apply(table, flat, base, rows_per,
                                        ax.model_group, ax.n_model,
                                        float(slack))
    out = out.reshape(tuple(ids.shape) + (table.shape[1],))
    if return_overflow:
        return out, n_dropped
    return out
