"""The mesh, and where each tensor lives on it.

Counterpart of ``deepctr_tpu/parallel/sharding.py``.  One mesh with the
dimensions ``("data", "model")`` over every rank of the process group
(``torch.distributed.device_mesh.DeviceMesh``).  The batch is split over
``data`` in contiguous rows, as ``P("data")`` lays it out: the rank at data
coordinate ``d`` of ``n`` takes rows ``[d B / n, (d + 1) B / n)`` of a
global batch of ``B``.  Every parameter is replicated, but the embedding
tables that ``shard_embeddings=True`` row-shards over ``model``: a table
under an ``embedding_dict`` whose rows, counted as the JAX package stores
them (packed, ``deepctr_tpu/inputs.py:302-313``), divide the model axis
(``_param_sharding_tree``, ``:54-67``).  Such a table keeps only its block
of logical rows on each rank, and so does its optimizer state, so that its
memory falls with the mesh as the table's does in the JAX package.  Each
logical id has the owner it has there: the block is ``stored_rows / M *
pack`` rows, with ``pack`` 1 for an unpacked table (the last block may hold
fewer, where packing padded the table).
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


AXES = ("data", "model")


def make_mesh(shape=None, axis_names=AXES, devices=None):
    """A ``DeviceMesh`` over every rank of the process group
    (``distributed.initialize`` first).  ``shape`` is ``(n_data,
    n_model)``, every rank on ``data`` by default; ``devices`` is the
    ranks' device type, ``"cuda"`` by default (raises without CUDA) or
    ``"cpu"``.  A shape that does not cover the ranks raises."""
    if tuple(axis_names) != AXES:
        raise ValueError("the mesh's dimensions are %r, got %r"
                         % (AXES, tuple(axis_names)))
    devices = "cuda" if devices is None else devices
    if devices == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass devices='cpu' for "
                           "a mesh of CPU ranks")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed."
                           "initialize() before make_mesh")
    n = dist.get_world_size()
    if shape is None:
        shape = (n, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError("mesh shape %r does not cover %d ranks"
                         % (shape, n))
    return init_device_mesh(devices, shape, mesh_dim_names=AXES)


class Axes:
    """A mesh's two axes as the engine reads them: their sizes
    ``n_data``/``n_model``, this rank's coordinates ``data``/``model`` and
    their process groups."""

    def __init__(self, mesh):
        if tuple(mesh.mesh_dim_names or ()) != AXES:
            raise ValueError("a mesh needs the dimensions %r, got %r"
                             % (AXES, mesh.mesh_dim_names))
        self.n_data, self.n_model = (int(s) for s in mesh.mesh.shape)
        self.data, self.model = (int(c) for c in mesh.get_coordinate())
        self.data_group = mesh.get_group("data")
        self.model_group = mesh.get_group("model")


def gather_data(local, ax):
    """The global ``[n * n_data, ...]`` tensor whose rows ``[data * n,
    (data + 1) * n)`` this rank holds as ``local``, on every rank of the
    ``data`` axis of ``ax`` (:class:`Axes`): one all-reduce of a
    zero-filled buffer into which each rank writes its rows.  Exact, as it
    adds zeros, and an all-reduce is what gloo takes CUDA tensors for.  A
    data axis of one rank returns ``local``."""
    if ax.n_data == 1:
        return local
    n = local.shape[0]
    out = local.new_zeros((n * ax.n_data,) + tuple(local.shape[1:]))
    out[ax.data * n:(ax.data + 1) * n] = local
    dist.all_reduce(out, group=ax.data_group)
    return out


def batch_sharding(mesh, batch_size):
    """The rows of a global batch of ``batch_size`` this rank takes, as a
    ``slice``; a batch that the data axis does not divide raises."""
    ax = Axes(mesh)
    if batch_size % ax.n_data:
        raise ValueError("global batch %d is not divisible by the %d ranks "
                         "of the mesh's data axis" % (batch_size, ax.n_data))
    per = batch_size // ax.n_data
    return slice(ax.data * per, (ax.data + 1) * per)


def replicated(mesh, rows):
    """The rows of a replicated tensor of ``rows`` rows that this rank
    holds: all of them, ``slice(0, rows)``, on a ``("data", "model")``
    mesh (another mesh raises)."""
    Axes(mesh)
    return slice(0, rows)


def table_block(n_model, index, vocab, width):
    """``(first row, stop, rows a block)``: the logical rows that rank
    ``index`` of a model axis of ``n_model`` holds of a ``[vocab, width]``
    table, and the block size that decides each id's owner (``id //
    rows a block``); None where the table is not sharded (its stored rows
    do not divide the axis)."""
    from ..inputs import stored_rows   # inputs imports this package
    rows, pack = stored_rows(vocab, width)
    if rows % n_model:
        return None
    block = rows // n_model * pack
    base = index * block
    return base, min(base + block, vocab), block


def embedding_sharding(mesh, vocab, width):
    """The logical rows of a ``[vocab, width]`` embedding table that this
    rank holds under ``shard_embeddings=True``, as a ``slice``, or None
    where the table stays replicated."""
    ax = Axes(mesh)
    block = table_block(ax.n_model, ax.model, vocab, width)
    return None if block is None else slice(block[0], block[1])


def is_embedding_path(path):
    """Whether a parameter's JAX path lies under an ``embedding_dict``."""
    return "embedding_dict" in path.split("/")


@torch.no_grad()
def shard_variables(mesh, tables):
    """Cut every shardable table of ``tables`` (``{JAX path: parameter}``,
    each at its full ``[vocab, width]``) to this rank's block, in place
    (the parameter object stays, so an optimizer built over it keeps
    it).  Returns ``{path: (first row, stop, vocab, rows a block)}`` of
    the tables cut.  A table's optimizer state (rowwise adam's per-row
    counts among it) is made afterwards at the block's rows, so it is cut
    with its table."""
    ax = Axes(mesh)
    blocks = {}
    for path, w in sorted(tables.items()):
        if not is_embedding_path(path) or w.dim() != 2:
            continue
        block = table_block(ax.n_model, ax.model, *w.shape)
        if block is None:
            continue
        base, stop, per = block
        blocks[path] = (base, stop, w.shape[0], per)
        w.data = w.data[base:stop].clone()
    return blocks
