"""The port's lookup exchanges (``deepctr_tpu_torch/parallel/
embedding.py``) against ``deepctr_tpu/parallel/embedding.py``, the
counterparts of ``tests/test_sharded_embedding.py``.

The JAX side runs here on ``M`` of the 8 virtual CPU devices
(``tests/conftest.py``), a ``(1, M)`` mesh; the port's on ``M`` gloo ranks
of a ``(1, M)`` mesh, spawned once for every ``M`` (each rank holds its
block of the same table).  Rows are held bit for bit; the psum gradient to
1e-6 of JAX's (another order of float adds); the a2a's dropped count and
dropped ids exactly.  The gather's shard-local mode against ``jnp.take``
plus mask on one process."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from deepctr_tpu.parallel import make_mesh
from deepctr_tpu.parallel.embedding import a2a_lookup, psum_lookup
from deepctr_tpu_torch.ops.gather import gather_rows, gather_rows_ref
from deepctr_tpu_torch.tools.multiprocess_sim import spawn

V, E, B = 64, 16, 40
WORKERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_mesh_workers.py:lookups")


def _table():
    return np.random.default_rng(0).normal(size=(V, E)).astype(np.float32)


def _cases(M):
    """(table, ids, exchange, slack) of each case, by name."""
    ids = np.random.default_rng(1).integers(0, V, B).astype(np.int64)
    skewed = (np.arange(B) % (V // M)).astype(np.int64)  # all on rank 0
    return {"psum": (_table(), ids, "psum", None),
            "psum_2d": (_table(), ids.reshape(8, 5), "psum", None),
            "a2a": (_table(), ids, "a2a", 8.0),
            "a2a_overflow": (_table(), skewed, "a2a", 1.0)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{M: {case: [rank results]}}``, each M spawned once."""
    cache = {}

    def get(M):
        if M not in cache:
            cases = _cases(M)
            out = spawn(WORKERS, M, str(tmp_path_factory.mktemp("lk%d" % M)),
                        {"cases": list(cases.values())}, timeout=120,
                        device="cpu")
            cache[M] = {name: [r[i] for r in out]
                        for i, name in enumerate(cases)}
        return cache[M]
    return get


_JAX = {}


def _jax(M, name, grad=False):
    """JAX's rows, dropped count and (with ``grad``) gradient of
    ``sum(sin(rows))`` for case ``name`` on a ``(1, M)`` mesh."""
    key = (M, name, grad)
    if key in _JAX:
        return _JAX[key]
    table, ids, kind, slack = _cases(M)[name]
    mesh = make_mesh((1, M), devices=jax.devices()[:M])
    t = jax.device_put(jnp.asarray(table),
                       NamedSharding(mesh, P("model", None)))
    i = jnp.asarray(ids, jnp.int32)

    def look(t):
        if kind == "psum":
            return psum_lookup(mesh, t, i), jnp.int32(0)
        return a2a_lookup(mesh, t, i, slack=slack, return_overflow=True)

    rows, dropped = look(t)
    g = (np.asarray(jax.grad(lambda t: jnp.sum(jnp.sin(look(t)[0])))(t))
         if grad else None)
    _JAX[key] = (np.asarray(rows), int(dropped), g)
    return _JAX[key]


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", ["psum", "psum_2d", "a2a"])
def test_exchange_values_are_jax_bits(ranks, M, name):
    """Every rank's rows are JAX's, bit for bit, in the ids' shape."""
    want, _, _ = _jax(M, name)
    for r in ranks(M)[name]:
        assert r["rows"].shape == want.shape
        np.testing.assert_array_equal(r["rows"], want)


@pytest.mark.parametrize("M", [2, 4])
def test_psum_gradient_matches_jax(ranks, M):
    """The blocks' gradients of ``sum(sin(rows))``, laid end to end, are
    JAX's gradient of the sharded table (and ``jnp.take``'s)."""
    _, _, want = _jax(M, "psum", grad=True)
    got = np.concatenate([r["grad"] for r in ranks(M)["psum"]])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M", [2, 4])
def test_a2a_counts_no_drop_with_room(ranks, M):
    assert [r["dropped"] for r in ranks(M)["a2a"]] == [0] * M


@pytest.mark.parametrize("M", [2, 4])
def test_a2a_overflow_drops_jax_ids(ranks, M):
    """Skewed ids at slack 1.0: the dropped count is JAX's, the dropped
    ids get zero rows where JAX's do, every other row is exact, and a
    dropped id adds nothing to its row's gradient (held to the numpy sum
    of the kept ids' ``cos``)."""
    case = _cases(M)["a2a_overflow"]
    rows, dropped, _ = _jax(M, "a2a_overflow")
    assert dropped > 0
    for r in ranks(M)["a2a_overflow"]:
        assert r["dropped"] == dropped
        np.testing.assert_array_equal(r["rows"], rows)
        zero = ~r["rows"].any(axis=1)
        assert zero.sum() == dropped
    kept = np.ones(B, bool)
    kept[~rows.any(axis=1)] = False
    table, ids = case[0], case[1]
    want = np.zeros_like(table)
    np.add.at(want, ids[kept], np.cos(table[ids[kept]]))
    got = np.concatenate([r["grad"] for r in ranks(M)["a2a_overflow"]])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("width", [1, 8, 17])
def test_gather_zero_fill_is_take_plus_mask(width):
    """The gather's shard-local mode (``bases``): field f reads id -
    base_f of its block, and a row of zeros outside it: JAX's ``jnp.take``
    of the clipped local id times the in-range mask
    (``deepctr_tpu/parallel/embedding.py:50-55``), bit for bit, both
    through the wrapper (the op's CPU version) and its plain version."""
    rng = np.random.default_rng(width)
    full = rng.normal(size=(40, width)).astype(np.float32)
    blocks = [(0, 10), (10, 25), (25, 40)]
    X = rng.integers(-3, 43, (33, 3)).astype(np.float32)
    tables = [torch.from_numpy(full[a:b]) for a, b in blocks]
    bases = [a for a, _ in blocks]
    got = gather_rows(torch.from_numpy(X), tables, [0, 1, 2], bases)
    np.testing.assert_array_equal(
        got.numpy(), gather_rows_ref(torch.from_numpy(X), tables, [0, 1, 2],
                                     bases).numpy())
    for f, (a, b) in enumerate(blocks):
        local = jnp.asarray(X[:, f], jnp.int32) - a
        ok = (local >= 0) & (local < b - a)
        want = jnp.take(jnp.asarray(full[a:b]),
                        jnp.clip(local, 0, b - a - 1), axis=0)
        want = want * ok[:, None].astype(want.dtype)
        np.testing.assert_array_equal(got[:, f].numpy(), np.asarray(want))


def test_gather_zero_fill_takes_no_table_gradient():
    """The shard-local mode has no gradient of its own: the exchanges'
    functions carry it; a grad-enabled call with a table that needs one
    raises instead of dropping it."""
    t = torch.zeros(4, 2, requires_grad=True)
    with pytest.raises(ValueError, match="shard-local"):
        gather_rows(torch.zeros(3, 1), [t], [0], [0])
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(3, 1), [t.detach()], [0], [0, 1])


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rmsprop", "adam"])
def test_shard_local_update_is_the_whole_tables_update(optimizer):
    """``row_update`` of each rank's blocks (25 rows cut 13 + 12, and a
    table left whole) at the touched rows ``parallel.update.
    shard_local_rows`` maps to them, with the same global touched rows and
    gradients on every rank, gives the blocks of the update of the whole
    tables, bit for bit, state included; padding past the table and other
    ranks' rows are dropped."""
    from deepctr_tpu_torch.ops.row_update import MODES, row_update
    from deepctr_tpu_torch.parallel.update import shard_local_rows
    rng = np.random.default_rng(3)
    V, W, n_state = 25, 6, MODES[optimizer][1]

    def fresh():
        r = np.random.default_rng(4)
        return ([torch.from_numpy(r.normal(size=(V, W)).astype(np.float32)),
                 torch.from_numpy(r.normal(size=(9, W)).astype(np.float32))],
                [tuple(torch.from_numpy(r.random((n, W)).astype(np.float32))
                       for _ in range(n_state)) for n in (V, 9)])
    rows = [torch.tensor([0, 3, 11, 12, 13, 20, 24, V, V + 1]),
            torch.tensor([0, 2, 5, 9, 10])]
    grads = [torch.from_numpy(rng.normal(size=(len(r), W))
                              .astype(np.float32)) for r in rows]
    l2s = [torch.full((W,), 0.01), torch.zeros(W)]
    bias = [torch.tensor([0.1, 0.001])] * 2 if optimizer == "adam" else None
    tables, states = fresh()
    row_update(optimizer, tables, states, grads, rows, l2s, 0.05, bias)
    for base, stop in ((0, 13), (13, 25)):
        t, st = fresh()
        blocks = [t[0][base:stop].clone(), t[1]]
        bstates = [tuple(a[base:stop].clone() for a in st[0]), st[1]]
        local = [shard_local_rows(rows[0], (base, stop, V, 13)),
                 shard_local_rows(rows[1], None)]
        row_update(optimizer, blocks, bstates, grads, local, l2s, 0.05,
                   bias)
        assert torch.equal(blocks[0], tables[0][base:stop])
        assert torch.equal(blocks[1], tables[1])
        for a, b in zip(bstates[0], states[0]):
            assert torch.equal(a, b[base:stop])
