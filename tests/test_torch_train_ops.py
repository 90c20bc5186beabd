"""The port's training kernels' plain versions against the JAX package's
math: ``scatter_add_rows`` (``deepctr_tpu_torch/ops/scatter_add.py``, the
gather's backward) against ``pallas_gather._gather_bwd`` and the JAX
gather's custom VJP, and ``row_update`` (``ops/row_update.py``) against
``pallas_update.fused_row_update`` (interpret mode), the golden ``_ref`` of
``tests/ops/test_row_update.py`` and the rmsprop and adam row math of
``deepctr_tpu/models/basemodel.py:1222-1258``.

On the CPU the wrappers run their plain versions; the CUDA kernels are held
against them on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepctr_tpu.ops import pallas_gather as PG
from deepctr_tpu.ops.pallas_update import _ROWS_PER_STEP, fused_row_update
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.ops import _build
from deepctr_tpu_torch.ops import gather as G
from deepctr_tpu_torch.ops import row_update as RU
from deepctr_tpu_torch.ops import scatter_add as SA
from tests.ops.test_row_update import _ref as golden_row_update


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


# ---------------------------------------------------------------------------
# scatter_add_rows: the gather's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [1, 9, 17])
def test_scatter_add_rows_ref_matches_jax_gather_bwd(W):
    """Dense targets, several tables, one table read by two fields, heavy
    duplicates: each table's gradient equals the JAX gather's transpose
    (``zeros.at[ids].add(g)``) up to the order of f32 sums."""
    rng = np.random.default_rng(W)
    vocabs = [3, 50, 1000]
    B = 512
    tables = [np.zeros((v, W), np.float32) for v in vocabs]
    field_table = [0, 1, 2, 1]              # fields 1 and 3 share table 1
    ids = np.stack([rng.integers(0, vocabs[t], B) for t in field_table],
                   axis=1)
    g = rng.normal(0, 1, (B, len(field_table), W)).astype(np.float32)
    want = [np.zeros_like(t) for t in tables]
    for f, t in enumerate(field_table):
        want[t] = want[t] + np.asarray(PG._gather_bwd(
            (jnp.asarray(tables[t]), jnp.asarray(ids[:, f])),
            jnp.asarray(g[:, f]))[0])
    targets = [torch.zeros(v, W) for v in vocabs]
    SA.scatter_add_rows(torch.from_numpy(g),
                        [targets[t] for t in field_table],
                        torch.from_numpy(ids.astype(np.int64)))
    for got, w in zip(targets, want):
        # up to ~680 summands a row: f32 reassociation
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=2e-5)


def test_scatter_add_rows_ref_sums_in_b_f_order_from_the_target():
    """Each row sums its contributions in (b, f) order starting from the
    value the target holds: the order the kernel keeps, so that the two
    agree bit for bit."""
    B, W = 6, 2
    ids = torch.tensor([[0, 0], [1, 0], [0, 2], [0, 0], [2, 1], [0, 0]])
    g = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1e4, (B, 2, W)).astype(np.float32))
    g[1, 1] = 1e8                          # makes the order visible
    g[3, 0] = -1e8
    start = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (3, W)).astype(np.float32))
    t = start.clone()
    SA.scatter_add_rows(g, [t, t], ids)
    want = start.numpy().copy()
    for b in range(B):
        for f in range(2):
            want[ids[b, f]] = (want[ids[b, f]] + g[b, f].numpy()).astype(
                np.float32)
    np.testing.assert_array_equal(t.numpy(), want)


def test_scatter_add_rows_slot_targets_match_jax_slice_transpose():
    """Sparse targets: the touched rows' gradient indexed by the dedup's
    slot equals the gradient JAX's active-rows step takes of the
    substituted slice (the transpose of ``take(small, slot)``)."""
    rng = np.random.default_rng(3)
    B, W, V = 256, 17, 5000
    ids = rng.integers(1, 40, (B, 2)) * 97 % V           # duplicates, no 0
    g = rng.normal(0, 1, (B, 2, W)).astype(np.float32)
    uniq, inv = np.unique(np.concatenate([[0], ids.T.reshape(-1)]),
                          return_inverse=True)
    slots = inv[1:].reshape(2, B).T
    small = jnp.zeros((len(uniq), W), jnp.float32)

    def loss(s):
        rows = jnp.take(s, jnp.asarray(slots), axis=0)       # [B, 2, W]
        return jnp.sum(rows * g)
    want = np.asarray(jax.grad(loss)(small))
    target = torch.zeros(len(uniq), W)
    SA.scatter_add_rows(torch.from_numpy(g), [target, target],
                        torch.from_numpy(slots.astype(np.int64)))
    np.testing.assert_allclose(target.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not target[0].any()              # the synthetic id 0: no reads


def test_scatter_add_rows_skips_rows_out_of_range():
    g = torch.ones(3, 1, 2)
    t = torch.zeros(4, 2)
    SA.scatter_add_rows(g, [t], torch.tensor([[1], [-1], [4]]))
    np.testing.assert_array_equal(t.numpy(), [[0, 0], [1, 1], [0, 0],
                                              [0, 0]])


def test_sort_contributions_runs_are_stable_and_per_target():
    a, b = torch.zeros(4, 1), torch.zeros(3, 1)
    rows = torch.tensor([[2, 0], [2, 7], [1, 0]])        # 7: out of b
    meta = SA.kernel_args([a, b], rows.device)
    assert meta[2:].tolist() == [4, 3, 0, 4]        # row counts, bases
    keys, order, ends = SA.sort_contributions([a, b], rows, meta)
    # a's rows at keys 0..3, b's at 4..6, the bad row past both
    assert keys.tolist() == [1, 2, 2, 4, 4, 7 + 3]
    assert order.tolist() == [4, 0, 2, 1, 5, 3]
    assert ends.tolist() == [1, 3, 3, 5, 5, 6]


def test_gather_kernel_backward_matches_the_jax_gather_vjp():
    """``gather_rows`` under autograd (``GatherRows``) gives each table the
    same gradient as the JAX gather's custom VJP (its Pallas forward in
    interpret mode), through ``scatter_add_rows``."""
    rng = np.random.default_rng(4)
    V, W, n = 300, 16, 1024
    table = rng.normal(0, 1, (V, W)).astype(np.float32)
    ids = rng.integers(0, V, n).astype(np.int32)
    g = rng.normal(0, 1, (n, W)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda t: PG.gather_rows(t, jnp.asarray(ids)),
                           jnp.asarray(table))
        want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(table).requires_grad_()
    rows = G.gather_rows(torch.from_numpy(ids.astype(np.float32)[:, None]),
                         [t], [0])
    np.testing.assert_array_equal(rows[:, 0].detach().numpy(),
                                  np.asarray(out))
    rows.backward(torch.from_numpy(g)[:, None])
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# row_update: the fused touched-row update
# ---------------------------------------------------------------------------

def _row_setup(R=1024, W=128, n=_ROWS_PER_STEP, n_valid=600, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(R, W)).astype(np.float32)
    s1 = rng.random((R, W)).astype(np.float32)
    s2 = rng.random((R, W)).astype(np.float32)
    g = rng.normal(size=(n, W)).astype(np.float32)
    valid = np.sort(rng.choice(R, n_valid, replace=False))
    rows = np.concatenate([valid, R + np.arange(n - n_valid)])
    l2 = (rng.random(W) * 0.1).astype(np.float32)
    return w, s1, s2, g, rows, l2


def _port_update(opt, w, states, g, rows, n_valid, l2, lr, bias=None):
    """``row_update`` on the first ``n_valid`` rows: the rest of ``rows``
    lies past the table (``_row_setup``'s padding), which it drops."""
    tw = torch.from_numpy(w.copy())
    ts = tuple(torch.from_numpy(s.copy()) for s in states)
    rows = rows.astype(np.int64).copy()
    rows[n_valid:] = w.shape[0] + np.arange(len(rows) - n_valid)
    RU.row_update(opt, [tw], [ts], [torch.from_numpy(g)],
                  [torch.from_numpy(rows)], [torch.from_numpy(l2)], lr,
                  None if bias is None else [torch.tensor(b) for b in bias])
    return tw.numpy(), [s.numpy() for s in ts]


def _jax_rows_math(opt, w, states, g, rows, n_valid, l2, lr, t=3):
    """The separate-leaf row update of deepctr_tpu/models/basemodel.py:
    1221-1258, in jnp, for the first n_valid rows."""
    from deepctr_tpu.models import basemodel as B
    r = jnp.asarray(rows[:n_valid])
    w_rows = jnp.asarray(w)[r]
    gp = jnp.asarray(g[:n_valid]) + 2.0 * jnp.asarray(l2)[None, :] * w_rows
    new = [np.asarray(s).copy() for s in states]
    if opt == "sgd":
        step = lr * gp
    elif opt == "adagrad":
        a = jnp.asarray(states[0])[r] + jnp.square(gp)
        step = lr * gp / (jnp.sqrt(a) + B._ADAGRAD_EPS)
        new[0][rows[:n_valid]] = np.asarray(a)
    elif opt == "rmsprop":
        a = (B._RMS_DECAY * jnp.asarray(states[0])[r]
             + (1 - B._RMS_DECAY) * jnp.square(gp))
        step = lr * gp / (jnp.sqrt(a) + B._RMS_EPS)
        new[0][rows[:n_valid]] = np.asarray(a)
    else:
        m = B._ADAM_B1 * jnp.asarray(states[0])[r] + (1 - B._ADAM_B1) * gp
        v = (B._ADAM_B2 * jnp.asarray(states[1])[r]
             + (1 - B._ADAM_B2) * jnp.square(gp))
        tf = jnp.asarray(t, jnp.float32)
        m_hat = m / (1 - B._ADAM_B1 ** tf)
        v_hat = v / (1 - B._ADAM_B2 ** tf)
        step = lr * m_hat / (jnp.sqrt(v_hat) + B._ADAM_EPS)
        new[0][rows[:n_valid]] = np.asarray(m)
        new[1][rows[:n_valid]] = np.asarray(v)
    out = np.asarray(w).copy()
    out[rows[:n_valid]] = np.asarray(w_rows - step)
    return out, new


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
@pytest.mark.parametrize("n_valid", [7, 600, _ROWS_PER_STEP])
def test_row_update_ref_matches_the_pallas_fused_row_update(opt, n_valid):
    """sgd and adagrad against ``fused_row_update`` (interpret mode) and
    the golden ``_ref``.  The Pallas kernel and the port round the same
    operations; the golden ``_ref`` puts eps inside the sqrt, hence its
    1e-5 relative tolerance, as tests/ops/test_row_update.py holds it."""
    w, s1, _, g, rows, l2 = _row_setup(n_valid=n_valid)
    lr = 0.05
    adagrad = opt == "adagrad"
    with pltpu.force_tpu_interpret_mode():
        kw, ka = fused_row_update(jnp.asarray(w),
                                  jnp.asarray(s1) if adagrad else None,
                                  jnp.asarray(g), jnp.asarray(rows, jnp.int32),
                                  n_valid, jnp.asarray(l2), lr, 1e-10)
    pw, ps = _port_update(opt, w, (s1,) if adagrad else (), g, rows,
                          n_valid, l2, lr)
    np.testing.assert_allclose(pw, np.asarray(kw), rtol=1e-6, atol=1e-7)
    gw, ga = golden_row_update(w, s1 if adagrad else None, g, rows, n_valid,
                               l2, lr, 1e-10, adagrad)
    np.testing.assert_allclose(pw, gw, rtol=1e-5, atol=1e-6)
    if adagrad:
        np.testing.assert_allclose(ps[0], np.asarray(ka), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(ps[0], ga, rtol=1e-5, atol=1e-6)
    untouched = np.setdiff1d(np.arange(w.shape[0]), rows[:n_valid])
    np.testing.assert_array_equal(pw[untouched], w[untouched])
    if adagrad:
        np.testing.assert_array_equal(ps[0][untouched], s1[untouched])


@pytest.mark.parametrize("opt", ["rmsprop", "adam"])
@pytest.mark.parametrize("n_valid", [7, 600])
def test_row_update_ref_matches_the_jax_rmsprop_and_adam_rows(opt, n_valid):
    """rmsprop and adam (the moments lazy, adam's t one scalar a table)
    against the JAX package's row math.  Same operations in the same
    order; XLA's f32 pow for adam's bias correction may differ from the
    host's by an ulp, hence rtol 1e-6."""
    w, s1, s2, g, rows, l2 = _row_setup(W=17, n_valid=n_valid, seed=5)
    states = (s1,) if opt == "rmsprop" else (s1, s2)
    lr = 0.01
    bias = [RU.adam_bias_corrections(3)] if opt == "adam" else None
    pw, ps = _port_update(opt, w, states, g, rows, n_valid, l2, lr, bias)
    jw, js = _jax_rows_math(opt, w, states, g, rows, n_valid, l2, lr, t=3)
    np.testing.assert_allclose(pw, jw, rtol=1e-6, atol=1e-7)
    for a, b in zip(ps, js):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    untouched = np.setdiff1d(np.arange(w.shape[0]), rows[:n_valid])
    np.testing.assert_array_equal(pw[untouched], w[untouched])
    for a, s in zip(ps, states):
        np.testing.assert_array_equal(a[untouched], s[untouched])


def test_row_update_covers_several_tables_of_several_widths():
    """One call updates every table; each equals the table on its own."""
    rng = np.random.default_rng(6)
    shapes = [(50, 17), (30, 1), (80, 9)]
    ws = [rng.normal(size=s).astype(np.float32) for s in shapes]
    accs = [rng.random(s).astype(np.float32) for s in shapes]
    rows = [np.sort(rng.choice(s[0], 10, replace=False)) for s in shapes]
    gs = [rng.normal(size=(10, s[1])).astype(np.float32) for s in shapes]
    l2s = [np.full(s[1], 1e-3, np.float32) for s in shapes]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    ta = [(torch.from_numpy(a.copy()),) for a in accs]
    # the second table's last 6 rows are padding past it
    padded = [r.copy() for r in rows]
    padded[1][4:] = shapes[1][0] + np.arange(6)
    RU.row_update("adagrad", tw, ta, [torch.from_numpy(g) for g in gs],
                  [torch.from_numpy(r) for r in padded],
                  [torch.from_numpy(l) for l in l2s], 0.01)
    for i in range(3):
        nv = [10, 4, 10][i]
        want, want_s = _port_update("adagrad", ws[i], (accs[i],), gs[i],
                                    rows[i], nv, l2s[i], 0.01)
        np.testing.assert_array_equal(tw[i].numpy(), want)
        np.testing.assert_array_equal(ta[i][0].numpy(), want_s[0])


def test_adam_bias_corrections_are_float32():
    bc1, bc2 = RU.adam_bias_corrections(1)
    assert bc1 == float(np.float32(1) - np.float32(0.9))
    assert bc2 == float(np.float32(1) - np.float32(0.999))


# ---------------------------------------------------------------------------
# dispatch and arguments
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_count_no_launch(
        monkeypatch):
    def no_kernel(name):
        raise AssertionError("the CPU path must not load a kernel")
    monkeypatch.setattr(_build, "load", no_kernel)
    before = (SA.SCATTER_ADD_LAUNCHES, RU.ROW_UPDATE_LAUNCHES)
    t = torch.zeros(3, 2)
    SA.scatter_add_rows(torch.ones(2, 1, 2), [t], torch.tensor([[0], [2]]))
    RU.row_update("sgd", [t], [()], [torch.ones(2, 2)],
                  [torch.tensor([0, 2])], [torch.zeros(2)], 0.1)
    assert (SA.SCATTER_ADD_LAUNCHES, RU.ROW_UPDATE_LAUNCHES) == before
    np.testing.assert_allclose(t.numpy(), [[0.9, 0.9], [0, 0], [0.9, 0.9]])


@pytest.mark.parametrize("call", [
    # grad not 3-D
    lambda: SA.scatter_add_rows(torch.zeros(2, 2), [torch.zeros(3, 2)],
                                torch.zeros(2, 1, dtype=torch.int64)),
    # one target too few
    lambda: SA.scatter_add_rows(torch.zeros(2, 2, 3), [torch.zeros(3, 3)],
                                torch.zeros(2, 2, dtype=torch.int64)),
    # rows not int64
    lambda: SA.scatter_add_rows(torch.zeros(2, 1, 3), [torch.zeros(3, 3)],
                                torch.zeros(2, 1, dtype=torch.int32)),
    # target of another width
    lambda: SA.scatter_add_rows(torch.zeros(2, 1, 3), [torch.zeros(3, 2)],
                                torch.zeros(2, 1, dtype=torch.int64)),
    # unknown optimizer
    lambda: RU.row_update("lamb", [torch.zeros(3, 2)], [()],
                          [torch.zeros(1, 2)], [torch.zeros(1,
                                                            dtype=torch.int64)],
                          [torch.zeros(2)], 0.1),
    # adagrad without its accumulator
    lambda: RU.row_update("adagrad", [torch.zeros(3, 2)], [()],
                          [torch.zeros(1, 2)], [torch.zeros(1,
                                                            dtype=torch.int64)],
                          [torch.zeros(2)], 0.1),
    # more row ids than gradient rows
    lambda: RU.row_update("sgd", [torch.zeros(3, 2)], [()],
                          [torch.zeros(1, 2)], [torch.zeros(2,
                                                            dtype=torch.int64)],
                          [torch.zeros(2)], 0.1),
    # adam without bias corrections
    lambda: RU.row_update("adam", [torch.zeros(3, 2)],
                          [(torch.zeros(3, 2), torch.zeros(3, 2))],
                          [torch.zeros(1, 2)], [torch.zeros(1,
                                                            dtype=torch.int64)],
                          [torch.zeros(2)], 0.1),
])
def test_train_kernels_reject_bad_arguments(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("name", ["scatter_add_rows", "row_update"])
def test_train_kernel_sources_build_by_hash(name):
    src, lib = _build._paths(name)
    assert src.exists() and src.parent == _build.SRC_DIR
    assert lib.name.startswith("lib%s-" % name) and lib.suffix == ".so"


# ---------------------------------------------------------------------------
# the kernels' sort and two-level order (csrc/scatter_add_rows.cu), plain
# ---------------------------------------------------------------------------

def _long_run_case(seed, B=4096, W=17):
    """A 3-row table read by every row in three fields (runs of ~4096), a
    table of 5000 rows, a slot target, and an id out of range."""
    rng = np.random.default_rng(seed)
    small, big, slots = (torch.zeros(3, W), torch.zeros(5000, W),
                         torch.zeros(700, W))
    targets = [small, big, small, slots, small]
    ids = np.stack([rng.integers(0, 3, B), rng.integers(0, 5000, B),
                    rng.integers(0, 3, B), rng.integers(0, 700, B),
                    rng.integers(0, 3, B)], axis=1)
    ids[5, 1] = 5000                               # out of range
    ids[7, 0] = -1
    g = torch.from_numpy(rng.normal(0, 1, (B, 5, W)).astype(np.float32))
    for t in (small, big, slots):
        t.copy_(torch.from_numpy(rng.normal(0, 1, t.shape).astype(
            np.float32)))
    return g, targets, torch.from_numpy(ids.astype(np.int64))


def _copies(targets):
    copies = {}
    return [copies.setdefault(t.data_ptr(), t.clone()) for t in targets]


def test_sort_keys_ref_is_sort_contributions_permutation():
    g, targets, rows = _long_run_case(0, B=300)
    meta = SA.kernel_args(targets, rows.device)
    keys, order = SA.sort_keys_ref(targets, rows, meta)
    old_keys, old_order, _ = SA.sort_contributions(targets, rows, meta)
    total = SA.total_rows(targets)
    assert total == 3 + 5000 + 700
    assert torch.equal(order, old_order)
    bad = old_keys >= total
    assert int(bad.sum()) == 2
    assert torch.equal(keys[~bad], old_keys[~bad])
    assert bool((keys[bad] == total).all())
    assert bool((keys[1:] >= keys[:-1]).all())


def test_chunk_heads_cut_runs_as_the_kernels_do():
    C = SA.CHUNK
    lengths = [1, C, C + 1, 3 * C + 5, 2, 2 * C - 1, 7 * C]
    keys = torch.cat([torch.full((n,), k) for k, n in enumerate(lengths)])
    keys = torch.cat([keys, torch.full((3,), 99)])     # rows out of range
    heads, first = SA.chunk_heads_ref(keys, 99)
    assert bool((heads[-3:] == -1).all())
    start = 0
    for n in lengths:
        h = heads[start:start + n]
        assert int(h[0]) == start and bool(first[start])
        second = (start + 2 * C - 1) // C * C
        for p in range(start, start + n):
            want = start if p < second else p // C * C
            assert int(heads[p]) == want
        chunks = torch.unique(h)
        sizes = [int((h == c).sum()) for c in chunks]
        assert max(sizes) <= 2 * C - 1
        if n <= C:
            assert len(chunks) == 1            # one chunk: index_add_ order
        start += n


def test_chunked_ref_equals_index_add_on_short_runs_and_is_close_on_long():
    """Rows with at most CHUNK contributions: bit-equal to ``index_add_``
    on the CPU (the kernels' first chunk sums in that order); longer runs
    within 1e-6 of the sum of their terms' magnitudes."""
    g, targets, rows = _long_run_case(1)
    got, want = _copies(targets), _copies(targets)
    SA.scatter_add_rows_chunked_ref(g, got, rows)
    SA.scatter_add_rows_ref(g, want, rows)
    scale = _copies([t.abs() for t in targets])
    SA.scatter_add_rows_ref(g.abs(), scale, rows)
    counts = _copies([torch.zeros(t.shape[0]) for t in targets])
    SA.scatter_add_rows_ref(torch.ones(*rows.shape, 1),
                            [c[:, None] for c in counts], rows)
    long_rows = 0
    distinct = {a.data_ptr(): q for a, q in zip(
        got, zip(got, want, scale, counts))}
    for a, b, s, c in distinct.values():
        short = c <= SA.CHUNK
        assert torch.equal(a[short], b[short])
        assert bool(((a - b).abs() <= 1e-6 * s).all())
        long_rows += int((~short).sum())
    assert long_rows == 3                   # the 3-row table's runs
    assert not torch.equal(got[0], want[0])  # two levels: another order


def test_chunked_ref_order_is_the_two_levels():
    """Row 0 takes 10 contributions (sorted positions [0, 10)), row 1 a run
    of 3 CHUNK + 5 at [10, 3 CHUNK + 15): its first chunk runs to the first
    multiple of CHUNK at least CHUNK past its start, [10, 2 CHUNK), from
    the target's value; then [2C, 3C) and [3C, 3C + 15); the chunk sums
    are added in order."""
    C = SA.CHUNK
    n = 3 * C + 5
    g = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (10 + n, 1, 2)).astype(np.float32)) * 1e4
    rows = torch.ones(10 + n, 1, dtype=torch.int64)
    rows[5:200:20] = 0                      # 10 contributions to row 0
    t0 = torch.tensor([[0.25, 1.0], [0.5, -3.0]])
    t = t0.clone()
    SA.scatter_add_rows_chunked_ref(g, [t], rows)
    v = g[rows[:, 0] == 1, 0].numpy()         # row 1's terms in (b, f) order
    acc = t0.numpy()[1].copy()
    bounds = [(10, 2 * C), (2 * C, 3 * C), (3 * C, 10 + n)]
    for i in range(bounds[0][1] - 10):
        acc = (acc + v[i]).astype(np.float32)
    for lo, hi in bounds[1:]:
        part = v[lo - 10].copy()
        for i in range(lo - 10 + 1, hi - 10):
            part = (part + v[i]).astype(np.float32)
        acc = (acc + part).astype(np.float32)
    np.testing.assert_array_equal(t.numpy()[1], acc)
    want0 = t0.numpy()[0].copy()
    for term in g[rows[:, 0] == 0, 0].numpy():
        want0 = (want0 + term).astype(np.float32)
    np.testing.assert_array_equal(t.numpy()[0], want0)


@pytest.mark.parametrize("W", [1, 17])
def test_chunked_ref_matches_jax_gather_bwd(W):
    """The kernels' order against the JAX gather's transpose
    (``zeros.at[ids].add(g)``) on dense targets with runs of ~1,365."""
    rng = np.random.default_rng(10 + W)
    vocabs = [3, 50, 1000]
    B = 4096
    field_table = [0, 1, 2, 0]
    ids = np.stack([rng.integers(0, vocabs[t], B) for t in field_table],
                   axis=1)
    g = rng.normal(0, 1, (B, len(field_table), W)).astype(np.float32)
    want = [np.zeros((v, W), np.float32) for v in vocabs]
    for f, t in enumerate(field_table):
        want[t] = want[t] + np.asarray(PG._gather_bwd(
            (jnp.zeros((vocabs[t], W), jnp.float32),
             jnp.asarray(ids[:, f])), jnp.asarray(g[:, f]))[0])
    targets = [torch.zeros(v, W) for v in vocabs]
    SA.scatter_add_rows_chunked_ref(torch.from_numpy(g),
                                    [targets[t] for t in field_table],
                                    torch.from_numpy(ids.astype(np.int64)))
    for got, w in zip(targets, want):
        # up to ~2,700 summands a row: f32 reassociation
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-4)
