"""Adam's per-row step count (``config.set_adam_t("rowwise")``) against
the JAX package's ``DEEPCTR_ADAM_T=rowwise``
(``deepctr_tpu/models/basemodel.py:520-541``, ``:1237-1250``): each
sparse-table row keeps an int32 count, advanced only on the steps that
touch it, and is corrected by its own ``(1 - b1^t, 1 - b2^t)``.

Held here: a DeepFM over sparse tables whose rows go untouched for whole
steps, three epochs against the JAX model (per-step losses, predictions,
the touched rows and their moments, and the whole ``t`` array); both
modes against dense adam when every row is touched every step (the JAX
package's own check, ``tests/test_sparse_updates.py:524-549``); the
plain version of K2 (``ops/row_update.py:row_update_ref``) against the
JAX row math, untouched rows and padding slots bit for bit; the table of
bias corrections against XLA's float32 ``pow`` for counts up to 10^5;
the kernel's argument struct; a checkpoint; an optimizer object; the
setter.

Tolerances.  The two packages differ in the order of float32 sums only;
held at 1e-6 (predictions, touched rows, moments), losses at 1e-6
relative; ``t`` exactly.  Dense against sparse adam: the JAX test's 3e-5.
"""

import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu.models import DeepFM as JDeepFM
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.models import DeepFM as PDeepFM
from deepctr_tpu_torch.ops import row_update as RU
from deepctr_tpu_torch.utils.jax_weights import load_jax_weights
from tests.test_torch_train import _record_jax, _record_port, _redraw

TOL = 1e-6
V = 600


@pytest.fixture(autouse=True)
def _restore_adam_t():
    saved = pt_config.adam_t()
    yield
    pt_config.set_adam_t(saved)


def _cols(m):
    sparse = [m.SparseFeat("big", V, 8), m.SparseFeat("mid", 90, 8),
              m.SparseFeat("small", 6, 8)]
    return sparse + [m.DenseFeat("d0", 1)]


def _xy(n=320, seed=1):
    """Batches of 64 whose ``big`` ids come from a tenth of the table a
    batch, so that most rows sit out whole steps, and ``mid`` ids that
    skip half its rows."""
    rng = np.random.default_rng(seed)
    band = (np.arange(n) // 64) % 5
    x = {"big": band * 120 + rng.integers(0, 60, n),
         "mid": 2 * rng.integers(0, 45, n), "small": rng.integers(0, 6, n),
         "d0": rng.random(n).astype(np.float32)}
    return x, rng.integers(0, 2, n).astype(np.float32)


def _pair(seed=0, **kw):
    jm = JDeepFM(_cols(dt), _cols(dt), dnn_hidden_units=(8,),
                 l2_reg_embedding=2e-3, l2_reg_linear=1e-3, **kw)
    weights = jm.get_weights()
    weights["params"] = _redraw(weights["params"],
                                np.random.default_rng(seed))
    jm.set_weights(weights)
    pm = PDeepFM(_cols(pt), _cols(pt), dnn_hidden_units=(8,),
                 l2_reg_embedding=2e-3, l2_reg_linear=1e-3, device="cpu",
                 **kw)
    load_jax_weights(pm, weights)
    return jm, pm


def test_rowwise_adam_matches_jax_with_untouched_rows(monkeypatch):
    monkeypatch.setenv("DEEPCTR_ADAM_T", "rowwise")
    pt.set_adam_t("rowwise")
    jm, pm = _pair()
    x, y = _xy()
    for m in (jm, pm):
        m.compile("adam", "binary_crossentropy", sparse_table_updates=True,
                  learning_rate=0.01)
    paths = [p for p, *_ in pm._sparse_specs]
    assert paths == [p for p, *_ in jm._sparse_specs]
    assert "embedding_dict/big" in paths
    for p in paths:
        assert jm.table_state[p]["t"].shape == (pm._tables()[p].shape[0],)
        count = pm._table_state[p][2]
        assert count.dtype == torch.int32 and not count.any()
    before = {p: pm._tables()[p].detach().clone() for p in paths}
    jl, pl = _record_jax(jm), _record_port(pm)
    jm.fit(x, y, batch_size=64, epochs=3, verbose=0)
    pm.fit(x, y, batch_size=64, epochs=3, verbose=0)
    assert len(jl) == len(pl) == 15
    np.testing.assert_allclose(pl, jl, rtol=TOL)
    np.testing.assert_allclose(pm.predict(x, 64), jm.predict(x, 64), rtol=0,
                               atol=TOL)
    jm._sync_params()
    for p in paths:
        w_port = pm._tables()[p].detach().numpy()
        w_jax = np.asarray(jm.params["embedding_dict"][p.split("/")[-1]])
        m_port, v_port, t_port = (a.numpy() for a in pm._table_state[p])
        st = jm.table_state[p]
        t_jax = np.asarray(st["t"])
        np.testing.assert_array_equal(t_port, t_jax, err_msg=p)
        touched = t_port > 0
        assert touched.any()
        # untouched rows: every bit kept, count 0
        np.testing.assert_array_equal(w_port[~touched],
                                      before[p].numpy()[~touched])
        for got, want in ((w_port, w_jax), (m_port, np.asarray(st["m"])),
                          (v_port, np.asarray(st["v"]))):
            np.testing.assert_allclose(got[touched], want[touched], rtol=0,
                                       atol=TOL, err_msg=p)
    # row 0 (the step's synthetic id) is touched every step; the others
    # sat out whole steps, so their counts differ from the step count
    t_big = pm._table_state["embedding_dict/big"][2].numpy()
    assert t_big[0] == 15
    assert 0 < t_big[1:].max() < 15 and len(set(t_big[t_big > 0])) > 2


@pytest.mark.parametrize("mode", ["table", "rowwise"])
def test_both_modes_equal_dense_adam_when_every_row_is_touched(mode):
    pt.set_adam_t(mode)
    N, n_rows = 256, 8
    rng = np.random.default_rng(0)
    x = {"c0": np.arange(N) % n_rows, "d0": rng.random(N)}
    y = ((np.arange(N) % n_rows) % 2).astype(np.float64)
    cols = [pt.SparseFeat("c0", n_rows, 4), pt.DenseFeat("d0", 1)]

    def run(sparse):
        m = PDeepFM(cols, cols, dnn_hidden_units=(8,), seed=3,
                    l2_reg_embedding=0, l2_reg_linear=0, device="cpu")
        m.compile("adam", "binary_crossentropy",
                  sparse_table_updates=sparse)
        assert len(m._table_state.get("embedding_dict/c0", ())) == (
            (3 if mode == "rowwise" else 2) if sparse else 0)
        m.fit(x, y, batch_size=64, epochs=3, verbose=0, shuffle=False)
        return m.predict(x, 64)

    np.testing.assert_allclose(run(False), run(True), atol=3e-5)


def test_set_adam_t_rejects_other_modes():
    for bad in ("bogus", "", None, "Rowwise"):
        with pytest.raises(ValueError):
            pt.set_adam_t(bad)
    assert pt.config.adam_t() == "table"
    assert pt.set_adam_t is pt.config.set_adam_t


def _ref_rows(w, m, v, t, g, rows, l2, lr):
    """The JAX package's rowwise row math (basemodel.py:1237-1250) in
    numpy float32 on the listed rows inside the table."""
    w, m, v, t = (a.copy() for a in (w, m, v, t))
    keep = rows < w.shape[0]
    r, g = rows[keep], g[keep]
    f32 = np.float32
    gp = g + f32(2) * l2[None] * w[r]
    mn = f32(0.9) * m[r] + f32(1 - 0.9) * gp
    vn = f32(0.999) * v[r] + f32(1 - 0.999) * (gp * gp)
    tn = t[r] + 1
    tf = tn.astype(f32)[:, None]
    bc1 = np.array([[RU.adam_bias_corrections(int(k))[0]] for k in tn], f32)
    bc2 = np.array([[RU.adam_bias_corrections(int(k))[1]] for k in tn], f32)
    assert (tf > 0).all()
    step = f32(lr) * (mn / bc1) / (np.sqrt(vn / bc2) + f32(1e-8))
    w[r], m[r], v[r], t[r] = w[r] - step, mn, vn, tn
    return w, m, v, t


def test_row_update_ref_rowwise_keeps_untouched_rows_and_counts():
    """Three steps of the plain version on a table of 40 rows, 9 touched
    rows a step and padding slots past the table: each touched row's
    count and moments against the JAX row math; every other row, and its
    count, bit for bit."""
    rng = np.random.default_rng(5)
    Vt, W = 40, 17
    w = rng.normal(size=(Vt, W)).astype(np.float32)
    m, v = np.zeros_like(w), np.zeros_like(w)
    t = np.zeros(Vt, np.int32)
    l2 = (rng.random(W) * 1e-3).astype(np.float32)
    tw, tm, tv, tt = (torch.from_numpy(a.copy()) for a in (w, m, v, t))
    table = torch.from_numpy(RU.bias_correction_table(8))
    for step in range(3):
        rows = np.concatenate([rng.choice(Vt // 2 + 10 * step, 9,
                                          replace=False), [Vt, Vt + 3]])
        g = rng.normal(size=(len(rows), W)).astype(np.float32)
        w, m, v, t = _ref_rows(w, m, v, t, g, rows, l2, 0.01)
        RU.row_update("adam", [tw], [(tm, tv, tt)], [torch.from_numpy(g)],
                      [torch.from_numpy(rows)], [torch.from_numpy(l2)],
                      0.01, [table])
        np.testing.assert_array_equal(tt.numpy(), t)
        for got, want in ((tw, w), (tm, m), (tv, v)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        untouched = t == 0
        np.testing.assert_array_equal(tw.numpy()[untouched], w[untouched])
    assert set(t) > {0, 1}


def test_bias_correction_table_is_xla_pow_up_to_1e5():
    """Row t is ``(1 - 0.9^t, 1 - 0.999^t)`` as the JAX package computes
    it from a float32 count, bit for bit, for every count to 10^5."""
    import jax.numpy as jnp
    n = 100_001
    tf = jnp.arange(1, n, dtype=jnp.int32).astype(jnp.float32)[:, None]
    want = np.concatenate([np.asarray(1 - 0.9 ** tf),
                           np.asarray(1 - 0.999 ** tf)], axis=1)
    got = RU.bias_correction_table(n)
    assert got.shape == (n, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got[1:], want)


def test_kernel_args_carry_the_counts_and_the_table_of_pairs():
    """Each table's struct holds its ``t`` pointer and the table of pairs
    as its bias; table mode leaves ``t`` null."""
    Vt, W = 30, 17
    tables = [torch.zeros(Vt, W), torch.zeros(Vt, W)]
    counts = [torch.zeros(Vt, dtype=torch.int32) for _ in tables]
    states = [(torch.zeros_like(w), torch.zeros_like(w), c)
              for w, c in zip(tables, counts)]
    grads = [torch.zeros(4, W) for _ in tables]
    rows = [torch.arange(4) for _ in tables]
    l2s = [torch.zeros(W) for _ in tables]
    table = torch.from_numpy(RU.bias_correction_table(16))
    (a,) = RU.kernel_args("adam", tables, states, grads, rows, l2s, 0.01,
                          [table] * 2)
    for i in range(2):
        assert (a.table[i].t, a.table[i].bias) == (counts[i].data_ptr(),
                                                   table.data_ptr())
    (a,) = RU.kernel_args("adam", tables, [s[:2] for s in states], grads,
                          rows, l2s, 0.01, [torch.ones(2)] * 2)
    assert a.table[0].t is None
    with pytest.raises(ValueError, match=r"\[T, 2\]"):
        RU.row_update("adam", tables, states, grads, rows, l2s, 0.01,
                      [torch.ones(2)] * 2)
    with pytest.raises(ValueError, match="int32"):
        RU.row_update("adam", tables, [(s[0], s[1], s[2].long())
                                       for s in states], grads, rows, l2s,
                      0.01, [table] * 2)


def _train_state(m):
    out = {k: v.clone() for k, v in m.state_dict().items()}
    for p, st in m._table_state.items():
        for j, a in enumerate(st):
            out["%s/%d" % (p, j)] = a.clone()
    return out


@pytest.mark.parametrize("device_loop", [False, True])
def test_a_rowwise_checkpoint_resumes_bit_equal_and_table_mode_refuses_it(
        tmp_path, device_loop):
    pt.set_adam_t("rowwise")
    x, y = _xy(seed=4)

    def build():
        m = PDeepFM(_cols(pt), _cols(pt), dnn_hidden_units=(8,), seed=3,
                    device="cpu")
        m.compile("adam", "binary_crossentropy", sparse_table_updates=True)
        return m

    def data(m):
        if device_loop:
            return m.assemble_device_input(x), torch.from_numpy(y)[:, None]
        return x, y
    whole = build()
    whole.fit(*data(whole), batch_size=64, epochs=2, verbose=0)
    half = build()
    half.fit(*data(half), batch_size=64, epochs=1, verbose=0)
    half.save_checkpoint(str(tmp_path / "ckpt"))
    resumed = build()
    resumed.load_checkpoint(str(tmp_path / "ckpt"))
    resumed.fit(*data(resumed), batch_size=64, epochs=2, initial_epoch=1,
                verbose=0)
    want, got = _train_state(whole), _train_state(resumed)
    assert set(want) == set(got)
    assert any(k.endswith("/2") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    pt.set_adam_t("table")
    with pytest.raises(ValueError, match="set_adam_t"):
        build().load_checkpoint(str(tmp_path / "ckpt"))


def test_an_optimizer_object_keeps_its_own_count_under_rowwise():
    """With a ``torch.optim`` optimizer no table takes the sparse path (as
    the JAX package's optax transform bypasses its table state), so the
    mode changes nothing: bit-equal runs, no counts."""
    x, y = _xy(seed=6)
    out = []
    for mode in ("table", "rowwise"):
        pt.set_adam_t(mode)
        m = PDeepFM(_cols(pt), _cols(pt), dnn_hidden_units=(8,), seed=3,
                    device="cpu")
        m.compile(torch.optim.Adam(m.parameters(), lr=0.01),
                  "binary_crossentropy")
        assert m._table_state == {}
        m.fit(x, y, batch_size=64, epochs=2, verbose=0)
        out.append(m.predict(x, 64))
    np.testing.assert_array_equal(out[0], out[1])
