"""The port's DeepFM training slice (``compile``/``fit``/``evaluate`` in
deepctr_tpu_torch) against the JAX package: whole trajectories on both the
active-rows (sparse) and the dense table paths, runs of the JAX package
that go through its Pallas update kernels (interpret mode), the "auto"
gate, and the engine around the step (padding, validation, callbacks,
regularization, losses, metrics).

Both packages start from the same JAX weights, redrawn at std 0.3, with
fresh optimizer state.  Per-step losses are read from each package's own
train step."""

import warnings

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu import callbacks as jcb
from deepctr_tpu import config as dc_config
from deepctr_tpu import inputs as dc_inputs
from deepctr_tpu import losses as jlosses
from deepctr_tpu.layers.utils import slice_arrays as jslice
from deepctr_tpu.models import DeepFM as JDeepFM
from deepctr_tpu.ops import pallas_update as PU
from deepctr_tpu_torch import callbacks as pcb
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch import losses as plosses
from deepctr_tpu_torch.layers.utils import slice_arrays as pslice
from deepctr_tpu_torch.models import DeepFM as PDeepFM
from deepctr_tpu_torch.models import basemodel as pbase
from deepctr_tpu_torch.utils import metrics as pmetrics
from deepctr_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                 load_jax_weights)

HIDDEN = (16, 8)
L2 = dict(l2_reg_linear=1e-3, l2_reg_embedding=2e-3, l2_reg_dnn=5e-3)


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


def _redraw(tree, rng, std=0.3):
    return {k: _redraw(v, rng, std) if isinstance(v, dict)
            else rng.normal(0, std, np.shape(v)).astype(np.float32)
            for k, v in tree.items()}


def _columns(m, big=None):
    """Fused tables of 4..1000 rows, a linear-only table (its own width-1
    table) and two dense fields; ``big`` adds fused tables of that many
    rows."""
    sparse = [m.SparseFeat("s0", 4, 8), m.SparseFeat("s1", 100, 8),
              m.SparseFeat("s2", 1000, 8), m.SparseFeat("s3", 37, 8)]
    for i, v in enumerate(big or []):
        sparse.append(m.SparseFeat("big%d" % i, v, 8))
    dense = [m.DenseFeat("d0", 1), m.DenseFeat("d1", 1)]
    linear = sparse + [m.SparseFeat("lin_only", 50, 8)] + dense
    return linear, sparse + dense


def _data(cols, n, rng, packed_from=None):
    """{name: column}, labels.  With ``packed_from``, the ids of every
    fused table of at least that many rows are multiples of the number of
    rows the JAX package packs into one 128-lane row."""
    x = {}
    for fc in cols:
        if isinstance(fc, (dt.SparseFeat, pt.SparseFeat)):
            step = 1
            if packed_from and fc.vocabulary_size >= packed_from:
                step = 128 // (fc.embedding_dim + 1)
            ids = rng.integers(0, -(-fc.vocabulary_size // step), n)
            x[fc.name] = ids * step
        else:
            x[fc.name] = rng.random(n).astype(np.float32)
    return x, rng.integers(0, 2, n).astype(np.float32)


def _pair(big=None, seed=0, **kw):
    """A JAX DeepFM with redrawn weights and the port's copy of it."""
    jlin, jdnn = _columns(dt, big)
    plin, pdnn = _columns(pt, big)
    jm = JDeepFM(jlin, jdnn, dnn_hidden_units=HIDDEN, **kw)
    weights = jm.get_weights()
    weights["params"] = _redraw(weights["params"],
                                np.random.default_rng(seed))
    jm.set_weights(weights)
    pm = PDeepFM(plin, pdnn, dnn_hidden_units=HIDDEN, device="cpu", **kw)
    load_jax_weights(pm, weights)
    return jm, pm, plin


def _record_jax(jm):
    jm._ensure_compiled()
    losses, step = [], jm._train_step

    def recorded(*args):
        out = step(*args)
        losses.append(float(out[5]))
        return out
    jm._train_step = recorded
    return losses


def _record_port(pm):
    losses, step = [], pm._train_step

    def recorded(X, y, sw):
        out = step(X, y, sw)
        losses.append(float(out[1]))
        return out
    pm._train_step = recorded
    return losses


def _port_weights_of(jm, pm):
    """The JAX model's weights as the port's state_dict, and the port's."""
    want = jax_to_state_dict(jm.get_weights(), {
        k: tuple(v.shape) for k, v in pm.state_dict().items()})
    return want, pm.get_weights()


def _assert_weights(want, got, atol, flip=None):
    """Every weight within ``atol``; with ``flip``, a share of at most
    1e-3 of them may differ by up to ``flip`` (see the adagrad note)."""
    n_out, n_all = 0, 0
    for k in want:
        d = np.abs(want[k] - got[k])
        if flip is None:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=k)
            continue
        assert d.max() <= flip, (k, d.max())
        n_out += int((d > atol).sum())
        n_all += d.size
    assert n_out <= 1e-3 * max(n_all, 1), (n_out, n_all)


# ---------------------------------------------------------------------------
# (b), (c) trajectories: sparse (active rows) and dense table updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam", "rmsprop"])
def test_fit_trajectory_matches_jax(opt, sparse):
    """50 steps (10 epochs of 300 samples at B=64: the last batch of each
    epoch padded), L2 on every group (embedding, linear, DNN) and tables
    under 131072 rows.

    Tolerances.  The two packages differ only in the order of f32 sums
    (matmuls, the gather transpose), about 1e-7 relative.  Losses are held
    at 1e-5 relative, predictions at 1e-5 (sgd) and 1e-4.  sgd weights are
    held elementwise at 1e-5.  adagrad's, rmsprop's and adam's first step
    on a weight is close to ``lr * sign(g)``, so a gradient that cancels to
    about 0 may flip a weight by up to 2 lr between two correct
    implementations: their weights are held at 1e-5 but for a share of
    1e-3 that may differ by up to 2 lr a step."""
    jm, pm, cols = _pair(**L2)
    x, y = _data(cols, 300, np.random.default_rng(1))
    jm.compile(opt, "binary_crossentropy", sparse_table_updates=sparse)
    pm.compile(opt, "binary_crossentropy", sparse_table_updates=sparse)
    assert ([s[0] for s in jm._sparse_specs]
            == [s[0] for s in pm._sparse_specs])
    assert bool(pm._sparse_specs) == sparse
    jl, pl = _record_jax(jm), _record_port(pm)
    hj = jm.fit(x, y, batch_size=64, epochs=10, verbose=0)
    hp = pm.fit(x, y, batch_size=64, epochs=10, verbose=0)
    assert len(jl) == len(pl) == 50
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(hp.history["loss"], hj.history["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(pm.predict(x, 64), jm.predict(x, 64),
                               rtol=0, atol=1e-5 if opt == "sgd" else 1e-4)
    want, got = _port_weights_of(jm, pm)
    if opt == "sgd":
        _assert_weights(want, got, atol=1e-5)
    else:
        lr = pm._learning_rate
        _assert_weights(want, got, atol=1e-5, flip=2 * lr * 50)
    assert pm.get_regularization_loss() == pytest.approx(
        jm.get_regularization_loss(), rel=1e-5)


@pytest.mark.parametrize("sparse", [True, False])
def test_fit_with_a_table_two_fields_share_matches_jax(sparse):
    """Two features read one table (``embedding_name``): its touched rows
    come from both id columns, and both fields add into its gradient in
    one scatter."""
    models = []
    for m, kw in ((dt, {}), (pt, {"device": "cpu"})):
        cols = [m.SparseFeat("a", 60, 8),
                m.SparseFeat("b", 60, 8, embedding_name="a"),
                m.SparseFeat("c", 30, 8), m.DenseFeat("d0", 1)]
        models.append((JDeepFM if m is dt else PDeepFM)(
            cols, cols, dnn_hidden_units=HIDDEN, **L2, **kw))
    jm, pm = models
    weights = jm.get_weights()
    weights["params"] = _redraw(weights["params"], np.random.default_rng(0))
    jm.set_weights(weights)
    load_jax_weights(pm, weights)
    rng = np.random.default_rng(18)
    x = {"a": rng.integers(0, 60, 200), "b": rng.integers(0, 60, 200),
         "c": rng.integers(0, 30, 200), "d0": rng.random(200)}
    y = rng.integers(0, 2, 200).astype(np.float32)
    for m in (jm, pm):
        m.compile("adagrad", "binary_crossentropy",
                  sparse_table_updates=sparse)
    spans = {s[0]: s[1] for s in pm._sparse_specs}
    assert len(spans.get("embedding_dict/a", ())) == (2 if sparse else 0)
    jl, pl = _record_jax(jm), _record_port(pm)
    jm.fit(x, y, batch_size=64, epochs=5, verbose=0)
    pm.fit(x, y, batch_size=64, epochs=5, verbose=0)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    want, got = _port_weights_of(jm, pm)
    _assert_weights(want, got, atol=1e-5, flip=2 * pm._learning_rate * 20)


def test_sparse_tables_leave_untouched_rows_and_decay_touched_ones():
    """Rows no batch touches keep their bits (lazy L2); row 0 is touched
    every step (the synthetic id), so its L2 applies even though no
    sample reads it."""
    jm, pm, cols = _pair(**L2)
    rng = np.random.default_rng(2)
    x, y = _data(cols, 128, rng)
    x["s2"] = rng.integers(500, 1000, 128)          # rows 1..499 untouched
    pm.compile("adagrad", "binary_crossentropy", sparse_table_updates=True)
    before = pm.embedding_dict.tables["s2"].detach().clone()
    pm.fit(x, y, batch_size=64, epochs=2, verbose=0)
    after = pm.embedding_dict.tables["s2"].detach()
    np.testing.assert_array_equal(after[1:500].numpy(),
                                  before[1:500].numpy())
    touched = np.zeros(1000, bool)
    touched[x["s2"]] = True
    touched[0] = True
    changed = (after != before).any(dim=1).numpy()
    np.testing.assert_array_equal(changed, touched)


# ---------------------------------------------------------------------------
# (d) JAX runs through the Pallas update kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt, mode, kernel", [
    ("sgd", "scatter", "fused_row_update"),
    ("adagrad", "scatter", "scatter_rows"),
    ("adam", "scatter", "scatter_rows"),
    ("adagrad", "fused", "fused_row_update_combined"),
    ("adagrad", "scatter_pooled", "multi_scatter_rows"),
    ("adagrad", "arena", "arena_scatter_rows"),
])
def test_fit_matches_jax_runs_through_the_pallas_update_kernels(
        monkeypatch, opt, mode, kernel):
    """The JAX package stores the two 2048-row tables (and the 1000-row
    one) packed, 14 rows of width 9 to a 128-lane row, and updates them
    with its Pallas kernels:
    ``fused_row_update`` (sgd), ``scatter_rows`` with L=2 (adagrad pairs)
    and L=3 (adam triples), and in the other update modes
    ``fused_row_update_combined``, ``multi_scatter_rows`` and
    ``arena_scatter_rows``.  L2 is off and every id of a packed table is a
    multiple of its pack, so that no packed neighbour of a touched row
    carries state (see ROADMAP.md section 3): the packed and the logical
    updates then agree.
    Tolerances as in test_fit_trajectory_matches_jax."""
    monkeypatch.setattr(dc_inputs, "PACKED_VOCAB_THRESHOLD", 512)
    monkeypatch.setenv("DEEPCTR_UPDATE_MODE", mode)
    calls = []
    real = getattr(PU, kernel)

    def spy(*args, **kw):
        calls.append(kernel)
        return real(*args, **kw)
    monkeypatch.setattr(PU, kernel, spy)
    jm, pm, cols = _pair(big=[2048, 2048], l2_reg_linear=0,
                         l2_reg_embedding=0)
    x, y = _data(cols, 128, np.random.default_rng(3), packed_from=512)
    dc_config.set_use_pallas(True)
    with pltpu.force_tpu_interpret_mode():
        jm.compile(opt, "binary_crossentropy", sparse_table_updates=True)
        packs = {s[0]: s[3] for s in jm._sparse_specs}
        assert packs["embedding_dict/big0"] == 14
        jl = _record_jax(jm)
        jm.fit(x, y, batch_size=64, epochs=2, verbose=0)
        jp = jm.predict(x, 64)
        jw = jm.get_weights()
    assert calls, "the JAX run did not reach %s" % kernel
    pm.compile(opt, "binary_crossentropy", sparse_table_updates=True)
    pl = _record_port(pm)
    pm.fit(x, y, batch_size=64, epochs=2, verbose=0)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(pm.predict(x, 64), jp, rtol=0,
                               atol=1e-5 if opt == "sgd" else 1e-4)
    want = jax_to_state_dict(jw, {k: tuple(v.shape)
                                  for k, v in pm.state_dict().items()})
    got = pm.get_weights()
    if opt == "sgd":
        _assert_weights(want, got, atol=1e-5)
    else:
        _assert_weights(want, got, atol=1e-5,
                        flip=2 * pm._learning_rate * 4)


# ---------------------------------------------------------------------------
# (e) the "auto" gate
# ---------------------------------------------------------------------------

def _gate_columns(m, vocabs, dim=1):
    return [m.SparseFeat("t%d" % i, v, dim) for i, v in enumerate(vocabs)]


@pytest.mark.parametrize("vocabs, want", [
    # 942,867 rows: under 1M, nothing goes sparse
    ([130000] * 7 + [16384, 16383, 100], []),
    # 1,072,867 rows: the tables of >= 16384 rows go sparse
    ([130000] * 8 + [16384, 16383, 100], list(range(9))),
    # 1.2M logical rows, but the JAX package packs them 14 to a row: its
    # gate counts 85,715 and the port counts as it does
    ([1200000, 20000], []),
])
def test_auto_gate_matches_jax(vocabs, want):
    jcols = _gate_columns(dt, vocabs)
    pcols = _gate_columns(pt, vocabs)
    jm = JDeepFM(jcols, jcols, dnn_hidden_units=(4,))
    pm = PDeepFM(pcols, pcols, dnn_hidden_units=(4,), device="cpu")
    jm.compile("adagrad", "binary_crossentropy")
    pm.compile("adagrad", "binary_crossentropy")
    paths = sorted("embedding_dict/t%d" % i for i in want)
    assert sorted(s[0] for s in pm._sparse_specs) == paths
    assert sorted(s[0] for s in jm._sparse_specs) == paths


def test_contested_span_stays_dense_with_a_warning():
    """A feature whose linear and deep tables differ in vocabulary is read
    by two tables from one span: both stay dense, as in the JAX
    package."""
    rng = np.random.default_rng(4)
    x = {"a": rng.integers(0, 50, 128), "d0": rng.random(128)}
    y = rng.integers(0, 2, 128).astype(np.float32)
    for m, kw in ((dt, {}), (pt, {"device": "cpu"})):
        lin = [m.SparseFeat("a", 100, 4), m.DenseFeat("d0", 1)]
        dnn = [m.SparseFeat("a", 50, 4), m.DenseFeat("d0", 1)]
        model = (JDeepFM if m is dt else PDeepFM)(
            lin, dnn, dnn_hidden_units=(8,), **kw)
        with pytest.warns(UserWarning, match="share id columns"):
            model.compile("adagrad", "binary_crossentropy",
                          sparse_table_updates=True)
        assert model._sparse_specs == []
        model.fit(x, y, batch_size=64, epochs=1, verbose=0)


def test_sparse_false_and_optimizer_objects():
    _, pm, _ = _pair()
    pm.compile("adam", "binary_crossentropy", sparse_table_updates=False)
    assert pm._sparse_specs == []
    # an optimizer object (tests/test_torch_optim_objects.py), but not its
    # class
    pm.compile(torch.optim.SGD(pm.parameters(), lr=0.1),
               "binary_crossentropy")
    assert pm._optimizer_name is None and pm._sparse_specs == []
    with pytest.raises(TypeError):
        pm.compile(torch.optim.SGD, "binary_crossentropy")
    with pytest.raises(NotImplementedError):
        pm.compile("lamb", "binary_crossentropy")


# ---------------------------------------------------------------------------
# (f) the engine around the step
# ---------------------------------------------------------------------------

def test_padded_tail_touches_the_rows_of_sample_zero(monkeypatch):
    """The last batch is padded with sample 0 at weight 0: its ids are
    touched (lazy L2, optimizer state) though they add no gradient."""
    seen = []
    real = pbase.row_update

    def spy(opt, tables, states, grads, rows, *args):
        seen.append([r.clone() for r in rows])
        return real(opt, tables, states, grads, rows, *args)
    monkeypatch.setattr(pbase, "row_update", spy)
    jm, pm, cols = _pair(**L2)
    x, y = _data(cols, 70, np.random.default_rng(5))
    x["s2"][0] = 999
    x["s2"][1:] = np.random.default_rng(6).integers(0, 999, 69)
    for m in (jm, pm):
        m.compile("sgd", "binary_crossentropy", sparse_table_updates=True)
    jm.fit(x, y, batch_size=64, epochs=1, verbose=0, shuffle=False)
    pm.fit(x, y, batch_size=64, epochs=1, verbose=0, shuffle=False)
    t = [s[0] for s in pm._sparse_specs].index("embedding_dict/s2")
    assert len(seen) == 2 and 999 in seen[1][t].tolist()
    want, got = _port_weights_of(jm, pm)
    _assert_weights(want, got, atol=1e-5)


def test_validation_split_early_stopping_and_evaluate_match_jax():
    jm, pm, cols = _pair(**L2)
    x, y = _data(cols, 400, np.random.default_rng(7))
    metrics = ["binary_crossentropy", "auc", "acc", "mse"]
    jm.compile("adagrad", "binary_crossentropy", metrics=metrics,
               sparse_table_updates=True)
    pm.compile("adagrad", "binary_crossentropy", metrics=metrics,
               sparse_table_updates=True)
    hist = {}
    for name, m, cb in (("jax", jm, jcb), ("port", pm, pcb)):
        stop = cb.EarlyStopping(monitor="val_auc", patience=1, mode="max")
        hist[name] = m.fit(x, y, batch_size=64, epochs=30, verbose=0,
                           validation_split=0.25, callbacks=[stop]).history
    assert set(hist["port"]) == set(hist["jax"]) == {
        "loss"} | {"val_" + k for k in metrics}
    assert len(hist["port"]["loss"]) == len(hist["jax"]["loss"]) < 30
    for k in hist["jax"]:
        np.testing.assert_allclose(hist["port"][k], hist["jax"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    xv = {k: v[300:] for k, v in x.items()}
    ej, ep = jm.evaluate(xv, y[300:], 64), pm.evaluate(xv, y[300:], 64)
    assert set(ep) == set(ej)
    for k in ej:
        assert ep[k] == pytest.approx(ej[k], rel=1e-4, abs=1e-6)


def test_validation_data_and_train_metrics_with_verbose():
    jm, pm, cols = _pair()
    x, y = _data(cols, 200, np.random.default_rng(8))
    xv, yv = _data(cols, 64, np.random.default_rng(9))
    for m in (jm, pm):
        m.compile("adam", "binary_crossentropy", metrics=["auc", "logloss"])
    hj = jm.fit(x, y, batch_size=64, epochs=2, verbose=2,
                validation_data=(xv, yv)).history
    hp = pm.fit(x, y, batch_size=64, epochs=2, verbose=2,
                validation_data=(xv, yv)).history
    assert set(hp) == set(hj) == {"loss", "auc", "logloss", "val_auc",
                                  "val_logloss"}
    for k in hj:
        np.testing.assert_allclose(hp[k], hj[k], rtol=1e-4, err_msg=k)


def test_early_stopping_restores_the_best_weights():
    _, pm, cols = _pair()
    x, y = _data(cols, 128, np.random.default_rng(10))
    pm.compile("adagrad", "binary_crossentropy", metrics=["auc"])
    seen = []

    class Keep(pcb.Callback):
        def on_epoch_end(self, epoch, logs=None):
            seen.append((logs["val_auc"], self.model.get_weights()))
    stop = pcb.EarlyStopping(monitor="val_auc", patience=0,
                             restore_best_weights=True)
    pm.fit(x, y, batch_size=64, epochs=20, verbose=0, validation_split=0.5,
           callbacks=[Keep(), stop])
    assert stop.stopped_epoch > 0
    best = max(range(len(seen)), key=lambda i: seen[i][0])
    for k, v in pm.get_weights().items():
        np.testing.assert_array_equal(v, seen[best][1][k])


def test_regularization_loss_and_l2_reg_dnn_match_jax():
    """The eager term by JAX path: the deep columns of fused tables at
    l2_reg_embedding, their wide column and the linear part at
    l2_reg_linear, the DNN kernels and dnn_linear at l2_reg_dnn; tables
    on the sparse path leave it."""
    jm, pm, _ = _pair(**L2)
    assert pm.get_regularization_loss() == pytest.approx(
        jm.get_regularization_loss(), rel=1e-6)
    rules = [r[0] for r in pm.regularization_rules]
    assert r"^dnn/.*(kernel|embedding)$" in rules
    assert r"^dnn_linear/kernel$" in rules
    for m in (jm, pm):
        m.add_regularization_rule(r"^dnn/dense_1/bias$", l1=0.5)
    assert pm.get_regularization_loss() == pytest.approx(
        jm.get_regularization_loss(), rel=1e-6)
    full = pm.get_regularization_loss()
    for m in (jm, pm):
        m.compile("sgd", "binary_crossentropy", sparse_table_updates=True)
    assert pm.get_regularization_loss() == pytest.approx(
        jm.get_regularization_loss(), rel=1e-6)
    assert pm.get_regularization_loss() < full
    _, pm0, _ = _pair(l2_reg_dnn=0)
    assert not any(r[0].startswith("^dnn") for r in pm0.regularization_rules)


def test_a_rule_added_after_compile_applies_to_the_next_fit():
    """Rules are read at the first fit after compile, as the JAX package
    builds its train step then: a lazy L2 on a sparse table added after
    compile changes its rows, and the two packages still agree."""
    tables = {}
    for rule in (True, False):
        jm, pm, cols = _pair()
        x, y = _data(cols, 128, np.random.default_rng(17))
        for m in (jm, pm):
            m.compile("sgd", "binary_crossentropy", sparse_table_updates=True)
            if rule:
                m.add_regularization_rule(r"^embedding_dict/s1$", l2=0.5)
            m.fit(x, y, batch_size=64, epochs=2, verbose=0)
        want, got = _port_weights_of(jm, pm)
        _assert_weights(want, got, atol=1e-5)
        tables[rule] = got["embedding_dict.tables.s1"]
    assert np.abs(tables[True] - tables[False]).max() > 1e-3


@pytest.mark.parametrize("loss", [
    "binary_crossentropy", "mse", "mae",
    lambda yp, yt: (yp - yt) ** 2,                           # per sample
    lambda yp, yt, sw: ((yp - yt) ** 2 * sw).sum() * 0.5,    # native
])
def test_losses_match_jax(loss):
    rng = np.random.default_rng(11)
    yp = rng.random(64).astype(np.float32)
    yp[:3] = [0.0, 1.0, 1e-9]                   # clipped before the log
    yt = rng.integers(0, 2, 64).astype(np.float32)
    sw = (rng.random(64) > 0.2).astype(np.float32)
    want = float(jlosses.resolve_loss(loss)(yp, yt, sw))
    got = float(plosses.resolve_loss(loss)(
        torch.from_numpy(yp), torch.from_numpy(yt), torch.from_numpy(sw)))
    assert got == pytest.approx(want, rel=1e-6)


def test_reduction_style_custom_loss_is_masked():
    def bce(yp, yt, reduction="sum"):
        out = torch.nn.functional.binary_cross_entropy(
            yp, yt, reduction=reduction)
        return out
    fn = plosses.resolve_loss(bce)
    yp = torch.tensor([0.2, 0.7, 0.9])
    yt = torch.tensor([0.0, 1.0, 1.0])
    sw = torch.tensor([1.0, 1.0, 0.0])
    want = bce(yp[:2], yt[:2], reduction="sum")
    assert float(fn(yp, yt, sw)) == pytest.approx(float(want), rel=1e-6)
    assert plosses.resolve_loss(None) is None
    assert len(plosses.resolve_loss(["mse", "mae"])) == 2
    with pytest.raises(NotImplementedError):
        plosses.resolve_loss("hinge")


def test_metrics_match_sklearn_and_the_jax_package():
    from deepctr_tpu.utils import metrics as jmetrics
    rng = np.random.default_rng(12)
    y = rng.integers(0, 2, 500)
    p = np.round(rng.random(500), 2)             # many ties
    for name in ("auc", "binary_crossentropy", "logloss", "mse", "acc"):
        want = jmetrics.resolve_metrics([name])[name](y, p)
        got = pmetrics.resolve_metrics([name])[name](y, p)
        assert got == pytest.approx(want, rel=1e-12), name
    # one class: the JAX package's sklearn warns and returns NaN, and so
    # does the port
    p4 = rng.random(4)
    with pytest.warns(Warning):
        want = jmetrics.roc_auc_score(np.ones(4), p4)
    with pytest.warns(UserWarning, match="one class"):
        got = pmetrics.roc_auc_score(np.ones(4), p4)
    assert np.isnan(want) and np.isnan(got)


@pytest.mark.parametrize("args", [
    (np.arange(10), 2, 5), ([np.arange(10), np.ones((10, 2))], 3, None),
    ([np.arange(10)], 0, 4), (np.arange(10), [1, 3], None), (None, 1, 2),
])
def test_slice_arrays_matches_jax(args):
    want = jslice(*args)
    got = pslice(*args)
    if isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(got, want)


def test_unported_fit_options_raise():
    _, pm, cols = _pair()
    x, y = _data(cols, 32, np.random.default_rng(13))
    with pytest.raises(RuntimeError, match="compile"):
        pm.fit(x, y, verbose=0)
    pm.compile("sgd", "binary_crossentropy")
    # profile, ModelCheckpoint and the streamed fit are ported
    # (tests/test_torch_optim_objects.py, tests/test_torch_checkpoint.py,
    # tests/test_torch_streaming_fit.py): an empty stream trains nothing,
    # and steps_per_epoch is read only with a callable x, as in the JAX
    # package
    before = pm.get_weights()
    h = pm.fit(lambda: iter(()), verbose=0)
    assert h.history["loss"] == [0.0]
    for k, v in pm.get_weights().items():
        np.testing.assert_array_equal(v, before[k])
    pm.fit(x, y, steps_per_epoch=2, verbose=0)
    # an option the port does not take raises
    with pytest.raises(NotImplementedError):
        pm.compile("adamw", "binary_crossentropy")
    assert pcb.ModelCheckpoint("w.pt").filepath == "w.pt"


def test_set_weights_after_compile_restarts_the_optimizer():
    jm, pm, cols = _pair()
    x, y = _data(cols, 64, np.random.default_rng(14))
    pm.compile("adam", "binary_crossentropy", sparse_table_updates=True)
    start = pm.get_weights()
    pm.fit(x, y, batch_size=64, epochs=1, verbose=0)
    once = pm.get_weights()
    pm.set_weights(start)
    assert pm._dense_opt.count == 0 and set(pm._table_t.values()) == {0}
    pm.fit(x, y, batch_size=64, epochs=1, verbose=0)
    for k, v in pm.get_weights().items():
        np.testing.assert_array_equal(v, once[k])


def test_a_history_spans_fits_and_records_epochs():
    _, pm, cols = _pair()
    x, y = _data(cols, 64, np.random.default_rng(15))
    pm.compile("sgd", "binary_crossentropy")
    pm.fit(x, y, batch_size=32, epochs=2, verbose=0)
    h = pm.fit(x, y, batch_size=32, epochs=3, initial_epoch=2, verbose=0)
    assert h is pm.history and h.epoch == [0, 1, 2]
    assert len(h.history["loss"]) == 3
    assert all(np.isfinite(h.history["loss"]))


def test_bf16_compute_trains():
    pt.set_compute_dtype("bfloat16")
    _, pm, cols = _pair(**L2)
    x, y = _data(cols, 128, np.random.default_rng(16))
    pm.compile("adagrad", "binary_crossentropy", sparse_table_updates=True)
    h = pm.fit(x, y, batch_size=64, epochs=3, verbose=0)
    assert all(np.isfinite(h.history["loss"]))
    assert h.history["loss"][-1] < h.history["loss"][0]
