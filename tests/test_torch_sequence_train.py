"""The port's DIN/DIEN training path (``compile``/``fit``/``evaluate`` of
deepctr_tpu_torch's ``DIN`` and ``DIEN``) against the JAX package's, from
the same weights: per-step total losses (the auxiliary term included),
final weights and running statistics.

The columns are the sequence bench's (tools/seq_train_bench.py), narrow:
user, item_id and cate_id tables at E=4, a dense field, the item and cate
histories at maxlen 6 sharing their tables (``neg_hist_*`` too for DIEN
with negative sampling).  Weights are redrawn at std 0.3 (the prediction
tower at std 1), Dice's and the batch norms' running means at std 0.3 and
variances in [0.5, 1.5).  Float32 compute: the JAX package trains
through its masked ``lax.scan`` GRU (its default) except where a test
runs it through the Pallas kernel.

Tolerances.  The two packages differ in the order of float32 sums:
per-step losses within 1e-5 relative, as tests/test_torch_train.py holds
DeepFM; sgd weights within 1e-5; adagrad's first step on a weight is
close to ``lr * sign(g)``, so a gradient that cancels to about 0 may flip
a weight by up to 2 lr a step between two correct implementations: its
weights are held at 1e-5 but for a share of 1e-3 that may differ by up
to 2 lr a step.  Running statistics within 1e-5."""

import jax
import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu.models import DIEN as JDIEN, DIN as JDIN
from deepctr_tpu.ops import pallas_gru as PG
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.models import DIEN as PDIEN, DIN as PDIN
from deepctr_tpu_torch.ops import gru as p_gru
from deepctr_tpu_torch.utils.jax_weights import (jax_batch_stats,
                                                 jax_to_state_dict,
                                                 load_jax_weights)

V_ITEM, V_CATE, V_USER, E, T = 30, 7, 11, 4, 6
N, B = 160, 64          # 3 steps an epoch, the last padded
LOSS_RTOL = 1e-5
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


def _redraw(tree, rng, std=0.3):
    """Every leaf from normal(std); a ``var`` from uniform[0.5, 1.5)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng, std)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.normal(0, std, np.shape(v)).astype(np.float32)
    return out


def _columns(m, use_neg):
    cols = [m.SparseFeat("user", V_USER, E),
            m.SparseFeat("item_id", V_ITEM, E),
            m.SparseFeat("cate_id", V_CATE, E), m.DenseFeat("pay_score", 1)]
    for prefix in ("hist_", "neg_hist_") if use_neg else ("hist_",):
        for name, vocab in (("item_id", V_ITEM), ("cate_id", V_CATE)):
            cols.append(m.VarLenSparseFeat(
                m.SparseFeat(prefix + name, vocab, E, embedding_name=name),
                maxlen=T, length_name="seq_length"))
    return cols


def _data(n, seed, min_length=0):
    """The bench's inputs; lengths over [min_length, T] (0, 1 and T among
    the first rows where min_length is 0), ids past a row's length 0 as
    the bench pads them, labels from the item and the first behaviour."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_length, T + 1, n)
    if min_length == 0:
        lengths[:3] = [0, 1, T]
    x = {"user": rng.integers(0, V_USER, n),
         "item_id": rng.integers(1, V_ITEM, n),
         "cate_id": rng.integers(1, V_CATE, n),
         "pay_score": rng.random(n).astype(np.float32),
         "seq_length": lengths}
    valid = np.arange(T)[None, :] < lengths[:, None]
    for prefix in ("hist_", "neg_hist_"):
        x[prefix + "item_id"] = np.where(valid, rng.integers(1, V_ITEM,
                                                             (n, T)), 0)
        x[prefix + "cate_id"] = np.where(valid, rng.integers(1, V_CATE,
                                                             (n, T)), 0)
    y = ((x["item_id"] + x["hist_item_id"][:, 0]) % 2).astype(np.float32)
    return x, y


def _pair(jcls, pcls, seed, use_neg=False, **kw):
    """A JAX model with redrawn weights and its port with the same ones."""
    rng = np.random.default_rng(seed)
    jm = jcls(_columns(dt, use_neg), ["item_id", "cate_id"],
              dnn_hidden_units=(8, 4), **kw)
    weights = {k: _redraw(v, rng) for k, v in jm.get_weights().items()}
    for tower in ("dnn", "dnn_linear"):
        weights["params"][tower] = _redraw(weights["params"][tower], rng, 1.0)
    jm.set_weights(weights)
    pm = pcls(_columns(pt, use_neg), ["item_id", "cate_id"],
              dnn_hidden_units=(8, 4), device="cpu", **kw)
    load_jax_weights(pm, weights)
    return jm, pm


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


def _fit_both(jm, pm, opt, x, y, epochs=2, **compile_kw):
    for m in (jm, pm):
        m.compile(opt, "binary_crossentropy", **compile_kw)
    jl, pl = _record_jax(jm), _record_port(pm)
    hj = jm.fit(x, y, batch_size=B, epochs=epochs, verbose=0)
    hp = pm.fit(x, y, batch_size=B, epochs=epochs, verbose=0)
    steps = epochs * (-(-len(y) // B))
    assert len(jl) == len(pl) == steps
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(hp.history["loss"], hj.history["loss"],
                               rtol=LOSS_RTOL)
    return steps


def _assert_weights(jm, pm, opt, steps):
    """Every weight within ATOL; for adagrad a share of at most 1e-3 may
    differ by up to 2 lr a step (the module docstring)."""
    want = jax_to_state_dict(jm.get_weights(), {
        k: tuple(v.shape) for k, v in pm.state_dict().items()})
    got = pm.get_weights()
    n_out, n_all = 0, 0
    for k in want:
        d = np.abs(want[k] - got[k])
        if opt == "sgd":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                       err_msg=k)
            continue
        assert d.max() <= 2 * pm._learning_rate * steps, (k, d.max())
        n_out += int((d > ATOL).sum())
        n_all += d.size
    assert n_out <= 1e-3 * max(n_all, 1), (n_out, n_all)


def _assert_stats(jm, pm):
    """The running statistics the fit moved, leaf by leaf."""
    want = jm.get_weights()["batch_stats"]
    got = jax_batch_stats(pm)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert leaves and len(leaves) == len(jax.tree_util.tree_leaves(got))
    for path, w in leaves:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("gru_type, min_length, kw, opt", [
    # tests/test_trajectory_parity_dien.py's settings: AUGRU, negative
    # sampling, alpha 0.8, sigmoid attention, every length >= 2
    ("AUGRU", 2, {}, "sgd"),
    ("AUGRU", 2, {}, "adagrad"),
    # lengths 0 and 1 in: empty histories and an empty auxiliary mask.
    # The DNN's batch norm (running stats to compare) trains under sgd
    # only: the gradient of a dense bias right before a batch norm is 0 up
    # to rounding, and adagrad turns its sign into a step of lr either way
    ("GRU", 0, {"use_bn": True}, "sgd"),
    ("GRU", 0, {}, "adagrad"),
    ("AGRU", 0, {}, "sgd"),
    ("AGRU", 0, {}, "adagrad"),
])
def test_dien_fit_matches_jax(gru_type, min_length, kw, opt):
    jm, pm = _pair(JDIEN, PDIEN, seed=1, use_neg=True, gru_type=gru_type,
                   use_negsampling=True, alpha=0.8, att_activation="sigmoid",
                   att_hidden_units=(6, 3), **kw)
    x, y = _data(N, seed=2, min_length=min_length)
    steps = _fit_both(jm, pm, opt, x, y)
    _assert_weights(jm, pm, opt, steps)
    if kw.get("use_bn"):
        _assert_stats(jm, pm)
    np.testing.assert_allclose(pm.predict(x, B), jm.predict(x, B), rtol=0,
                               atol=ATOL if opt == "sgd" else 1e-4)


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_din_fit_with_dice_matches_jax(opt):
    """DIN's default attention activation, Dice, trains on its batch
    statistics (padded steps and the padded tail included) and moves its
    running ones, which predict then reads."""
    jm, pm = _pair(JDIN, PDIN, seed=3, att_hidden_size=(6, 3))
    x, y = _data(N, seed=4)
    steps = _fit_both(jm, pm, opt, x, y)
    _assert_weights(jm, pm, opt, steps)
    _assert_stats(jm, pm)
    np.testing.assert_allclose(pm.predict(x, B), jm.predict(x, B), rtol=0,
                               atol=ATOL if opt == "sgd" else 1e-4)


def test_dien_fit_matches_jax_through_the_pallas_gru_kernel(monkeypatch):
    """The JAX package trains through its Pallas GRU kernels (forward with
    carries, ``_bwd_call``) in interpret mode under
    DEEPCTR_GRU_KERNEL=interpret, at B=64 (the kernel's gate)."""
    monkeypatch.setenv("DEEPCTR_GRU_KERNEL", "interpret")
    calls = []
    real = PG._bwd_call

    def spy(*args):
        calls.append(args[0][0])
        return real(*args)
    monkeypatch.setattr(PG, "_bwd_call", spy)
    jm, pm = _pair(JDIEN, PDIEN, seed=5, use_neg=True, gru_type="AUGRU",
                   use_negsampling=True, alpha=0.8, att_activation="sigmoid",
                   att_hidden_units=(6, 3))
    x, y = _data(2 * B, seed=6)
    steps = _fit_both(jm, pm, "adagrad", x, y, epochs=1)
    assert sorted(set(calls)) == ["augru", "gru"]
    _assert_weights(jm, pm, "adagrad", steps)


@pytest.mark.parametrize("kind", ["din", "dien"])
def test_sequence_fit_with_sparse_table_updates_matches_jax(kind):
    """sparse_table_updates=True: the touched rows of the tables that the
    history spans read (maxlen id columns each, shared with the query
    features) go through the active-rows path, in both packages."""
    if kind == "din":
        jm, pm = _pair(JDIN, PDIN, seed=7, att_hidden_size=(6, 3))
    else:
        jm, pm = _pair(JDIEN, PDIEN, seed=7, use_neg=True, gru_type="AUGRU",
                       use_negsampling=True, att_activation="sigmoid",
                       att_hidden_units=(6, 3))
    x, y = _data(N, seed=8)
    steps = _fit_both(jm, pm, "adagrad", x, y, sparse_table_updates=True)
    specs = {s[0]: s[1] for s in pm._sparse_specs}
    assert [s[0] for s in jm._sparse_specs] == sorted(specs)
    # the item table is read by its query column and two history spans
    # (DIEN: four)
    spans = specs["embedding_dict/item_id"]
    assert len(spans) == (2 if kind == "din" else 3)
    assert sum(e - s for s, e in spans) == 1 + T * (len(spans) - 1)
    _assert_weights(jm, pm, "adagrad", steps)


def test_evaluate_on_a_sequence_model_matches_jax():
    jm, pm = _pair(JDIEN, PDIEN, seed=9, use_neg=True, gru_type="AUGRU",
                   use_negsampling=True, att_hidden_units=(6, 3))
    x, y = _data(N, seed=10)
    metrics = ["binary_crossentropy", "auc"]
    for m in (jm, pm):
        m.compile("adagrad", "binary_crossentropy", metrics=metrics)
    want, got = jm.evaluate(x, y, B), pm.evaluate(x, y, B)
    assert set(got) == set(want) == set(metrics)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_dien_train_step_adds_the_auxiliary_loss_once():
    """The train step's total is data + regularization + alpha * aux, the
    auxiliary term cleared after the step; predict neither gathers the
    negative histories nor sets it."""
    _, pm = _pair(JDIEN, PDIEN, seed=11, use_neg=True, gru_type="AUGRU",
                  use_negsampling=True, alpha=0.8, att_hidden_units=(6, 3))
    x, y = _data(B, seed=12)
    pm.compile("sgd", "binary_crossentropy")
    seen = []
    real = pm.interest_extractor._auxiliary_loss

    def spy(*args):
        out = real(*args)
        seen.append(float(out.detach()))
        return out
    pm.interest_extractor._auxiliary_loss = spy
    X = torch.from_numpy(pm._assemble_x(x))
    yb = torch.from_numpy(y)[:, None]
    data, total, _ = pm._train_step(X, yb, torch.ones(B))
    assert len(seen) == 1 and seen[0] > 0
    reg = pm.get_regularization_loss()
    assert float(total) == pytest.approx(float(data) + 0.8 * seen[0] + reg,
                                         rel=1e-6)
    assert pm.aux_loss is None
    pm.predict(x, B)
    assert len(seen) == 1 and pm.aux_loss is None
    assert p_gru.GRU_SCAN_BWD_LAUNCHES == 0      # CPU: the plain versions
