"""The port on a mesh (``deepctr_tpu_torch/parallel/``) against the JAX
package on the same mesh and against the port's one-rank run: the legs,
their data and weights, and the data-parallel ``(2, 1)`` mesh and world
size one here; the ``(1, 2)`` mesh in
``tests/test_torch_parallel_model_axis.py``, ``(2, 2)`` in
``tests/test_torch_parallel_mesh.py``; the DIEN and PLE legs on every
shape in ``tests/test_torch_parallel_seq.py``; export and ``torch.optim``
checkpoints on a mesh in ``tests/test_torch_parallel_io.py``.

The port's legs run on gloo ranks (``tests/torch_mesh_workers.py``,
spawned once for each mesh shape), every rank with the same arguments;
the JAX legs here on the same shape of the 8 virtual CPU devices.  The
legs: DeepFM under each optimizer and exchange, DIN (Dice, batch
statistics), MMOE, and ``tests/test_parallel.py``'s DIEN (AUGRU with
negative sampling, adagrad: the GRU and its auxiliary loss) and PLE
(adam, stacked expert groups, a loss list); the streamed fit
(``fit(x=callable)``) over uneven chunks, and with a ``steps_per_epoch``
cut, validation and train metrics, where every rank's history is the
same; and DIEN's pair-count witness, whose ranks hold very different
numbers of auxiliary pairs.  The explicit exchanges are held to the
port's default exchange on the same mesh (bit for bit: they look up the
same rows), as ``tests/test_parallel.py`` holds them to GSPMD, and their
rows to JAX's in ``tests/test_torch_parallel_embedding.py``.  Both start
from the same JAX weights, redrawn at std 0.3 and carried with
``load_jax_weights``.

Tolerances: sgd legs within 1e-5 of JAX (predictions) and rtol 1e-5
(epoch losses), and within 1e-6 of the port's one rank; adagrad and adam
legs within 1e-4 (``tests/test_parallel.py``'s own) over 2 epochs, where a
sum reordered over ranks can flip an early step of size about lr; at world
size 1 every leg bit for bit.  Every rank predicts the same, bit for
bit; the pair-count witness's auxiliary loss and epoch losses within
1e-5 of one process."""

import os

import jax
import numpy as np
import pytest

import deepctr_tpu as dt
from deepctr_tpu import config as dc_config
from deepctr_tpu import inputs as dc_inputs
from deepctr_tpu import models as jmodels
from deepctr_tpu.models import multitask as jmt
from deepctr_tpu.parallel import make_mesh as jax_mesh
from deepctr_tpu_torch.tools.multiprocess_sim import spawn

from tests import torch_mesh_workers as W
from tests.models.DIEN_test import get_xy_fd
from tests.utils_mtl import get_mtl_test_data

N = 128
DEEPFM = [("sparse", "c0", 64, 8), ("sparse", "c1", 32, 8),
          ("dense", "d0", 1)]
BIG = [("sparse", "big", 4096, 16), ("sparse", "small", 10, 16)]
DIN_COLS = [("sparse", "item_id", 20, 4), ("sparse", "cate_id", 7, 4),
            ("varlen", "hist_item_id", 20, 4, 5, "item_id", "seq_length"),
            ("varlen", "hist_cate_id", 7, 4, 5, "cate_id", "seq_length")]
MMOE_COLS = [("sparse", "s0", 8, 4), ("sparse", "s1", 12, 4),
             ("dense", "d0", 1)]
NO_L2 = dict(l2_reg_embedding=0, l2_reg_linear=0)
AUGRU_NEG = dict(gru_type="AUGRU", use_negsampling=True, alpha=0.8,
                 dnn_hidden_units=(8,))
CHUNKS = (50, 37, 41)       # uneven, none a multiple of the batch
WORKERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_mesh_workers.py")


def specs(cols):
    """The worker's column specs of the JAX package's feature columns."""
    out = []
    for c in cols:
        if isinstance(c, dt.VarLenSparseFeat):
            out.append(("varlen", c.name, c.vocabulary_size,
                        c.embedding_dim, c.maxlen, c.embedding_name,
                        c.length_name, c.combiner))
        elif isinstance(c, dt.SparseFeat):
            out.append(("sparse", c.name, c.vocabulary_size,
                        c.embedding_dim))
        else:
            out.append(("dense", c.name, c.dimension))
    return out


def _jax_test_data():
    """``tests/test_parallel.py``'s DIEN data (``get_xy_fd(use_neg=True)``
    tiled 8 times) and PLE data (``get_mtl_test_data(64, ...)`` at numpy
    seed 0), with their column specs; numpy's global state is left as it
    was."""
    x, y, cols, _ = get_xy_fd(use_neg=True)
    dien = ({k: np.tile(v, (8,) + (1,) * (v.ndim - 1)) for k, v in x.items()},
            np.tile(y, 8).astype(np.float64), specs(cols))
    state = np.random.get_state()
    try:
        np.random.seed(0)
        x, y, cols = get_mtl_test_data(64, sparse_feature_num=2,
                                       dense_feature_num=1)
    finally:
        np.random.set_state(state)
    return dien, (x, np.asarray(y, np.float64), specs(cols))


(_DIEN_X, _DIEN_Y, DIEN_COLS), (_PLE_X, _PLE_Y, PLE_COLS) = _jax_test_data()


def _leg(**kw):
    leg = dict(model="DeepFM", cols=DEEPFM, kw=dict(dnn_hidden_units=(8,)),
               optimizer="sgd", sparse=False, epochs=2, batch=32,
               data="deepfm", weights="deepfm", tol=1e-5)
    leg.update(kw)
    return leg


LEGS = {
    "sgd": _leg(),
    "adagrad": _leg(optimizer="adagrad", tol=1e-4),
    # the active-rows path with packed-size row-sharded tables (the JAX
    # test's lowered threshold, tests/test_parallel.py:174-201): blocks of
    # 2051 and 2045 rows at M = 2
    "sparse_adagrad": _leg(cols=BIG, kw=dict(dnn_hidden_units=(8,), **NO_L2),
                           optimizer="adagrad", sparse=True, threshold=1024,
                           data="big", weights="big", tol=1e-4),
    # adam moves every logical row of a touched packed row in the JAX
    # package: ids one pack (7 rows) apart
    "sparse_adam": _leg(cols=BIG, kw=dict(dnn_hidden_units=(8,), **NO_L2),
                        optimizer="adam", sparse=True, threshold=1024,
                        data="big_packed", weights="big", tol=1e-4),
    # adam's per-row step count (config.set_adam_t, DEEPCTR_ADAM_T) cut
    # with each table's block; a model axis alone reorders no sum, so it
    # is held at 1e-6
    "sparse_adam_rowwise": _leg(cols=BIG, kw=dict(dnn_hidden_units=(8,),
                                                  **NO_L2),
                                optimizer="adam", sparse=True,
                                threshold=1024, data="big_packed",
                                weights="big", tol=1e-6, adam_t="rowwise"),
    "psum": _leg(optimizer="adagrad", exchange=("psum", 8.0, "error"),
                 tol=1e-4, jax=False, same_as="adagrad"),
    "a2a": _leg(optimizer="adagrad", exchange=("a2a", 8.0, "error"),
                tol=1e-4, jax=False, same_as="adagrad"),
    "a2a_error": _leg(fit=False, exchange=("a2a", 1.0, "error"), batch=N,
                      data="skew"),
    "a2a_drop": _leg(fit=False, exchange=("a2a", 1.0, "drop"), batch=N,
                     data="skew"),
    "l2": _leg(kw=dict(dnn_hidden_units=(8,), l2_reg_embedding=0.05,
                       l2_reg_linear=0.05, l2_reg_dnn=0.05)),
    "din": dict(model="DIN", cols=DIN_COLS, history=["item_id", "cate_id"],
                kw=dict(dnn_hidden_units=(8,), att_hidden_size=(8, 4),
                        dnn_activation="dice", dnn_use_bn=True),
                optimizer="sgd", epochs=2, batch=16, data="din",
                weights="din", tol=1e-5),
    "mmoe": dict(model="MMOE", cols=MMOE_COLS,
                 kw=dict(num_experts=3, expert_dnn_hidden_units=(8,),
                         gate_dnn_hidden_units=(4,),
                         tower_dnn_hidden_units=(4,), dnn_use_bn=True,
                         task_names=("ctr", "cvr")),
                 optimizer="sgd", epochs=2, batch=32, data="mmoe",
                 weights="mmoe", tol=1e-5),
    # Dice in the stacked experts ([3, units] statistics, each expert's
    # from the global batch) and in the gates and towers
    "mmoe_dice": dict(model="MMOE", cols=MMOE_COLS,
                      kw=dict(num_experts=3, expert_dnn_hidden_units=(8,),
                              gate_dnn_hidden_units=(4,),
                              tower_dnn_hidden_units=(4,),
                              dnn_activation="dice",
                              task_names=("ctr", "cvr")),
                      optimizer="sgd", epochs=2, batch=32, data="mmoe",
                      weights="mmoe_dice", tol=1e-5),
    # no JAX counterpart (flax's dropout bits differ): the mesh's masks
    # against the one rank's
    "dropout": _leg(kw=dict(dnn_hidden_units=(8,), dnn_dropout=0.5),
                    jax=False),
    # tests/test_parallel.py:111-171
    "dien": dict(model="DIEN", cols=DIEN_COLS, history=["item_id", "cate_id"],
                 kw=AUGRU_NEG, optimizer="adagrad", epochs=2, batch=16,
                 data="dien", weights="dien", tol=1e-4),
    "ple": dict(model="PLE", cols=PLE_COLS,
                kw=dict(shared_expert_num=2, specific_expert_num=2,
                        num_levels=2, expert_dnn_hidden_units=(8,),
                        gate_dnn_hidden_units=(4,),
                        tower_dnn_hidden_units=(4,),
                        task_types=("binary", "binary"),
                        task_names=("a", "b")),
                optimizer="adam", epochs=2, batch=32, data="ple",
                weights="ple", tol=1e-4),
    # the pair-count witness (unshuffled: each batch's first half, short
    # histories, on data rank 0), and the same run dividing by each
    # rank's own count
    "dien_count": dict(model="DIEN", cols=DIEN_COLS,
                       history=["item_id", "cate_id"],
                       kw=dict(AUGRU_NEG, l2_reg_embedding=0),
                       optimizer="sgd", epochs=2, batch=16,
                       data="dien_count", weights="dien", tol=1e-5,
                       shuffle=False, steps=True, jax=False),
    "dien_count_local": dict(model="DIEN", cols=DIEN_COLS,
                             history=["item_id", "cate_id"],
                             kw=dict(AUGRU_NEG, l2_reg_embedding=0),
                             optimizer="sgd", epochs=2, batch=16,
                             data="dien_count", weights="dien", tol=1e-5,
                             shuffle=False, steps=True, jax=False,
                             local_count=True, witness=True),
    # the streamed fit over uneven chunks: each rank reads the whole
    # stream and trains on its rows of each global batch
    "stream_sgd": _leg(chunks=CHUNKS),
    "stream_adagrad": _leg(optimizer="adagrad", chunks=CHUNKS, tol=1e-4),
    # a steps_per_epoch cut inside the second chunk, with validation and
    # train metrics (the JAX package's reader runs ahead of a cut: no JAX)
    "stream_cap": _leg(optimizer="adagrad", chunks=(64, 64), epochs=2,
                       steps_per_epoch=3, shuffle=False, validation=(0, 32),
                       metrics=["auc"], verbose=1, tol=1e-4, jax=False),
}

# DIEN and PLE in tests/test_torch_parallel_seq.py, whose ranks run them
# on each mesh shape (their JAX models take most of a file's time)
SEQ_LEGS = ("dien", "ple", "dien_count", "dien_count_local")
MESH_LEGS = {
    (1, 1): [n for n in LEGS if n not in SEQ_LEGS],
    (2, 1): ["sgd", "adagrad", "sparse_adagrad", "l2", "din", "dropout",
             "stream_sgd", "stream_adagrad", "stream_cap", "mmoe_dice"],
    (1, 2): ["sgd", "adagrad", "sparse_adagrad", "sparse_adam", "a2a_error",
             "a2a_drop", "stream_sgd", "stream_adagrad", "stream_cap",
             "sparse_adam_rowwise"],
    (2, 2): ["sgd", "adagrad", "sparse_adagrad", "sparse_adam", "psum",
             "a2a", "a2a_error", "a2a_drop", "l2", "mmoe", "dropout"],
}


def checked(shape):
    """The legs of ``shape`` that :func:`check_leg` holds (not the
    overflow legs, not a witness's deliberate mistake)."""
    return [n for n in MESH_LEGS[shape]
            if not n.startswith("a2a_") and not LEGS[n].get("witness")]


def _data(key):
    if key == "dien":
        return _DIEN_X, _DIEN_Y
    if key == "ple":
        return _PLE_X, _PLE_Y
    rng = np.random.default_rng(7)
    if key == "dien_count":
        # the DIEN data's columns; in each batch of 16, rows 0-7 (data
        # rank 0 of two) with histories of 0-2 steps (2 auxiliary pairs
        # in all), rows 8-15 with 3-4 (2-3 pairs a row)
        n = 64
        half = np.arange(n) % 16 >= 8
        short = np.tile([0, 1, 2, 1, 0, 2, 1, 1], n // 8)
        x = {"user": rng.integers(0, 4, n), "gender": rng.integers(0, 2, n),
             "item_id": rng.integers(1, 4, n),
             "cate_id": rng.integers(1, 3, n), "pay_score": rng.random(n),
             "seq_length": np.where(half, rng.integers(3, 5, n), short)}
        for name, vocab in (("item_id", 4), ("cate_id", 3)):
            for prefix in ("hist_", "neg_hist_"):
                x[prefix + name] = rng.integers(1, vocab, (n, 4))
        return x, rng.integers(0, 2, n).astype(np.float64)
    if key in ("deepfm", "skew"):
        hi = (32, 16) if key == "skew" else (64, 32)   # skew: rank 0's ids
        x = {"c0": rng.integers(0, hi[0], N), "c1": rng.integers(0, hi[1], N),
             "d0": rng.random(N)}
        return x, rng.integers(0, 2, N).astype(np.float64)
    if key.startswith("big"):
        step = 7 if key == "big_packed" else 1
        x = {"big": rng.integers(0, 4096 // step, N) * step,
             "small": rng.integers(0, 10, N)}
        return x, rng.integers(0, 2, N).astype(np.float64)
    if key == "din":
        x = {"item_id": rng.integers(1, 20, N), "cate_id": rng.integers(1, 7, N),
             "hist_item_id": rng.integers(1, 20, (N, 5)),
             "hist_cate_id": rng.integers(1, 7, (N, 5)),
             "seq_length": rng.integers(0, 6, N)}
        return x, (x["item_id"] < 10).astype(np.float64)
    x = {"s0": rng.integers(0, 8, N), "s1": rng.integers(0, 12, N),
         "d0": rng.random(N)}
    return x, rng.integers(0, 2, (N, 2)).astype(np.float64)


DATA = {k: _data(k) for k in ("deepfm", "skew", "big", "big_packed", "din",
                              "mmoe", "dien", "ple", "dien_count")}


def _redraw(tree, rng):
    return {k: _redraw(v, rng) if isinstance(v, dict)
            else rng.normal(0, 0.3, np.shape(v)).astype(np.float32)
            for k, v in tree.items()}


def _jax_models(leg):
    return jmt if leg["model"] in W.MULTITASK else jmodels


_WEIGHTS = {}


def weights(key):
    """The JAX weights of an architecture (``deepfm``, ``big``, ``din``,
    ``mmoe``, ``dien``, ``ple``), redrawn at std 0.3; built at first
    use."""
    if key not in _WEIGHTS:
        leg = next(v for v in LEGS.values() if v["weights"] == key)
        saved = dc_inputs.PACKED_VOCAB_THRESHOLD
        try:
            dc_inputs.PACKED_VOCAB_THRESHOLD = leg.get("threshold") or saved
            m = W.make_model(dt, _jax_models(leg), leg, seed=3)
            w = m.get_weights()
        finally:
            dc_inputs.PACKED_VOCAB_THRESHOLD = saved
        w["params"] = _redraw(w["params"], np.random.default_rng(11))
        _WEIGHTS[key] = w
    return _WEIGHTS[key]
_JAX = {}


def jax_leg(name, shape):
    """The leg run by the JAX package on a mesh of ``shape``: (epoch
    losses, predictions)."""
    if (name, shape) in _JAX:
        return _JAX[name, shape]
    leg = LEGS[name]
    mesh = jax_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    saved = dc_inputs.PACKED_VOCAB_THRESHOLD
    saved_t = os.environ.get("DEEPCTR_ADAM_T")
    try:
        os.environ["DEEPCTR_ADAM_T"] = leg.get("adam_t", "table")
        if leg.get("threshold"):
            dc_inputs.PACKED_VOCAB_THRESHOLD = leg["threshold"]
        if leg.get("exchange"):
            mode, slack, overflow = leg["exchange"]
            dc_config.set_embedding_exchange(mode, mesh, a2a_slack=slack,
                                             on_overflow=overflow)
        m = W.make_model(dt, _jax_models(leg), leg, seed=3, mesh=mesh,
                         shard_embeddings=True)
        m.set_weights(weights(leg["weights"]))
        x, y = DATA[leg["data"]]
        loss = None
        if leg.get("fit", True):
            m.compile(leg["optimizer"], W.loss_of(leg),
                      metrics=leg.get("metrics"),
                      sparse_table_updates=leg.get("sparse", False))
            loss = W.fit_leg(m, leg, x, y).history["loss"]
        _JAX[name, shape] = (loss, m.predict(x, leg["batch"]))
    finally:
        dc_inputs.PACKED_VOCAB_THRESHOLD = saved
        dc_config.set_embedding_exchange("gspmd")
        if saved_t is None:
            os.environ.pop("DEEPCTR_ADAM_T")
        else:
            os.environ["DEEPCTR_ADAM_T"] = saved_t
    return _JAX[name, shape]


_ONE = {}


def one_rank(name):
    """The port's leg on one process without a mesh."""
    if name not in _ONE:
        leg = LEGS[name]
        _ONE[name] = W.run_leg(leg, *DATA[leg["data"]],
                               weights(leg["weights"]))
    return _ONE[name]


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory):
    """``{mesh shape: {leg: [rank results]}}``, each shape spawned once
    a module (a process a rank, gloo, 60 s collective timeout, 180 s for
    the run) with the legs of the module's ``MESH_LEGS`` (this module's by
    default)."""
    cache = {}
    legs_of = getattr(request.module, "MESH_LEGS", MESH_LEGS)

    def get(shape):
        if shape not in cache:
            names = legs_of[shape]
            out = spawn(WORKERS + ":run_legs",
                        shape[0] * shape[1],
                        str(tmp_path_factory.mktemp("mesh%d%d" % shape)),
                        {"mesh_shape": shape,
                         "legs": [LEGS[n] for n in names], "data": DATA,
                         "weights": {LEGS[n]["weights"]:
                                     weights(LEGS[n]["weights"])
                                     for n in names}}, timeout=180,
                        device="cpu")
            cache[shape] = {n: [r[i] for r in out]
                            for i, n in enumerate(names)}
        return cache[shape]
    return get


def check_leg(ranks, shape, name):
    """Every rank predicts alike; the leg within its tolerance of the one
    rank and of JAX on the same mesh (or bit for bit of the leg it
    names in ``same_as``)."""
    leg = LEGS[name]
    tol = leg["tol"]
    runs = ranks(shape)[name]
    one = one_rank(name)
    for r in runs[1:]:
        np.testing.assert_array_equal(r["pred"], runs[0]["pred"])
        assert r["loss"] == runs[0]["loss"]
        assert r.get("history") == runs[0].get("history")
    got = runs[0]
    assert np.all(np.isfinite(got["pred"]))
    near_one = 1e-6 if tol < 1e-4 else tol
    np.testing.assert_allclose(got["pred"], one["pred"], rtol=0,
                               atol=near_one)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=near_one)
    if leg.get("same_as"):
        other = ranks(shape)[leg["same_as"]][0]
        np.testing.assert_array_equal(got["pred"], other["pred"])
        assert got["loss"] == other["loss"]
    if leg.get("jax", True):
        jloss, jpred = jax_leg(name, shape)
        np.testing.assert_allclose(got["pred"], jpred, rtol=0, atol=tol)
        np.testing.assert_allclose(got["loss"], jloss, rtol=tol)


@pytest.mark.parametrize("name", checked((2, 1)))
def test_data_parallel_mesh_matches_jax_and_one_rank(ranks, name):
    check_leg(ranks, (2, 1), name)


def check_world_size_one(ranks, name):
    """A ``(1, 1)`` mesh with ``shard_embeddings=True`` runs the one
    rank's arithmetic: losses and predictions bit for bit."""
    got = ranks((1, 1))[name][0]
    one = one_rank(name)
    np.testing.assert_array_equal(got["pred"], one["pred"])
    assert got["loss"] == one["loss"]


@pytest.mark.parametrize("name", MESH_LEGS[(1, 1)])
def test_world_size_one_is_bit_equal(ranks, name):
    check_world_size_one(ranks, name)


def check_a2a_overflow(ranks, shape):
    """Skewed ids at slack 1.0 overflow a bucket: every prediction is NaN
    under "error"; under "drop" they are finite and JAX's (the same ids
    dropped), on every rank."""
    for r in ranks(shape)["a2a_error"]:
        assert not np.any(np.isfinite(r["pred"]))
    _, jpred = jax_leg("a2a_drop", shape)
    for r in ranks(shape)["a2a_drop"]:
        assert np.all(np.isfinite(r["pred"]))
        np.testing.assert_allclose(r["pred"], jpred, rtol=0, atol=1e-6)
    # the one rank's run drops nothing: "drop" changed the predictions
    assert not np.allclose(ranks(shape)["a2a_drop"][0]["pred"],
                           one_rank("a2a_drop")["pred"], atol=1e-6)


def check_blocks(ranks, shape):
    """Each rank keeps its block of every row-sharded table and of its
    optimizer state: the packed-size table in blocks of 2051 and 2045 rows,
    c0/c1 in halves; the blocks laid end to end are the one rank's
    trained table, within the leg's tolerance."""
    n_model = shape[1]
    for name in ("sparse_adagrad", "adagrad"):
        runs = ranks(shape)[name]
        one = one_rank(name)["local"]
        for r in runs:
            m = r["blocks"]
            assert set(m) == ({"embedding_dict/big", "embedding_dict/small"}
                              if name == "sparse_adagrad" else
                              {"embedding_dict/c0", "embedding_dict/c1"})
        model_ranks = runs[:n_model]     # data coordinate 0
        for path in runs[0]["blocks"]:
            key = "embedding_dict.tables." + path.split("/")[-1]
            parts = []
            for r in model_ranks:
                a, b = r["blocks"][path]
                assert tuple(r["local"][key].shape) == (b - a,
                                                        one[key].shape[1])
                if name == "sparse_adagrad":
                    assert r["state"][path] == [(b - a, one[key].shape[1])]
                else:
                    assert r["dense_state"][path] == [(b - a,
                                                       one[key].shape[1])]
                parts.append(r["local"][key])
            full = np.concatenate([p.numpy() for p in parts])
            np.testing.assert_allclose(full, one[key].numpy(), rtol=0,
                                       atol=LEGS[name]["tol"])
        if name == "sparse_adagrad":
            assert [r["blocks"]["embedding_dict/big"]
                    for r in model_ranks] == [(0, 2051), (2051, 4096)]


def check_l2_once(ranks, shape):
    """The L2 penalty of the replicated parameters and of the table blocks
    enters the loss and the gradient once over the ranks (at 0.05 a double
    count would move the losses far beyond 1e-6)."""
    one = one_rank("l2")
    got = ranks(shape)["l2"][0]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["pred"], one["pred"], rtol=0, atol=1e-6)
    assert one["loss"][0] > 1.01 * one_rank("sgd")["loss"][0]


def test_l2_counts_once_over_the_data_axis(ranks):
    check_l2_once(ranks, (2, 1))

