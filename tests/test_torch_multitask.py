"""The port's multi-task models, SharedBottom, ESMM, MMOE and PLE
(``deepctr_tpu_torch.models.multitask``), against the JAX package's:
``predict`` ([N, n_tasks]) for every constructor case of
``tests/models/multitask/*_test.py`` (on ``tests/utils_mtl.py:
get_mtl_test_data``'s layout from a numpy seed; the cases' dropout is
kept, and is the identity at inference), ``load_jax_weights`` on each
model's tree (the stacked experts' [K, in, out] kernels and [K, units]
batch statistics kept as they are), and the checks that raise.
``tests/test_torch_multitask_train.py`` holds their training and
``evaluate``, ``tests/test_torch_multitask_loops.py`` the device loop.

Both packages start from the same JAX weights, redrawn at std 0.3 (0.5 for
the experts' models, whose towers mix narrow experts), so that predictions
spread.  Tolerance: predict within 1e-5 (float32; another order of
sums)."""

import jax
import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu.models import multitask as jmt
from deepctr_tpu_torch.models import multitask as pmt
from deepctr_tpu_torch.utils.jax_weights import jax_path, load_jax_weights
from tests.test_torch_zoo import redraw
from tests.test_torch_zoo import _restore_port_config  # noqa: F401

NAMES = ("SharedBottom", "ESMM", "MMOE", "PLE")


def mtl_data(n_sparse, n_dense, n, seed, task_types=("binary", "binary"),
             sequence=("sum", "mean", "max")):
    """``get_mtl_test_data``'s layout from a numpy seed: sparse fields of
    1-9 rows, dense fields, pooled sequences of 2-10 rows and maxlen 1-9,
    and one label column a task (binary, or uniform in [0, 1) for a
    regression).  Returns (JAX columns, port columns, x, y [n, tasks])."""
    rng = np.random.default_rng(seed)
    specs, x = [], {}
    for i in range(n_sparse):
        name, dim = "sparse_feature_%d" % i, int(rng.integers(1, 10))
        specs.append(("sparse", name, dim))
        x[name] = rng.integers(0, dim, n)
    for i in range(n_dense):
        name = "dense_feature_%d" % i
        specs.append(("dense", name, 1))
        x[name] = rng.random(n).astype(np.float32)
    for mode in sequence:
        name = "sequence_" + mode
        dim, maxlen = int(rng.integers(1, 10)), int(rng.integers(1, 10))
        specs.append(("varlen", name, (dim + 1, maxlen, mode)))
        x[name] = rng.integers(0, dim, (n, maxlen))
    cols = {}
    for m in (dt, pt):
        cols[m] = [
            m.SparseFeat(name, arg, 4) if kind == "sparse" else
            m.DenseFeat(name, 1) if kind == "dense" else
            m.VarLenSparseFeat(m.SparseFeat(name, arg[0], 4), maxlen=arg[1],
                               combiner=arg[2])
            for kind, name, arg in specs]
    y = np.stack([rng.integers(0, 2, n) if t == "binary" else rng.random(n)
                  for t in task_types], axis=-1).astype(np.float32)
    return cols[dt], cols[pt], x, y


STD = {"MMOE": 0.5, "PLE": 0.5}


def pair(name, jcols, pcols, seed=0, **kw):
    """A JAX model with redrawn weights and the port's copy of it."""
    jm = getattr(jmt, name)(jcols, **kw)
    pm = getattr(pmt, name)(pcols, device="cpu", **kw)
    weights = jm.get_weights()
    weights["params"] = redraw(weights["params"],
                               np.random.default_rng(seed),
                               STD.get(name, 0.3))
    jm.set_weights(weights)
    loaded = load_jax_weights(pm, weights)
    assert set(loaded) == set(pm.state_dict())
    return jm, pm


BB, BR = ("binary", "binary"), ("binary", "regression")
# every constructor case of tests/models/multitask/*_test.py: (model,
# sparse features, dense features, task types, constructor arguments)
CASES = (
    [("SharedBottom", 2, 2, t, dict(bottom_dnn_hidden_units=(8,),
                                    tower_dnn_hidden_units=(8,),
                                    dnn_dropout=0.5))
     for t in (BB, BR)]
    + [("SharedBottom", 2, 1, BB, dict(bottom_dnn_hidden_units=(8,),
                                       tower_dnn_hidden_units=()))]
    + [("ESMM", 2, 2, BB, dict(tower_dnn_hidden_units=(8,),
                               dnn_dropout=0.5,
                               task_names=("ctr", "ctcvr")))]
    + [("MMOE", 3, 3, t, dict(num_experts=3, expert_dnn_hidden_units=(16, 8),
                              gate_dnn_hidden_units=g,
                              tower_dnn_hidden_units=tw, dnn_dropout=0.5))
       for g, tw, t in (((8,), (8,), BB), ((), (8,), BB), ((8,), (), BB),
                        ((), (), BB), ((8,), (8,), BR))]
    + [("PLE", 2, 2, t, dict(num_levels=lv, specific_expert_num=s,
                             shared_expert_num=h, expert_dnn_hidden_units=(8,),
                             gate_dnn_hidden_units=g,
                             tower_dnn_hidden_units=(8,), dnn_dropout=0.5))
       for lv, s, h, g, t in ((1, 1, 1, (), BB), (2, 2, 1, (8,), BR))])


def case_ids(cases):
    return ["%s-%d" % (c[0], i) for i, c in enumerate(cases)]


@pytest.mark.parametrize("i", range(len(CASES)), ids=case_ids(CASES))
def test_multitask_predict_matches_jax(i):
    name, n_sparse, n_dense, task_types, kw = CASES[i]
    if name != "ESMM":
        kw = dict(kw, task_types=task_types, task_names=("t1", "t2"))
    jcols, pcols, x, _ = mtl_data(n_sparse, n_dense, 200, seed=i,
                                  task_types=task_types)
    jm, pm = pair(name, jcols, pcols, **kw)
    want = jm.predict(x, batch_size=64)
    got = pm.predict(x, batch_size=64)
    assert got.shape == want.shape == (200, 2)
    assert want.std(axis=0).min() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# one case of each model with every leaf it has: batch norms everywhere
LEAF_CASES = {
    "SharedBottom": dict(bottom_dnn_hidden_units=(8, 4),
                         tower_dnn_hidden_units=(4,), dnn_use_bn=True),
    "ESMM": dict(tower_dnn_hidden_units=(8, 4), dnn_use_bn=True),
    "MMOE": dict(num_experts=3, expert_dnn_hidden_units=(8, 4),
                 gate_dnn_hidden_units=(4,), tower_dnn_hidden_units=(4,),
                 dnn_use_bn=True),
    "PLE": dict(num_levels=2, specific_expert_num=2, shared_expert_num=1,
                expert_dnn_hidden_units=(8,), gate_dnn_hidden_units=(4,),
                tower_dnn_hidden_units=(4,), dnn_use_bn=True),
}


@pytest.mark.parametrize("name", NAMES)
def test_load_jax_weights_maps_every_multitask_leaf(name):
    """A JAX tree with its batch statistics loads with no leaf left over
    and no weight left unfilled; a stacked expert's [K, in, out] kernel,
    [K, out] bias and [K, units] statistics keep their layout, a ``Dense``
    kernel is transposed; jax_path gives back the JAX leaf of every
    parameter; the port has no shared head where the JAX model has none
    (ESMM's ``out`` is its one head for both towers)."""
    jcols, pcols, x, _ = mtl_data(2, 2, 16, seed=7)
    jm = getattr(jmt, name)(jcols, **LEAF_CASES[name])
    pm = getattr(pmt, name)(pcols, device="cpu", **LEAF_CASES[name])
    weights = jm.get_weights()
    state = load_jax_weights(pm, weights)
    assert set(state) == set(pm.state_dict())
    leaves = {}
    for group in ("params", "batch_stats"):
        leaves.update({"/".join(str(k.key) for k in path): np.asarray(v)
                       for path, v in jax.tree_util.tree_flatten_with_path(
                           weights[group])[0]})
    assert {jax_path(k) for k in pm.state_dict()} == set(leaves)
    stacked = 0
    for key, value in state.items():
        leaf = leaves[jax_path(key)]
        if jax_path(key).endswith("/kernel") and leaf.ndim == 2:
            np.testing.assert_array_equal(value, leaf.T, err_msg=key)
        else:
            np.testing.assert_array_equal(value, leaf, err_msg=key)
            stacked += leaf.ndim == 3
    assert (stacked > 0) == (name in ("MMOE", "PLE"))
    assert ("out/bias" in leaves) == (name == "ESMM")
    before = pm.predict(x)
    pm.set_weights(pm.get_weights())
    np.testing.assert_array_equal(pm.predict(x), before)


@pytest.mark.parametrize("name", NAMES)
def test_multitask_constructors_raise_where_the_jax_models_do(
        name, monkeypatch):
    """Task checks (``validate_tasks``), MMOE's expert count, ESMM's two
    binary tasks; a ``mesh`` that is not a ``DeviceMesh`` and
    ``shard_embeddings`` without one raise; without ``device``
    a model asks for CUDA and raises where it is absent."""
    _, cols, _, _ = mtl_data(2, 1, 8, seed=8)
    pcls, jcls = getattr(pmt, name), getattr(jmt, name)
    jcols = mtl_data(2, 1, 8, seed=8)[0]
    bad = [dict(task_types=("binary",), task_names=("a",)),
           dict(task_types=("binary", "binary", "binary"),
                task_names=("a", "b")),
           dict(task_types=("binary", "multiclass"), task_names=("a", "b"))]
    if name == "ESMM":
        bad.append(dict(task_types=("binary", "regression"),
                        task_names=("a", "b")))
    if name == "MMOE":
        bad.append(dict(num_experts=1))
    for kw in bad:
        with pytest.raises(ValueError):
            jcls(jcols, **kw)
        with pytest.raises(ValueError):
            pcls(cols, device="cpu", **kw)
    with pytest.raises(ValueError):
        pcls([], device="cpu")
    # a mesh that is not a DeviceMesh, and sharding without a mesh
    for kw, err in (({"mesh": object()}, TypeError),
                    ({"shard_embeddings": True}, ValueError)):
        with pytest.raises(err):
            pcls(cols, device="cpu", **kw)
    model = pcls(cols, device="cpu", dnn_dropout=0.5)
    assert model._has_dropout() and model.num_tasks == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pcls(cols)


def test_stacked_experts_raise_on_activations_with_parameters():
    """Dice and PReLU are ported with the expert axis (tests/test_torch_
    param_activations.py); an activation neither package knows raises."""
    _, cols, _, _ = mtl_data(2, 1, 8, seed=9)
    for act in ("dice", "prelu"):
        model = pmt.MMOE(cols, dnn_activation=act, device="cpu")
        assert any(k.startswith("expert_dnn.%s_0." % (
            "Dice" if act == "dice" else "PReLU")) for k in model.state_dict())
    with pytest.raises(NotImplementedError, match="unknown activation"):
        pmt.MMOE(cols, dnn_activation="swish", device="cpu")
