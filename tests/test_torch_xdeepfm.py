"""The port's xDeepFM (deepctr_tpu_torch.models.xDeepFM) against the JAX
package: ``predict`` for the constructor cases of the JAX model's own
tests, at the bench's CIN layers against a JAX model whose layer 1 runs
the Pallas CIN kernel (interpret mode), ``fit`` trajectories under sgd and
adagrad with L2 on every group (the CIN's included), ``evaluate``, and
``load_jax_weights`` on a JAX xDeepFM tree.

Both packages start from the same JAX weights, redrawn (at std 0.3, the
CIN's at its own init scale, so that predictions spread), with fresh
optimizer state.  Per-step losses are read from each package's own train
step.

Tolerances.  predict: 1e-5 (float32; another order of sums).  Losses:
1e-5 relative a step under sgd, 1e-4 under adagrad, whose first step on a
weight is close to ``lr * sign(g)`` and so magnifies a gradient's rounding
where it cancels to about 0."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu import config as dc_config
from deepctr_tpu.models import xDeepFM as JxDeepFM
from deepctr_tpu.ops import pallas as P
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.models import basemodel as pt_basemodel
from deepctr_tpu_torch.models import xDeepFM as PxDeepFM
from deepctr_tpu_torch.utils.jax_weights import (jax_path, jax_to_state_dict,
                                                 load_jax_weights)

L2 = dict(l2_reg_linear=1e-3, l2_reg_embedding=2e-3, l2_reg_dnn=5e-3,
          l2_reg_cin=4e-3)


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


def _redraw(tree, rng, std=0.3):
    """Every leaf redrawn from normal(std), but the CIN's convolution
    weights [size, in] at std 1/sqrt(size), their init bound, and dense
    kernels [in, out] at most at 1/sqrt(in) (std 0.3 at the bench's widths
    would saturate every prediction)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng, std)
            continue
        shape = np.shape(v)
        s = std
        if k.startswith("conv_w"):
            s = shape[0] ** -0.5
        elif k == "kernel":
            s = min(std, shape[0] ** -0.5)
        out[k] = rng.normal(0, s, shape).astype(np.float32)
    return out


def _columns(m, n_sparse, n_dense, dim=4):
    sparse = [m.SparseFeat("s%d" % i, v, dim)
              for i, v in enumerate((7, 30, 200, 11)[:n_sparse])]
    dense = [m.DenseFeat("d%d" % i, 1) for i in range(n_dense)]
    return sparse + dense


def _data(cols, n, rng):
    x = {}
    for fc in cols:
        if isinstance(fc, (dt.SparseFeat, pt.SparseFeat)):
            x[fc.name] = rng.integers(0, fc.vocabulary_size, n)
        else:
            x[fc.name] = rng.random(n).astype(np.float32)
    return x, rng.integers(0, 2, n).astype(np.float32)


def _pair(n_sparse=3, n_dense=2, seed=0, **kw):
    """A JAX xDeepFM with redrawn weights and the port's copy of it."""
    jcols, pcols = _columns(dt, n_sparse, n_dense), _columns(pt, n_sparse,
                                                            n_dense)
    jm = JxDeepFM(jcols, jcols, **kw)
    weights = jm.get_weights()
    weights["params"] = _redraw(weights["params"],
                                np.random.default_rng(seed))
    jm.set_weights(weights)
    pm = PxDeepFM(pcols, pcols, device="cpu", **kw)
    loaded = load_jax_weights(pm, weights)
    assert set(loaded) == set(pm.state_dict())
    return jm, pm, pcols


def _record(model, index):
    losses, step = [], model._train_step

    def recorded(*args):
        out = step(*args)
        losses.append(float(out[index]))
        return out
    model._train_step = recorded
    return losses


# the constructor cases of tests/models/xDeepFM_test.py:10-13, without
# dropout: (dnn_hidden_units, cin_layer_size, cin_split_half,
# cin_activation, sparse fields, dense fields)
CASES = [((), (), True, "linear", 1, 2),
         ((8,), (), True, "linear", 1, 1),
         ((), (8,), True, "linear", 2, 2),
         ((8,), (8,), False, "relu", 2, 0)]


@pytest.mark.parametrize("case", CASES)
def test_xdeepfm_predict_matches_jax(case):
    dnn, cin, split, act, n_sparse, n_dense = case
    jm, pm, cols = _pair(n_sparse, n_dense, dnn_hidden_units=dnn,
                         cin_layer_size=cin, cin_split_half=split,
                         cin_activation=act, dnn_dropout=0)
    assert pm.use_cin == bool(cin) and pm.use_dnn == bool(dnn)
    x, _ = _data(cols, 200, np.random.default_rng(1))
    want = jm.predict(x, batch_size=64)
    got = pm.predict(x, batch_size=64)
    assert got.shape == want.shape == (200, 1)
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_xdeepfm_at_the_bench_layers_matches_the_pallas_cin():
    """cin_layer_size=(256, 128), split_half: layer 1 (H = 128) is a shape
    the JAX package's gate sends to its Pallas kernel, here in interpret
    mode at batches of 64; layer 0 (H = 4 fields) runs its einsum."""
    jm, pm, cols = _pair(4, 2, seed=2, dnn_hidden_units=(16,),
                         cin_layer_size=(256, 128))
    x, _ = _data(cols, 128, np.random.default_rng(3))
    calls = []
    real = P.cin_mix

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)
    dc_config.set_use_pallas(True)          # restored by the conftest
    P.cin_mix = spy
    try:
        with pltpu.force_tpu_interpret_mode():
            want = jm.predict(x, batch_size=64)
    finally:
        P.cin_mix = real
    assert [s[2] for s in calls] == [128]
    got = pm.predict(x, batch_size=64)
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("opt, rtol", [("sgd", 1e-5), ("adagrad", 1e-4)])
def test_xdeepfm_fit_trajectory_matches_jax(opt, rtol):
    """20 steps (4 epochs of 300 samples at B=64, the last batch of each
    padded), L2 on the embeddings, the linear part, the DNN and the CIN;
    then ``evaluate``."""
    jm, pm, cols = _pair(dnn_hidden_units=(16, 8), cin_layer_size=(8, 6),
                         **L2)
    x, y = _data(cols, 300, np.random.default_rng(4))
    metrics = ["binary_crossentropy", "auc", "acc"]
    for m in (jm, pm):
        m.compile(opt, "binary_crossentropy", metrics=metrics)
    assert jm._sparse_specs == [] and pm._sparse_specs == []
    assert pm.get_regularization_loss() == pytest.approx(
        jm.get_regularization_loss(), rel=1e-6)
    jm._ensure_compiled()
    jl, pl = _record(jm, 5), _record(pm, 1)
    hj = jm.fit(x, y, batch_size=64, epochs=4, verbose=0)
    hp = pm.fit(x, y, batch_size=64, epochs=4, verbose=0)
    assert len(jl) == len(pl) == 20
    np.testing.assert_allclose(pl, jl, rtol=rtol)
    np.testing.assert_allclose(hp.history["loss"], hj.history["loss"],
                               rtol=rtol)
    np.testing.assert_allclose(pm.predict(x, 64), jm.predict(x, 64),
                               rtol=0, atol=1e-5 if opt == "sgd" else 1e-4)
    want = jax_to_state_dict(jm.get_weights(), {
        k: tuple(v.shape) for k, v in pm.state_dict().items()})
    got = pm.get_weights()
    for k in ("cin.conv_w_0", "cin.conv_w_1", "cin.conv_b_1",
              "cin_linear.weight"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 if opt == "sgd" else 1e-3,
                                   err_msg=k)
    ej, ep = jm.evaluate(x, y, 64), pm.evaluate(x, y, 64)
    assert set(ep) == set(ej) == set(metrics)
    for k in ej:
        assert ep[k] == pytest.approx(ej[k], rel=rtol, abs=1e-6)


def test_load_jax_weights_maps_every_xdeepfm_leaf():
    """A JAX xDeepFM tree loads with no leaf left over and no weight left
    unfilled; the CIN's leaves keep their layout, cin_linear's kernel is
    transposed, and jax_path gives back the JAX leaf of every weight."""
    jcols, pcols = _columns(dt, 3, 2), _columns(pt, 3, 2)
    kw = dict(dnn_hidden_units=(8,), cin_layer_size=(6, 4))
    params = JxDeepFM(jcols, jcols, **kw).get_weights()["params"]
    pm = PxDeepFM(pcols, pcols, device="cpu", **kw)
    state = load_jax_weights(pm, {"params": params})
    assert set(state) == set(pm.state_dict())
    for i in range(2):
        np.testing.assert_array_equal(state["cin.conv_w_%d" % i],
                                      params["cin"]["conv_w_%d" % i])
        np.testing.assert_array_equal(state["cin.conv_b_%d" % i],
                                      params["cin"]["conv_b_%d" % i])
    np.testing.assert_array_equal(state["cin_linear.weight"],
                                  params["cin_linear"]["kernel"].T)
    assert state["cin_linear.weight"].shape == (1, 3 + 4)
    leaves = {"/".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {jax_path(k) for k in pm.state_dict()} == leaves
    x, _ = _data(pcols, 16, np.random.default_rng(6))
    before = pm.predict(x)
    pm.set_weights(pm.get_weights())
    np.testing.assert_array_equal(pm.predict(x), before)


def test_xdeepfm_options_and_device_rules(monkeypatch):
    cols = _columns(pt, 3, 1)
    # dropout is ported (tests/test_torch_dropout.py)
    assert PxDeepFM(cols, cols, dnn_dropout=0.5, device="cpu")._has_dropout()
    with pytest.raises(ValueError):   # sharding needs a mesh
        PxDeepFM(cols, cols, shard_embeddings=True, device="cpu")
    with pytest.raises(ValueError):
        PxDeepFM(cols, cols, cin_layer_size=(5, 4), device="cpu")
    model = PxDeepFM(cols, cols, cin_layer_size=(6, 5), device="cpu")
    assert model.cin.field_nums == [3, 3, 5]
    assert model.cin.featuremap_num == 8
    assert model.cin_linear.weight.shape == (1, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PxDeepFM(cols, cols)
    assert pt_basemodel.resolve_device("cpu") == torch.device("cpu")
