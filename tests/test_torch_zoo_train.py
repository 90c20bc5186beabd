"""The port's zoo models training on host arrays against the JAX package:
``fit`` trajectories of WDL, NFM, DCN and DCNMix under sgd and adagrad
with L2 on every group the model has (embeddings, the linear part, the
DNN and the cross network), then ``predict`` and ``evaluate``.
``tests/test_torch_zoo_train_pairwise.py`` runs the same for AutoInt,
AFM, FiBiNET and PNN.

Both packages start from the same JAX weights (``tests/test_torch_zoo.py``:
redrawn at std 0.3) with fresh optimizer state.  Per-step losses are read
from each package's own train step.

Tolerances.  Losses: 1e-5 relative a step under sgd, 1e-4 under adagrad,
the regularization term at 1e-6.  Weights: 1e-5 under sgd; under adagrad
1e-5 but for a share of 1e-3 that may differ by up to 2 lr a step,
adagrad's first step on a weight being close to ``lr * sign(g)``, which
turns a gradient that cancels to about 0 into a flip of 2 lr between two
correct implementations (``tests/test_torch_train.py``).  predict after
the fit: 1e-5 (sgd), 1e-4 (adagrad)."""

import numpy as np
import pytest

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from tests.test_torch_train import (_assert_weights, _port_weights_of,
                                    _record_jax, _record_port)
from tests.test_torch_zoo import pair
from tests.test_torch_zoo import _restore_port_config  # noqa: F401

N, B, EPOCHS = 300, 64, 4
STEPS = EPOCHS * (-(-N // B))
L2 = dict(l2_reg_linear=1e-3, l2_reg_embedding=2e-3, l2_reg_dnn=5e-3)
# each model with L2 on every group it has, at small widths
FITS = {
    "WDL": dict(L2, dnn_hidden_units=(16, 8)),
    "NFM": dict(L2, dnn_hidden_units=(16, 8)),
    "DCN": dict(L2, l2_reg_cross=4e-3, dnn_hidden_units=(16, 8)),
    "DCNMix": dict(L2, l2_reg_cross=4e-3, dnn_hidden_units=(16, 8),
                   low_rank=3, num_experts=2),
    "AutoInt": dict(l2_reg_embedding=2e-3, l2_reg_dnn=5e-3,
                    dnn_hidden_units=(16, 8), att_layer_num=2),
    "AFM": dict(l2_reg_linear=1e-3, l2_reg_embedding=2e-3, l2_reg_att=4e-3,
                attention_factor=6),
    "FiBiNET": dict(L2, dnn_hidden_units=(16, 8)),
    "PNN": dict(l2_reg_embedding=2e-3, l2_reg_dnn=5e-3,
                dnn_hidden_units=(16, 8), use_outter=True),
}


def fit_columns(m, n_dense):
    sparse = [m.SparseFeat("s%d" % i, v, 4)
              for i, v in enumerate((7, 30, 200))]
    return sparse + [m.DenseFeat("d%d" % i, 1) for i in range(n_dense)]


def fit_data(cols, n, seed):
    rng = np.random.default_rng(seed)
    x = {}
    for fc in cols:
        if isinstance(fc, (dt.SparseFeat, pt.SparseFeat)):
            x[fc.name] = rng.integers(0, fc.vocabulary_size, n)
        else:
            x[fc.name] = rng.random(n).astype(np.float32)
    return x, rng.integers(0, 2, n).astype(np.float32)


def fit_pair(name, seed=0):
    """A JAX model of ``FITS[name]`` with redrawn weights, the port's copy
    and the port's columns (AFM's without dense fields)."""
    n_dense = 0 if name == "AFM" else 2
    jcols, pcols = fit_columns(dt, n_dense), fit_columns(pt, n_dense)
    jm, pm = pair(name, jcols, pcols, seed=seed, **FITS[name])
    return jm, pm, pcols


def check_fit(name, opt, rtol):
    jm, pm, cols = fit_pair(name)
    x, y = fit_data(cols, N, seed=4)
    metrics = ["binary_crossentropy", "auc", "acc"]
    for m in (jm, pm):
        m.compile(opt, "binary_crossentropy", metrics=metrics)
    assert jm._sparse_specs == [] and pm._sparse_specs == []
    assert pm.get_regularization_loss() > 0
    assert pm.get_regularization_loss() == pytest.approx(
        jm.get_regularization_loss(), rel=1e-6)
    jl, pl = _record_jax(jm), _record_port(pm)
    hj = jm.fit(x, y, batch_size=B, epochs=EPOCHS, verbose=0)
    hp = pm.fit(x, y, batch_size=B, epochs=EPOCHS, verbose=0)
    assert len(jl) == len(pl) == STEPS
    np.testing.assert_allclose(pl, jl, rtol=rtol)
    np.testing.assert_allclose(hp.history["loss"], hj.history["loss"],
                               rtol=rtol)
    np.testing.assert_allclose(pm.predict(x, B), jm.predict(x, B), rtol=0,
                               atol=1e-5 if opt == "sgd" else 1e-4)
    want, got = _port_weights_of(jm, pm)
    assert set(want) == set(got)
    if opt == "sgd":
        _assert_weights(want, got, atol=1e-5)
    else:
        _assert_weights(want, got, atol=1e-5,
                        flip=2 * pm._learning_rate * STEPS)
    assert pm.get_regularization_loss() == pytest.approx(
        jm.get_regularization_loss(), rel=1e-5)
    ej, ep = jm.evaluate(x, y, B), pm.evaluate(x, y, B)
    assert set(ep) == set(ej) == set(metrics)
    for k in ej:
        assert ep[k] == pytest.approx(ej[k], rel=rtol, abs=1e-6)


OPTS = [("sgd", 1e-5), ("adagrad", 1e-4)]


@pytest.mark.parametrize("opt, rtol", OPTS)
@pytest.mark.parametrize("name", ["WDL", "NFM", "DCN", "DCNMix"])
def test_zoo_fit_trajectory_matches_jax(name, opt, rtol):
    check_fit(name, opt, rtol)
