"""The rest of the zoo training on host arrays against the JAX package:
``fit`` under sgd and under adagrad with L2 on every group the model has,
then ``predict`` and ``evaluate``, for ONN, CCPM and AFN here and IFM,
DIFM and MLR in ``tests/test_torch_zoo_rest_train_fm.py``.  ONN's deep
table columns, which its logit never reads, move under L2 alone, as in
the JAX model; AFN takes one sgd step (below).

Both packages start from the same JAX weights (``tests/test_torch_zoo_
rest.py:pair``, std 0.3) with fresh optimizer state.  Per-step losses are
read from each package's own train step.

AFN takes one sgd step only: its log transform amplifies float noise by
about 1/|embedding| (``tests/test_trajectory_parity_zoo.py:373-385``), so
that two correct float32 runs part after a step; the step is held on
every parameter and every running statistic.

Tolerances.  Per-step and epoch losses: 1e-5 relative.  Every weight and
running statistic: 1e-5; every optimizer state: 1e-5, relative above 1
(an accumulator grows past 1, where float32 sums in another order part
by more than 1e-5 absolute).  predict after the fit: 1e-5.  evaluate:
1e-5 relative."""

import numpy as np
import pytest

import deepctr_tpu as dt
import deepctr_tpu_torch.models.basemodel as pt_base
import deepctr_tpu_torch.ops.gather as pt_gather
from tests.test_torch_device_loop import _jax_states, _port_states
from tests.test_torch_train import (_port_weights_of, _record_jax,
                                    _record_port)
from tests.test_torch_zoo import zoo_data
from tests.test_torch_zoo import _restore_port_config  # noqa: F401
from tests.test_torch_zoo_rest import mlr_data, pair

TOL = 1e-5
N, B, EPOCHS = 150, 64, 2
L2 = dict(l2_reg_linear=1e-3, l2_reg_embedding=2e-3, l2_reg_dnn=5e-3)
# each model with L2 on every group it has, at small widths
FITS = {
    "ONN": dict(L2, dnn_hidden_units=(8,)),
    "CCPM": dict(L2, conv_kernel_width=(3, 2), conv_filters=(2, 2),
                 dnn_hidden_units=(8,)),
    "AFN": dict(L2, ltl_hidden_size=6, afn_dnn_hidden_units=(8, 4)),
    "IFM": dict(L2, dnn_hidden_units=(8,)),
    "DIFM": dict(L2, dnn_hidden_units=(8,), att_head_num=2),
    "MLR": dict(l2_reg_linear=0.1, region_num=3),
}


def fit_pair(name, seed=0):
    """A JAX model of ``FITS[name]`` with redrawn weights, the port's copy,
    and their data (x, y)."""
    if name == "MLR":
        jcols, pcols, x, y = mlr_data({"region": (2, 1, ("mean",)),
                                       "base": (3, 1, ()),
                                       "bias": (1, 1, ())}, N, seed=5)
    else:
        jcols, pcols, x, y = zoo_data(3, 0 if name == "CCPM" else 2, N,
                                      seed=5)
    jm, pm = pair(name, jcols, pcols, seed=seed,
                  std=1.0 if name == "MLR" else 0.3, **FITS[name])
    return jm, pm, x, y.astype(np.float32)


def assert_same_training(jm, pm, hj, hp):
    """Epoch losses, every weight and running statistic, every optimizer
    state (``tests/test_torch_device_loop.py``'s maps of both trees)."""
    assert hp["loss"] and len(hp["loss"]) == len(hj["loss"])
    np.testing.assert_allclose(hp["loss"], hj["loss"], rtol=TOL)
    want, got = _port_weights_of(jm, pm)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg=k)
    want, got = _jax_states(jm), _port_states(pm)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=str(k))


def check_fit(name, opt, epochs=EPOCHS, batch_size=B):
    jm, pm, x, y = fit_pair(name)
    metrics = ["binary_crossentropy", "auc"]
    for m in (jm, pm):
        m.compile(opt, "binary_crossentropy", metrics=metrics)
    assert jm._sparse_specs == [] and pm._sparse_specs == []
    assert pm.get_regularization_loss() == pytest.approx(
        jm.get_regularization_loss(), rel=1e-6)
    start = {k: v.copy() for k, v in pm.get_weights().items()}
    jl, pl = _record_jax(jm), _record_port(pm)
    hj = jm.fit(x, y, batch_size=batch_size, epochs=epochs, verbose=0)
    hp = pm.fit(x, y, batch_size=batch_size, epochs=epochs, verbose=0)
    assert len(jl) == len(pl) == epochs * (-(-len(y) // batch_size))
    np.testing.assert_allclose(pl, jl, rtol=TOL)
    assert_same_training(jm, pm, hj.history, hp.history)
    np.testing.assert_allclose(pm.predict(x, B), jm.predict(x, B), rtol=0,
                               atol=TOL)
    ej, ep = jm.evaluate(x, y, B), pm.evaluate(x, y, B)
    assert set(ep) == set(ej) == set(metrics)
    for k in ej:
        assert ep[k] == pytest.approx(ej[k], rel=TOL)
    return jm, pm, start


def deep_columns(m, name):
    """The deep columns of the shared table ``name`` (all but the fused
    wide one)."""
    table = m.embedding_dict.tables[name]
    return table[:, :m.embedding_dict.table_dims[name]].detach().numpy()


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_onn_fit_matches_jax_and_l2_moves_the_unread_deep_columns(opt):
    """ONN's logit reads only the wide column of its shared tables; L2
    still reaches the deep columns, which move in both packages alike
    (held with every other weight), and by the L2 step alone under sgd."""
    jm, pm, start = check_fit("ONN", opt)
    name = "sparse_feature_1"
    before = start["embedding_dict.tables.%s" % name][
        :, :pm.embedding_dict.table_dims[name]]
    after = deep_columns(pm, name)
    assert np.abs(after - before).min() > 0
    if opt == "sgd":
        steps = EPOCHS * (-(-N // B))
        decay = (1 - 2 * pm._learning_rate * FITS["ONN"]["l2_reg_embedding"]
                 ) ** steps
        np.testing.assert_allclose(after, before * decay, rtol=1e-5)


def test_onn_train_step_scatters_the_pair_rows_into_the_plan(monkeypatch):
    """ONN's train step takes its pair tables' rows as it takes the shared
    tables': nothing runs ``GatherRows``' backward, and one
    ``scatter_add_rows`` call a step adds the pair rows' cotangent into the
    step plan's gradient of every pair table, which is that table's
    ``.grad``."""
    _, pm, x, y = fit_pair("ONN")
    pm.compile("sgd", "binary_crossentropy")

    def no_backward(ctx, grad):
        raise AssertionError("GatherRows' backward ran in a train step")
    monkeypatch.setattr(pt_gather.GatherRows, "backward",
                        staticmethod(no_backward))
    calls = []
    real = pt_base.scatter_add_rows

    def spy(grad, targets, rows, args=None):
        calls.append({t.data_ptr() for t in targets})
        return real(grad, targets, rows, args)
    monkeypatch.setattr(pt_base, "scatter_add_rows", spy)
    steps = 2
    pm.fit({k: v[:steps * B] for k, v in x.items()}, y[:steps * B],
           batch_size=B, epochs=1, verbose=0)
    grads = pm._plans[B].dense_grads
    pair_tables = pm.second_order_embedding.tables
    ptrs = {grads["second_order_embedding/" + n].data_ptr()
            for n in pair_tables}
    assert sum(c == ptrs for c in calls) == steps
    for n, t in pair_tables.items():
        assert t.grad is grads["second_order_embedding/" + n]


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_ccpm_fit_matches_jax(opt):
    check_fit("CCPM", opt)


def test_afn_one_sgd_step_matches_jax():
    """One step over all N samples: every parameter, the DNN's and the
    LTL's running statistics, and the optimizer's (none under sgd)."""
    check_fit("AFN", "sgd", epochs=1, batch_size=N)
