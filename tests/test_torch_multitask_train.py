"""The multi-task models training on host arrays against the JAX package:
``compile`` with a loss list (a binary and a regression task, two binary
tasks) or one loss for every task, ``fit`` under sgd and adagrad with L2
on every group, ``validation_split``, and ``evaluate``, whose keys are the
JAX package's: ``<task>_<metric>`` for each task and the bare metric for
their mean (``deepctr_tpu/models/basemodel.py:1993-2018``), in the
``val_`` history too; and ``EarlyStopping`` and ``ModelCheckpoint``
following one task's validation metric.

Both packages start from the same JAX weights (``tests/test_torch_
multitask.py:pair``).  Tolerances: those of ``tests/test_torch_zoo_rest_
train.py`` (losses, weights, optimizer states and predictions 1e-5;
``evaluate`` and the history's validation metrics 1e-5 relative)."""

import numpy as np
import pytest

import deepctr_tpu_torch as pt
from deepctr_tpu_torch import callbacks as pcb
from tests.test_torch_multitask import BB, BR, mtl_data, pair
from tests.test_torch_train import _record_jax, _record_port
from tests.test_torch_zoo import _restore_port_config  # noqa: F401
from tests.test_torch_zoo_rest_train import TOL, assert_same_training

N, B, EPOCHS = 160, 64, 2
L2 = dict(l2_reg_embedding=2e-3, l2_reg_dnn=5e-3)
# (task types, loss, metrics, constructor arguments)
FITS = {
    "SharedBottom": (BR, ["binary_crossentropy", "mae"], ["mse"], dict(
        L2, bottom_dnn_hidden_units=(8,), tower_dnn_hidden_units=(8,))),
    "ESMM": (BB, ["binary_crossentropy", "binary_crossentropy"],
             ["auc", "binary_crossentropy"], dict(
                 L2, tower_dnn_hidden_units=(8,))),
    "MMOE": (BR, ["binary_crossentropy", "mse"], ["mse"], dict(
        L2, num_experts=3, expert_dnn_hidden_units=(8,),
        gate_dnn_hidden_units=(4,), tower_dnn_hidden_units=(4,))),
    "PLE": (BB, "binary_crossentropy", ["auc"], dict(
        L2, num_levels=2, specific_expert_num=2, shared_expert_num=1,
        expert_dnn_hidden_units=(8,), gate_dnn_hidden_units=(4,),
        tower_dnn_hidden_units=(4,))),
}


def fit_pair(name, seed=0):
    task_types, loss, metrics, kw = FITS[name]
    if name != "ESMM":
        kw = dict(kw, task_types=task_types)
    jcols, pcols, x, y = mtl_data(2, 2, N, seed=11, task_types=task_types)
    jm, pm = pair(name, jcols, pcols, seed=seed, **kw)
    return jm, pm, x, y, loss, metrics


def assert_same_logs(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
@pytest.mark.parametrize("name", list(FITS))
def test_multitask_fit_and_evaluate_match_jax(name, opt):
    jm, pm, x, y, loss, metrics = fit_pair(name)
    for m in (jm, pm):
        m.compile(opt, loss, metrics=metrics)
    assert pm.get_regularization_loss() == pytest.approx(
        jm.get_regularization_loss(), rel=1e-6)
    jl, pl = _record_jax(jm), _record_port(pm)
    hj = jm.fit(x, y, batch_size=B, epochs=EPOCHS, verbose=0,
                validation_split=0.25).history
    hp = pm.fit(x, y, batch_size=B, epochs=EPOCHS, verbose=0,
                validation_split=0.25).history
    np.testing.assert_allclose(pl, jl, rtol=TOL)
    assert_same_training(jm, pm, hj, hp)
    tasks = pm.task_names
    assert {"val_%s_%s" % (t, m) for t in tasks for m in metrics} < set(hp)
    assert_same_logs(hp, hj)
    np.testing.assert_allclose(pm.predict(x, B), jm.predict(x, B), rtol=0,
                               atol=TOL)
    ej, ep = jm.evaluate(x, y, B), pm.evaluate(x, y, B)
    assert set(ep) == set(metrics) | {"%s_%s" % (t, m) for t in tasks
                                      for m in metrics}
    assert_same_logs(ep, ej)
    for m in metrics:
        assert ep[m] == pytest.approx(np.mean([ep["%s_%s" % (t, m)]
                                               for t in tasks]))


def test_callbacks_follow_one_task_of_a_multitask_fit(tmp_path):
    """``EarlyStopping`` and ``ModelCheckpoint`` on ``val_ctr_auc``: the
    checkpoint holds the best epoch's model, which loads and predicts
    [N, 2]; the stop comes where the JAX package's comes on the same
    history."""
    jm, pm, x, y, loss, metrics = fit_pair("ESMM", seed=1)
    path = str(tmp_path / "esmm_best.pt")
    for m in (jm, pm):
        m.compile("adagrad", loss, metrics=metrics, learning_rate=0.05)
    from deepctr_tpu import callbacks as jcb
    hj = jm.fit(x, y, batch_size=B, epochs=6, verbose=0,
                validation_split=0.25,
                callbacks=[jcb.EarlyStopping(monitor="val_ctr_auc",
                                             mode="max", patience=1)])
    stop = pcb.EarlyStopping(monitor="val_ctr_auc", mode="max", patience=1)
    ckpt = pcb.ModelCheckpoint(path, monitor="val_ctr_auc", mode="max",
                               save_best_only=True)
    hp = pm.fit(x, y, batch_size=B, epochs=6, verbose=0,
                validation_split=0.25, callbacks=[stop, ckpt])
    assert len(hp.history["val_ctr_auc"]) == len(hj.history["val_ctr_auc"])
    np.testing.assert_allclose(hp.history["val_ctr_auc"],
                               hj.history["val_ctr_auc"], rtol=TOL)
    assert len(hp.history["val_ctr_auc"]) < 6
    best = pt.load_model(path)
    pred = best.predict(x, B)
    assert pred.shape == (N, 2) and np.isfinite(pred).all()


def test_auc_of_a_label_matrix_is_the_mean_of_its_columns_as_jax():
    """A multi-task fit's train metrics (``verbose > 0``) take [n, T]
    arrays: the JAX package's ``auc`` is sklearn's, the mean of the
    columns' AUCs for a label matrix; so is the port's."""
    from deepctr_tpu.utils import metrics as jmetrics
    from deepctr_tpu_torch.utils import metrics as pmetrics
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, (300, 3)).astype(np.float32)
    p = rng.random((300, 3))
    want = jmetrics.roc_auc_score(y, p)
    assert pmetrics.roc_auc_score(y, p) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(np.mean([jmetrics.roc_auc_score(
        y[:, i], p[:, i]) for i in range(3)]), rel=1e-12)
