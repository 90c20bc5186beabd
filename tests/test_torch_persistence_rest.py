"""Persistence of the rest of the zoo and of the multi-task models, on the
CPU: ``tests/utils.py:check_model`` (compile, fit with ``EarlyStopping``
and ``ModelCheckpoint``, predict, ``save_weights``/``load_weights``,
``save_model``/``load_model``) for ONN, CCPM, AFN, IFM, DIFM and MLR on a
case of their ``tests/models/<Model>_test.py``, ``tests/utils_mtl.py:
check_mtl_model`` (the same with a loss list and [N, 2] labels) for
SharedBottom, ESMM, MMOE and PLE; and for all ten a checkpoint resume
(adam, with the cases' dropout) bit-equal to the uninterrupted fit.

Reloads are held to the same bits, as ``tests/test_torch_persistence.py``
holds them."""

import numpy as np
import pytest
import torch

import deepctr_tpu_torch as pt
from deepctr_tpu_torch import callbacks as pcb
from deepctr_tpu_torch import models as pmodels
from deepctr_tpu_torch.models import multitask as pmt
from tests.test_torch_checkpoint import _assert_bit_equal
from tests.test_torch_multitask import BR, mtl_data
from tests.test_torch_persistence import check_model
from tests.test_torch_zoo import zoo_data
from tests.test_torch_zoo_rest import mlr_data

N = 64
# (model, constructor arguments): a case of each tests/models/<Model>_
# test.py, with that test's dropout
SINGLE = {
    "ONN": dict(dnn_hidden_units=(8,), dnn_dropout=0.5),
    "CCPM": dict(conv_kernel_width=(3, 2), conv_filters=(2, 1),
                 dnn_hidden_units=(32,), dnn_dropout=0.5),
    "AFN": dict(ltl_hidden_size=32, afn_dnn_hidden_units=(32, 16),
                dnn_dropout=0.5),
    "IFM": dict(dnn_hidden_units=(32,), dnn_dropout=0.5),
    "DIFM": dict(att_head_num=1, dnn_hidden_units=(4,), dnn_dropout=0.5),
    "MLR": dict(),
}
MULTI = {
    "SharedBottom": dict(bottom_dnn_hidden_units=(8,),
                         tower_dnn_hidden_units=(8,), dnn_dropout=0.5,
                         task_types=BR, task_names=("t1", "t2")),
    "ESMM": dict(tower_dnn_hidden_units=(8,), dnn_dropout=0.5),
    "MMOE": dict(num_experts=3, expert_dnn_hidden_units=(16, 8),
                 gate_dnn_hidden_units=(8,), tower_dnn_hidden_units=(8,),
                 dnn_dropout=0.5, task_types=BR, task_names=("t1", "t2")),
    "PLE": dict(num_levels=2, specific_expert_num=2, shared_expert_num=1,
                expert_dnn_hidden_units=(8,), gate_dnn_hidden_units=(8,),
                tower_dnn_hidden_units=(8,), dnn_dropout=0.5, task_types=BR,
                task_names=("t1", "t2")),
}


def make(name, seed=0):
    """(a fresh model of the case, x, y, its loss)."""
    if name in MULTI:
        types = MULTI[name].get("task_types", ("binary", "binary"))
        _, cols, x, y = mtl_data(2, 2, N, seed, task_types=types)
        loss = ["binary_crossentropy" if t == "binary" else "mae"
                for t in types]
        return pmt.__dict__[name](cols, device="cpu", **MULTI[name]), x, y, \
            loss
    if name == "MLR":
        _, cols, x, y = mlr_data({"region": (2, 1, ("mean",)),
                                  "base": (1, 1, ()), "bias": (1, 0, ())},
                                 N, seed)
        model = pmodels.MLR(cols["region"], cols["base"], cols["bias"],
                            device="cpu")
        return model, x, y, "binary_crossentropy"
    _, cols, x, y = zoo_data(3, 0 if name in ("CCPM", "AFN") else 2, N,
                             seed)
    return (getattr(pmodels, name)(cols, cols, device="cpu",
                                   **SINGLE[name]),
            x, y, "binary_crossentropy")


@pytest.mark.parametrize("name", list(SINGLE))
def test_check_model(name, tmp_path):
    model, x, y, _ = make(name, seed=len(name))
    check_model(model, name, x, y, tmp_path)


@pytest.mark.parametrize("name", list(MULTI))
def test_check_mtl_model(name, tmp_path):
    """``check_mtl_model``: a loss list, ``EarlyStopping`` and
    ``ModelCheckpoint`` on the validation metric's mean over the tasks
    (the engine records no ``val_loss``, as the JAX package's), predict
    [N, 2], the weights and the whole model saved and loaded back to the
    same bits."""
    model, x, y, loss = make(name, seed=len(name))
    ckpt = str(tmp_path / "ckpt.pt")
    model.compile("adam", loss, metrics=["binary_crossentropy"])
    model.fit(x, y, batch_size=32, epochs=2, validation_split=0.5,
              verbose=0, callbacks=[
                  pcb.EarlyStopping(monitor="val_binary_crossentropy",
                                    patience=0),
                  pcb.ModelCheckpoint(ckpt,
                                      monitor="val_binary_crossentropy",
                                      save_best_only=True)])
    assert pt.load_model(ckpt).predict(x, 32).shape == (N, 2)
    pred = model.predict(x, batch_size=32)
    assert pred.shape == (N, 2) and np.isfinite(pred).all()
    weights = str(tmp_path / "w.pt")
    model.save_weights(weights)
    model.load_weights(weights)
    np.testing.assert_array_equal(model.predict(x, 32), pred)
    pt.save_model(model, str(tmp_path / "m.pt"))
    m2 = pt.load_model(str(tmp_path / "m.pt"))
    assert type(m2) is type(model) and m2.task_names == model.task_names
    np.testing.assert_array_equal(m2.predict(x, 32), pred)


@pytest.mark.parametrize("name", list(SINGLE) + list(MULTI))
def test_checkpoint_resume_is_bit_equal_to_the_uninterrupted_fit(
        name, tmp_path):
    """Two epochs in one fit, and one epoch, a checkpoint, a fresh model
    that loads it and ``fit(initial_epoch=1)``: every weight, running
    statistic, optimizer state and step count the same bits (adam, the
    shuffle on, the case's dropout)."""
    def compiled():
        model, x, y, loss = make(name)
        model.compile("adam", loss)
        return model, x, y
    ref, x, y = compiled()
    ref.fit(x, y, batch_size=32, epochs=2, verbose=0)
    m, _, _ = compiled()
    m.fit(x, y, batch_size=32, epochs=1, verbose=0)
    m.save_checkpoint(str(tmp_path / "ckpt"))
    resumed, _, _ = compiled()
    resumed.load_checkpoint(str(tmp_path / "ckpt"))
    _assert_bit_equal(resumed, m)
    resumed.fit(x, y, batch_size=32, epochs=2, initial_epoch=1, verbose=0)
    _assert_bit_equal(resumed, ref)
    assert not torch.equal(ref.state_dict()[next(iter(ref.state_dict()))],
                           make(name)[0].state_dict()[
                               next(iter(ref.state_dict()))])
