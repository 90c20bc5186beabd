"""``tests/utils.py:check_model`` on the port, on the CPU: compile, fit
with ``EarlyStopping`` and ``ModelCheckpoint``, predict, the
``save_weights``/``load_weights`` round trip and ``save_model``/
``load_model``, for the twelve ported models, each on a case of its
``tests/models/<Model>_test.py`` with that test's dropout rates.

The JAX harness checks that the reloaded model predicts within 1e-5; the
port's reloads are held to the same bits, since a weights file holds the
float32 tensors as they are.  The model cases' data is ``tests/utils.py:
get_test_data``'s layout from a numpy seed (``tests/test_torch_zoo.py:
zoo_data``) and the DIN/DIEN tests' fixed four-user batch.
``tests/test_torch_persistence_seq.py`` holds the sequence models and
xDeepFM."""

import numpy as np
import pytest

import deepctr_tpu_torch as pt
from deepctr_tpu_torch import callbacks as pcb
from deepctr_tpu_torch import models as pmodels
from tests.test_torch_zoo import zoo_data

SAMPLE_SIZE = 64


def check_model(model, model_name, x, y, tmp_path, check_model_io=True):
    """compile -> fit(with callbacks) -> predict -> save/load weights ->
    save/load whole model (``tests/utils.py:70-105``)."""
    ckpt_path = str(tmp_path / (model_name + "_ckpt.pt"))
    weights_path = str(tmp_path / (model_name + "_weights.pt"))
    model_path = str(tmp_path / (model_name + "_model.pt"))

    early_stopping = pcb.EarlyStopping(monitor="val_binary_crossentropy",
                                       min_delta=0, verbose=1, patience=0,
                                       mode="min")
    model_checkpoint = pcb.ModelCheckpoint(
        filepath=ckpt_path, monitor="val_binary_crossentropy", verbose=1,
        save_best_only=True, save_weights_only=False, mode="min", period=1)
    model.compile("adam", "binary_crossentropy",
                  metrics=["binary_crossentropy"])
    model.fit(x, y, batch_size=64, epochs=3, validation_split=0.5, verbose=0,
              callbacks=[early_stopping, model_checkpoint])
    # the first epoch is always the best so far: the callback saved it
    assert pt.load_model(ckpt_path).predict(x, batch_size=32).shape == (
        len(y), 1)

    pred = model.predict(x, batch_size=32)
    assert pred.shape[0] == len(y)
    assert np.all(np.isfinite(pred))

    model.save_weights(weights_path)
    model.load_weights(weights_path)
    np.testing.assert_array_equal(model.predict(x, batch_size=32), pred)
    if check_model_io:
        pt.save_model(model, model_path)
        m2 = pt.load_model(model_path)
        assert type(m2) is type(model)
        np.testing.assert_array_equal(m2.predict(x, batch_size=32), pred)


def _columns_and_data(n_sparse, n_dense, seed):
    _, cols, x, y = zoo_data(n_sparse, n_dense, SAMPLE_SIZE, seed)
    return cols, x, y


# (model, sparse features, dense features, constructor arguments): a case
# of each tests/models/<Model>_test.py, with that test's dropout
CASES = [
    ("DeepFM", 2, 2, dict(use_fm=True, dnn_hidden_units=(32,),
                          dnn_dropout=0.5)),
    ("DeepFM", 1, 1, dict(use_fm=False, dnn_hidden_units=(), dnn_dropout=0.5)),
    ("WDL", 2, 2, dict(dnn_hidden_units=(32, 32), dnn_dropout=0.5)),
    ("NFM", 2, 2, dict(dnn_hidden_units=(32,), dnn_dropout=0.5,
                       bi_dropout=0.5)),
    ("DCN", 2, 2, dict(cross_num=1, dnn_hidden_units=(8,),
                       dnn_dropout=0.5)),
    ("DCNMix", 2, 2, dict(cross_num=1, dnn_hidden_units=(8,),
                          dnn_dropout=0.5)),
    ("AutoInt", 2, 2, dict(att_layer_num=1, dnn_hidden_units=(4,),
                           dnn_dropout=0.5)),
    ("AFM", 3, 0, dict(use_attention=True, afm_dropout=0.5)),
    ("AFM", 2, 0, dict(use_attention=False, afm_dropout=0.5)),
    ("FiBiNET", 2, 2, dict(bilinear_type="interaction",
                           dnn_hidden_units=(8,), dnn_dropout=0.5)),
    ("PNN", 2, 2, dict(dnn_hidden_units=(8,), dnn_dropout=0.5,
                       use_inner=True, use_outter=True, kernel_type="mat")),
]


@pytest.mark.parametrize("case", CASES, ids=["%s-%d" % (c[0], i)
                                             for i, c in enumerate(CASES)])
def test_check_model(case, tmp_path):
    name, n_sparse, n_dense, kw = case
    cols, x, y = _columns_and_data(n_sparse, n_dense, len(name) + n_sparse)
    cls = getattr(pmodels, name)
    args = (cols,) if name == "PNN" else (cols, cols)
    model = cls(*args, device="cpu", **kw)
    check_model(model, name, x, y, tmp_path)
    # every case but those without a DNN or an attention net drops values
    # in training
    assert model._has_dropout() == (kw.get("dnn_hidden_units") != ()
                                    and kw.get("use_attention") is not False)
