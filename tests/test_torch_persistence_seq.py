"""``tests/utils.py:check_model`` on the port's xDeepFM, DIN and DIEN, on
the CPU, with the dropout of their ``tests/models/<Model>_test.py``
(``tests/test_torch_persistence.py`` holds the harness and the other
nine models)."""

import numpy as np
import pytest

import deepctr_tpu_torch as pt
from deepctr_tpu_torch import models as pmodels
from tests.test_torch_persistence import _columns_and_data, check_model


def din_xy(use_neg=False):
    """``tests/models/DIN_test.py:get_xy_fd`` (and DIEN's, with
    ``use_neg``) in the port's columns."""
    cols = [pt.SparseFeat("user", 4, embedding_dim=4),
            pt.SparseFeat("gender", 2, embedding_dim=4),
            pt.SparseFeat("item_id", 3 + 1, embedding_dim=8),
            pt.SparseFeat("cate_id", 2 + 1, embedding_dim=4),
            pt.DenseFeat("pay_score", 1)]
    hists = ["hist_"] + (["neg_hist_"] if use_neg else [])
    for prefix in hists:
        cols += [pt.VarLenSparseFeat(
            pt.SparseFeat(prefix + name, vocabulary_size=v, embedding_dim=e,
                          embedding_name=name),
            maxlen=4, length_name="seq_length")
            for name, v, e in (("item_id", 4, 8), ("cate_id", 3, 4))]
    items = np.array([[1, 2, 3, 0], [1, 2, 3, 0], [1, 2, 0, 0],
                      [1, 2, 0, 0]])
    cates = np.array([[1, 1, 2, 0], [2, 1, 1, 0], [2, 1, 0, 0],
                      [1, 2, 0, 0]])
    x = {"user": np.array([0, 1, 2, 3]), "gender": np.array([0, 1, 0, 1]),
         "item_id": np.array([1, 2, 3, 2]), "cate_id": np.array([1, 2, 1, 2]),
         "pay_score": np.array([0.1, 0.2, 0.3, 0.2]),
         "hist_item_id": items, "hist_cate_id": cates,
         "seq_length": np.array([3, 3, 2, 2])}
    if use_neg:
        x["neg_hist_item_id"], x["neg_hist_cate_id"] = items, cates
    return x, np.array([1, 0, 1, 0]), cols, ["item_id", "cate_id"]


@pytest.mark.parametrize("kw", [
    dict(dnn_hidden_units=(8,), cin_layer_size=(8,), cin_split_half=False,
         cin_activation="relu"),
    dict(dnn_hidden_units=(), cin_layer_size=(8,), cin_split_half=True,
         cin_activation="linear")])
def test_check_model_xdeepfm(kw, tmp_path):
    cols, x, y = _columns_and_data(2, 2, 8)
    model = pmodels.xDeepFM(cols, cols, dnn_dropout=0.5, device="cpu", **kw)
    check_model(model, "xDeepFM", x, y, tmp_path)


def test_check_model_din(tmp_path):
    x, y, cols, behavior = din_xy()
    model = pmodels.DIN(cols, behavior, dnn_dropout=0.5, device="cpu")
    check_model(model, "DIN", x, y, tmp_path)
    assert model._has_dropout()


@pytest.mark.parametrize("gru_type, use_neg", [("AUGRU", True),
                                               ("GRU", False)])
def test_check_model_dien(gru_type, use_neg, tmp_path):
    x, y, cols, behavior = din_xy(use_neg)
    model = pmodels.DIEN(cols, behavior, gru_type=gru_type,
                         use_negsampling=use_neg, dnn_hidden_units=(4, 4, 4),
                         dnn_dropout=0.5, device="cpu")
    check_model(model, "DIEN_" + gru_type, x, y, tmp_path)
    assert model._has_dropout()
