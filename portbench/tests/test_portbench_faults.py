"""A run with the timed path broken underneath comes out not ``correct``:
each fault a cell can have, planted in the program (the port), driving
the rest of a run on the CPU at a tiny size.  The exchange between chips
is no fault of these one-chip cells.

Training cells: a step that returns its state unchanged (no optimizer
step), and half of the batch left out with the mean taken over the rest
(a training cell answers no request: what its steps produce is the state
they leave).  The serving cell: an answer altered (a score's logit off by
one) and half of each request's scores left out (the first half's given
again)."""

import json

import numpy as np
import pytest
import torch

import deepctr_tpu_torch as pt
from deepctr_tpu_torch.models import basemodel
from portbench import run


def _line(root, cell, capsys):
    # a window long enough to answer the tiny pool's requests on a loaded CPU
    rc = run.main(["--workload", cell, "--seed", "2147483659", "--seconds",
                   "1.0", "--trace", "0"], root=root,
                  device=torch.device("cpu"))
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def float32_compute_after():
    yield
    pt.set_compute_dtype("float32")


def _state_unchanged(mp):
    mp.setattr(basemodel.DenseOptimizer, "step", lambda self, bias=None: None)
    mp.setattr(basemodel, "row_update", lambda *a, **k: None)


def _half_batch(mp):
    loss = basemodel.BaseModel._compute_loss

    def half(self, y_pred, y, sw):
        h = y_pred.shape[0] // 2
        return 2.0 * loss(self, y_pred[:h], y[:h], sw[:h])
    mp.setattr(basemodel.BaseModel, "_compute_loss", half)


TRAIN_FAULTS = {"state_unchanged": _state_unchanged,
                "half_batch": _half_batch}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
@pytest.mark.parametrize("cell", ["deepfm_criteo_kaggle.train_zipf",
                                  "dien_amazon_books.train"])
def test_training_fault_is_not_correct(tiny_root, cell, fault, capsys,
                                       monkeypatch):
    sound = _line(tiny_root, cell, capsys)
    with monkeypatch.context() as mp:
        TRAIN_FAULTS[fault](mp)
        broken = _line(tiny_root, cell, capsys)
    assert broken["correct"] is False
    # caught by a number compared that reads far above the sound run's
    ratios = [(broken["checks"][k]["value"] or float("inf"))
              / max(v["value"], 1e-12) for k, v in sound["checks"].items()]
    assert max(ratios) >= 3.0, (sound["checks"], broken["checks"])


def _serve_altered(mp):
    predict = basemodel.BaseModel.predict

    def altered(self, x, batch_size=256):
        p = predict(self, x, batch_size)
        logit = np.log(p[0, 0]) - np.log1p(-p[0, 0])
        p[0, 0] = 1.0 / (1.0 + np.exp(-(logit + 1.0)))
        return p
    mp.setattr(basemodel.BaseModel, "predict", altered)


def _serve_half(mp):
    predict = basemodel.BaseModel.predict

    def half(self, x, batch_size=256):
        p = predict(self, x, batch_size)
        h = p.shape[0] // 2
        p[p.shape[0] - h:] = p[:h]
        return p
    mp.setattr(basemodel.BaseModel, "predict", half)


@pytest.mark.parametrize("fault", [_serve_altered, _serve_half])
def test_serving_fault_is_not_correct(tiny_root, fault, capsys, monkeypatch):
    cell = "dien_amazon_books.serve"
    sound = _line(tiny_root, cell, capsys)
    with monkeypatch.context() as mp:
        fault(mp)
        broken = _line(tiny_root, cell, capsys)
    assert broken["correct"] is False
    assert (broken["checks"]["score_gap"]["value"]
            >= 3.0 * sound["checks"]["score_gap"]["value"])
