"""The port's spans (``deepctr_tpu_torch/tracing.py``) under a CPU
``torch.profiler``: which spans ``predict``, a host-array ``fit`` and a
device ``fit`` record, how often and inside what; that each is a plain CPU
operation, never a user annotation (which the profiler would also project
onto the device's timeline); that none is entered while no profiler runs;
and that a traced call computes the same bits as an untraced one.

A tiny DeepFM and a tiny DIEN, both with touched-row tables, on the CPU."""

import inspect

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from deepctr_tpu_torch import DenseFeat, SparseFeat, VarLenSparseFeat
from deepctr_tpu_torch import tracing
from deepctr_tpu_torch.models import DIEN, DeepFM, graphs

N, B, T = 150, 64, 5     # 3 batches, the last of 22 rows
STEPS = 3
MODELS = ["deepfm", "dien"]
PARTS = ["train_step.forward", "train_step.loss", "train_step.backward",
         "train_step.scatter_grads", "train_step.dense_update",
         "train_step.row_update"]
LAYERS = ("predict", "assemble", "train_step", "fit", "graph")


def _model(kind):
    """A compiled tiny model and its data ``(x, y)``."""
    rng = np.random.default_rng(7)
    if kind == "deepfm":
        cols = [SparseFeat("c0", 50, 4), SparseFeat("c1", 30, 4),
                DenseFeat("d0", 1)]
        x = {"c0": rng.integers(0, 50, N), "c1": rng.integers(0, 30, N),
             "d0": rng.random(N)}
        m = DeepFM(cols, cols, dnn_hidden_units=(8,), device="cpu")
    else:
        cols = [SparseFeat("item_id", 20, 4), SparseFeat("cate_id", 7, 4)]
        cols += [VarLenSparseFeat(SparseFeat("hist_" + n, v, 4,
                                             embedding_name=n),
                                  maxlen=T, length_name="seq_length")
                 for n, v in (("item_id", 20), ("cate_id", 7))]
        x = {"item_id": rng.integers(1, 20, N),
             "cate_id": rng.integers(1, 7, N),
             "hist_item_id": rng.integers(1, 20, (N, T)),
             "hist_cate_id": rng.integers(1, 7, (N, T)),
             "seq_length": rng.integers(0, T + 1, N)}
        m = DIEN(cols, ["item_id", "cate_id"], dnn_hidden_units=(8,),
                 device="cpu")
    m.compile("adam", "binary_crossentropy", sparse_table_updates=True)
    y = (rng.random(N) < 0.3).astype(np.float32)
    return m, x, y


def _run(m, x, y, call):
    if call == "predict":
        return m.predict(x, batch_size=B)
    if call == "fit":
        return m.fit(x, y, batch_size=B, epochs=1, verbose=0).history
    return m.fit(m.assemble_device_input(x), y, batch_size=B, epochs=2,
                 verbose=0).history


def _traced(m, x, y, call):
    """``(result, spans)``: the spans as the profiler's records, in the
    order they start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _run(m, x, y, call)
    spans = [e for e in prof.profiler.kineto_results.events()
             if e.name().split(".")[0] in LAYERS]
    return out, sorted(spans, key=lambda e: e.start_ns())


def _inside(child, parent):
    return (parent.start_ns() <= child.start_ns() and
            child.start_ns() + child.duration_ns()
            <= parent.start_ns() + parent.duration_ns())


@pytest.mark.parametrize("kind", MODELS)
def test_predict_spans_once_a_call_and_once_a_batch(kind):
    m, x, y = _model(kind)
    _, spans = _traced(m, x, y, "predict")
    names = [e.name() for e in spans]
    assert names == (["predict", "assemble", "assemble.batcher"]
                     + ["predict.upload", "predict.forward"] * STEPS
                     + ["predict.readback"])
    call = spans[0]
    for e in spans[1:]:
        assert _inside(e, call), e.name()
    assert _inside(spans[2], spans[1])
    # the children follow one another: none overlaps the next
    children = [e for e in spans[1:] if e.name() != "assemble.batcher"]
    for a, b in zip(children, children[1:]):
        assert a.start_ns() + a.duration_ns() <= b.start_ns()


@pytest.mark.parametrize("kind", MODELS)
def test_host_array_fit_records_each_step_and_its_parts_in_order(kind):
    m, x, y = _model(kind)
    _, spans = _traced(m, x, y, "fit")
    steps = [e for e in spans if e.name() == "train_step"]
    assert len(steps) == STEPS
    assert [e.name() for e in spans].count("assemble") == 1
    for step in steps:
        parts = [e for e in spans if e.name().startswith("train_step.")
                 and _inside(e, step)]
        assert [e.name() for e in parts] == PARTS
        for a, b in zip(parts, parts[1:]):
            assert a.start_ns() + a.duration_ns() <= b.start_ns()
    assert sum(e.name().startswith("train_step.") for e in spans) \
        == STEPS * len(PARTS)


@pytest.mark.parametrize("kind", MODELS)
def test_device_fit_records_each_epochs_begin_and_end(kind):
    m, x, y = _model(kind)
    _, spans = _traced(m, x, y, "fit_device")
    epochs = [e.name() for e in spans if e.name().startswith("fit.")]
    assert epochs == ["fit.epoch_begin", "fit.epoch_end"] * 2
    begin, end = [e for e in spans if e.name().startswith("fit.")][:2]
    # the epoch's steps run between its begin and its end (on the CPU
    # eagerly: each step records its spans)
    steps = [e for e in spans if e.name() == "train_step"
             and begin.start_ns() < e.start_ns() < end.start_ns()]
    assert len(steps) == STEPS
    assert not any(e.name() == "graph.capture" for e in spans)


@pytest.mark.parametrize("call", ["predict", "fit", "fit_device"])
def test_spans_are_plain_cpu_operations(call):
    m, x, y = _model("deepfm")
    _, spans = _traced(m, x, y, call)
    assert spans
    for e in spans:
        assert e.device_type() == DeviceType.CPU, e.name()
        assert not e.is_user_annotation(), e.name()
        assert e.duration_ns() > 0


class _Counting:
    """Stands in for the profiler's record class and counts entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("call", ["predict", "fit", "fit_device"])
def test_no_profiler_no_span_entered(call, monkeypatch):
    monkeypatch.setattr(tracing, "_Record", _Counting)
    monkeypatch.setattr(_Counting, "entered", 0)
    m, x, y = _model("dien")
    _run(m, x, y, call)
    assert _Counting.entered == 0
    # the stand-in is the one spans enter when a profiler runs
    with profile(activities=[ProfilerActivity.CPU]):
        _run(m, x, y, call)
    assert _Counting.entered > 0


def test_paused_spans_are_not_recorded():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("predict.outside"):
            with tracing.paused():
                with tracing.span("predict.inside"):
                    pass
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "predict.outside" in names and "predict.inside" not in names


@pytest.mark.parametrize("body", ["StepGraph.run", "_Captured.replay"])
def test_the_replay_path_enters_no_span(body):
    """A step on the card is a replay: the code that runs once a step
    there enters no span, so the graphed loop pays not even the check."""
    cls, name = body.split(".")
    src = inspect.getsource(getattr(getattr(graphs, cls), name))
    assert "span(" not in src


@pytest.mark.parametrize("kind", MODELS)
def test_a_traced_call_computes_the_same_bits(kind):
    runs = []
    for traced in (False, True):
        m, x, y = _model(kind)
        calls = [(c, (lambda c=c: _run(m, x, y, c)))
                 for c in ("predict", "fit", "fit_device", "predict")]
        out = []
        for _, fn in calls:
            if traced:
                with profile(activities=[ProfilerActivity.CPU]):
                    out.append(fn())
            else:
                out.append(fn())
        runs.append((out, m.get_weights()))
    (plain, w_plain), (traced, w_traced) = runs
    np.testing.assert_array_equal(plain[0], traced[0])
    np.testing.assert_array_equal(plain[3], traced[3])
    assert plain[1]["loss"] == traced[1]["loss"]
    assert plain[2]["loss"] == traced[2]["loss"]
    assert w_plain.keys() == w_traced.keys()
    for k in w_plain:
        np.testing.assert_array_equal(w_plain[k], w_traced[k], err_msg=k)
