"""The readers of the device's idle time inside the program's spans
(``metrics/<part>_idle_ms_per_request.serve.py``, ``metrics/_spans.py``)
on a synthetic trace whose gaps and spans were worked by hand."""

import types

import pytest
import torch

from portbench.harness.spec import Spec, _load_file
from portbench.harness.trace import Records, View
from portbench.metrics import _spans
from portbench.tests import tiny

READERS = {"assemble": "assemble", "batcher": "assemble.batcher",
           "upload": "predict.upload", "readback": "predict.readback"}

# device records [0, 100), [300, 400), [1000, 1100): gaps [100, 300) and
# [400, 1000)
DEVICE = [(0, 100, "k"), (300, 100, "k"), (1000, 100, "k")]
HOST = [
    (0, 1200, "predict"),
    # two overlapping spans: the union [50, 500) holds 200 + 100 ns idle
    (50, 200, "assemble"), (200, 300, "assemble"),
    # nested in the first: 60 ns idle, counted in assemble as well
    (120, 60, "assemble.batcher"),
    # [600, 1200) meets the second gap for 400 ns
    (600, 100, "predict.upload"), (650, 550, "predict.upload"),
    # inside a device record: no idle time
    (1020, 60, "predict.readback"),
    (130, 10, "aten::copy_"),
]
IDLE_NS = {"assemble": 300, "assemble.batcher": 60, "predict.upload": 400,
           "predict.readback": 0}
REQUESTS = 2


def _event(start, dur, name, device):
    return types.SimpleNamespace(
        device_type=lambda: device, start_ns=lambda: start,
        duration_ns=lambda: dur, name=lambda: name)


def _view(device, host, requests=REQUESTS):
    ev = ([_event(*d, torch.autograd.DeviceType.CUDA) for d in device]
          + [_event(*h, torch.autograd.DeviceType.CPU) for h in host])
    return View(Records(ev, 1.2e-6), requests=requests)


def _reader(short):
    name = "%s_idle_ms_per_request.serve" % short
    return _load_file(tiny.REPO / "portbench/metrics" / (name + ".py"),
                      "portbench_metric_" + name.replace(".", "_"))


def test_the_trace_has_the_gaps_worked_by_hand():
    r = _view(DEVICE, HOST).records
    assert sorted((a, b) for _, a, b in r.gaps) == [(100, 300), (400, 1000)]


@pytest.mark.parametrize("short", sorted(READERS))
def test_idle_ms_per_request_by_hand(short):
    got = _reader(short).read(_view(DEVICE, HOST))
    assert got == pytest.approx(IDLE_NS[READERS[short]] * 1e-6 / REQUESTS)


@pytest.mark.parametrize("short", sorted(READERS))
def test_no_such_span_reads_none(short):
    host = [h for h in HOST if h[2] != READERS[short]]
    assert _reader(short).read(_view(DEVICE, host)) is None


@pytest.mark.parametrize("short", sorted(READERS))
def test_no_device_record_reads_none(short):
    # a run on the CPU: spans, but no device timeline to be idle on
    assert _reader(short).read(_view([], HOST)) is None


def test_merged_and_idle_ns_edges():
    assert _spans.merged([(5, 9), (0, 3), (3, 4), (8, 12)]) == [[0, 4],
                                                                [5, 12]]
    r = _view(DEVICE, HOST).records
    # a span that covers the whole window holds every gap once
    assert _spans.idle_ns(r, "predict") == 200 + 600
    assert _spans.idle_ns(r, "nothing") is None
    # a span that ends where a gap starts holds none of it
    r = _view(DEVICE, [(0, 100, "x"), (1000, 50, "x")]).records
    assert _spans.idle_ns(r, "x") == 0


def test_only_the_serving_cell_lists_them():
    names = {"%s_idle_ms_per_request.serve" % s for s in READERS}
    serve = {n for n, _, _ in Spec("dien_amazon_books.serve",
                                   tiny.REPO).metrics("per_layer")}
    assert names <= serve
    for cell in ("deepfm_criteo_kaggle.train_zipf", "dien_amazon_books.train"):
        listed = {n for n, _, _ in Spec(cell, tiny.REPO).metrics("per_layer")}
        assert not names & listed
