"""Every file of the benchmark loads, and BENCHMARK.json names only what is
there: configurations, traffic mixes, limits, references and readers."""

import json
import re

import pytest
import torch

from portbench.harness import traffic
from portbench.harness.spec import Spec
from portbench.tests import tiny

REPO = tiny.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


def test_every_config_is_used_and_loads():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = json.loads((REPO / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in cfg
        assert (REPO / "portbench/reference" / (c["name"] + ".py")).exists()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    spec = Spec(cell, REPO)
    assert spec.traffic["driver"] in ("train", "serve")
    assert isinstance(spec.limits, dict)
    assert spec.reference().forward
    per_layer = spec.metrics("per_layer")
    assert per_layer and all(hasattr(r, "read") for _, _, r in per_layer)
    names = {n for n, _, _ in spec.metrics("end_to_end")}
    assert "setup_s" in names and len(names) >= 2


def test_every_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert (REPO / "portbench/metrics" / (m["name"] + ".py")).exists()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("mix", ["train_zipf", "train"])
def test_training_traffic_draws(mix):
    cfg = tiny.tiny_configs()[{"train_zipf": "deepfm_criteo_kaggle",
                               "train": "dien_amazon_books"}[mix]]
    tr = tiny.tiny_traffic(mix)
    cols, y = traffic.train_data(tr, cfg, 2 ** 31 + 5, torch.device("cpu"))
    again, y2 = traffic.train_data(tr, cfg, 2 ** 31 + 5,
                                   torch.device("cpu"))
    assert torch.equal(y, y2)
    for c in cfg["columns"]:
        v = cols[c["name"]]
        assert torch.equal(v, again[c["name"]])
        assert v.shape[0] == tr["rows"]
        if c["kind"] in ("sparse", "varlen"):
            assert int(v.min()) >= 0 and int(v.max()) < c["vocab"]
    assert set(y.unique().tolist()) <= {0.0, 1.0}


def test_lengths_are_the_same_multiset_for_every_seed():
    cfg = tiny.tiny_configs()["dien_amazon_books"]
    tr = tiny.tiny_traffic("train")
    a, _ = traffic.train_data(tr, cfg, 1, torch.device("cpu"))
    b, _ = traffic.train_data(tr, cfg, 2, torch.device("cpu"))
    la, lb = a["seq_length"], b["seq_length"]
    assert not torch.equal(la, lb)
    assert torch.equal(la.sort().values, lb.sort().values)
    # a history's positions past its length are the padding id
    pos = torch.arange(6)[None, :]
    assert bool((a["hist_item_id"][pos >= la[:, None]] == 0).all())
    assert bool((a["hist_item_id"][pos < la[:, None]] > 0).all())


def test_request_pool():
    cfg = tiny.tiny_configs()["dien_amazon_books"]
    tr = tiny.tiny_traffic("serve")
    pool = traffic.request_pool(tr, cfg, 9, torch.device("cpu"))
    assert len(pool) == tr["pool"]
    sizes = sorted(len(r["item_id"]) for r in pool)
    assert tr["candidates"]["min"] <= sizes[0] <= sizes[-1] \
        <= tr["candidates"]["max"]
    for r in pool:
        # the user's history is repeated on every candidate's row
        assert (r["hist_item_id"] == r["hist_item_id"][0]).all()
        assert (r["neg_hist_item_id"] == 0).all()
