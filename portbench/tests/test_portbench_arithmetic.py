"""The operation, byte, roofline and mfu arithmetic on shapes worked by
hand, and the reduction of a device trace."""

import types

import pytest
import torch

from portbench.harness import train
from portbench.harness.spec import _load_file
from portbench.harness.trace import Records, View, base_name
from portbench.metrics import _roofline as R
from portbench.tests import tiny

FM = {"columns": [{"kind": "sparse", "name": "a", "vocab": 10, "dim": 4},
                  {"kind": "sparse", "name": "b", "vocab": 5, "dim": 4},
                  {"kind": "dense", "name": "d", "dim": 1}],
      "linear_columns": "all", "optimizer": "adagrad",
      "sparse_table_updates": True, "embedding_dim": 4,
      "dnn_hidden_units": [8]}
BATCH = {"a": torch.tensor([1, 1, 2]), "b": torch.tensor([0, 3, 3]),
         "d": torch.tensor([0.5, 0.1, 0.2])}


def test_gather_bytes_by_hand():
    # distinct rows 2 + 2 of width 5; ids 3 x 2 fields; output 3 x 2 x 5
    assert R.gather_bytes(FM, BATCH, True) == 4 * 5 * 4 + 4 * 3 * 2 * 6


def test_scatter_add_bytes_by_hand():
    # cotangent 3 x 2 x 5 floats, ids 3 x 2 int64, 4 target rows r+w
    assert R.scatter_add_bytes(FM, BATCH) == (3 * 2 * (20 + 8)
                                              + 2 * 4 * 5 * 4)


def test_row_update_bytes_by_hand():
    sparse = train.sparse_tables(FM)
    assert sparse == {"embedding_dict.tables.a": ["a"],
                      "embedding_dict.tables.b": ["b"]}
    # a: rows {0, 1, 2} = 3, cap min(1 + 3, 10) = 4;
    # b: rows {0, 3} = 2, cap min(4, 5) = 4; adagrad: 1 state array
    per_row = 5 * 4 * (2 * 2 + 1)
    assert R.row_update_bytes(FM, BATCH, sparse) == (
        3 * per_row + 4 * 8 + 2 * per_row + 4 * 8)


def test_auto_gate():
    cfg = dict(FM, sparse_table_updates="auto")
    assert train.sparse_tables(cfg) == {}       # 15 rows, under 1M
    kaggle = tiny.REPO / "portbench/configs/deepfm_criteo_kaggle.json"
    import json
    cfg = json.loads(kaggle.read_text())
    tables = sorted(train.sparse_tables(cfg))
    assert len(tables) == 8     # the 8 tables of >= 16384 rows
    assert "embedding_dict.tables.C3" in tables


def test_gru_counts_by_hand():
    # 10 valid steps, T=4, B=3, H=2, bf16
    n, f = R.gru_counts(10, 4, 3, 2, training=False, att=False)
    assert f == 2 * 10 * 2 * 6
    assert n == 10 * 6 * 2 + 4 * 3 * 2 * 2 + 3 * 2 * 2 + 12 + 4 * (12 + 6)
    n2, _ = R.gru_counts(10, 4, 3, 2, training=True, att=True)
    assert n2 == n + 3 * 4 * 2 + 4 * 3 * 2 * 2
    nb, fb = R.gru_bwd_counts(10, 4, 3, 2, att=True)
    assert fb == 6 * 10 * 2 * 6
    assert nb == (10 * 10 * 2 + 3 * 2 * 2 + 12 + 4 * 3 * 6 * 2
                  + 8 * (12 + 6) + 2 * 3 * 4 * 2)


def test_least_seconds_takes_the_larger_bound():
    assert R.least_seconds(3.35e12, 0, None) == pytest.approx(1.0)
    assert R.least_seconds(3.35e12, 2 * R.GRU_FLOP_PER_S,
                           R.GRU_FLOP_PER_S) == pytest.approx(2.0)


def _records(device_events, window_s=1.0):
    ev = []
    for start, dur, name in device_events:
        ev.append(types.SimpleNamespace(
            device_type=lambda: torch.autograd.DeviceType.CUDA,
            start_ns=lambda s=start: s, duration_ns=lambda d=dur: d,
            name=lambda n=name: n))
    return Records(ev, window_s)


def test_records_busy_is_the_union():
    r = _records([(0, 100, "void gather_rows_kernel<17>(Args)"),
                  (50, 100, "k2"), (300, 50, "ns::row_update_kernel(A)")])
    assert r.busy_s == pytest.approx(200e-9)
    assert r.kernel(["gather_rows_kernel"]) == (1, pytest.approx(100e-9))
    assert r.kernel(["row_update_kernel"])[0] == 1
    assert r.launches() == 3
    assert [g[0] for g in r.gaps] == [150]
    assert base_name("void a::b<3, 4>(int)") == "b"
    assert base_name("void (anonymous namespace)::gather_rows_kernel<17, "
                     "false>(float const*, long long)") == "gather_rows_kernel"


def test_roofline_share_and_mfu():
    # one launch a unit taking 2 us, whose bytes bound is 1 us
    r = _records([(i * 10_000, 2000, "gather_rows_kernel()")
                  for i in range(5)], window_s=2.0)
    view = View(r, samples=[(0.5, "x"), (0.5, "y")], units=5,
                window_s=2.0, examples=1000, flops_per_example=989e9)
    share = R.roofline_share(view, ("gather_rows_kernel",), lambda b: 1e-6)
    assert share == pytest.approx(50.0)
    assert R.roofline_share(view, ("other",), lambda b: 1e-6) is None
    # 989 GFLOP an example x 3, 500 examples/s: 150% of 989 TFLOP/s
    assert R.mfu(view, training=True) == pytest.approx(150.0)


def test_reference_matmul_flops_by_hand():
    fm = _load_file(tiny.REPO / "portbench/reference/deepfm_criteo_kaggle.py",
                    "ref_fm")
    # DNN 2 * 4 + 1 = 9 -> 8 -> 1
    assert fm.matmul_flops(FM, BATCH, True) == 2 * (9 * 8 + 8 * 1)
    dn = _load_file(tiny.REPO / "portbench/reference/dien_amazon_books.py",
                    "ref_dien")
    cfg = {"hidden_size": 2, "att_hidden_units": [3], "columns": [
        {"kind": "sparse", "name": "u", "dim": 1}],
        "dnn_hidden_units": [4], "use_negsampling": True}
    b = {"seq_length": torch.tensor([2, 4])}
    # L = 3: GRUs 2 x 3 x (2*2*6 + 2*2*6), attention 3 x 2(8*3 + 3),
    # DNN 2(3*4 + 4), auxiliary 2 x 2 x 2(4*100 + 100*50 + 50)
    want = (2 * 3 * 48 + 3 * 2 * 27 + 2 * 16
            + 2 * 2 * 2 * (400 + 5000 + 50))
    assert dn.matmul_flops(cfg, b, True) == want
