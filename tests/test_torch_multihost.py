"""The port's multi-process path: ``deepctr_tpu_torch/tools/
multiprocess_sim.py`` at 2 gloo ranks (the counterpart of
``tests/test_multihost.py``), a row-sharded model's checkpoint written by
rank 0 against the one rank's, and a failing rank that ends the run
within its limit."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import deepctr_tpu_torch as pt
from deepctr_tpu_torch.models import DeepFM
from deepctr_tpu_torch.parallel import distributed
from deepctr_tpu_torch.tools.multiprocess_sim import spawn
from deepctr_tpu_torch.utils.serialization import CHECKPOINT_FILE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(REPO, "tests", "torch_mesh_workers.py")
COLS = [("sparse", "c0", 64, 8), ("sparse", "c1", 32, 8),
        ("dense", "d0", 1)]
LEG = dict(model="DeepFM", cols=COLS, kw=dict(dnn_hidden_units=(8,)),
           optimizer="adagrad", sparse=True, batch=32)


def test_two_rank_simulation(tmp_path):
    """The sim's two ranks on a (1, 2) mesh: each holds half of every
    table, both predict the same, and their losses are the one process's
    steps on the same batch."""
    r = subprocess.run(
        [sys.executable, "-m", "deepctr_tpu_torch.tools.multiprocess_sim",
         "--ranks", "2", "--mesh", "1,2", "--device", "cpu",
         "--out", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    assert "MULTIPROCESS SIM OK" in r.stdout
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["predictions_agree"] and summary["finite"]
    assert summary["tables"][0] == {"embedding_dict.tables.c0": [32, 9],
                                    "embedding_dict.tables.c1": [16, 9]}
    # the same three steps on one process, without a mesh
    cols = [pt.SparseFeat("c0", 64, 8), pt.SparseFeat("c1", 32, 8),
            pt.DenseFeat("d0", 1)]
    model = DeepFM(cols, cols, dnn_hidden_units=(16,), seed=3, device="cpu")
    model.compile("adagrad", "binary_crossentropy")
    rng = np.random.default_rng(0)
    x = {"c0": rng.integers(0, 64, 32), "c1": rng.integers(0, 32, 32),
         "d0": rng.random(32)}
    X = torch.from_numpy(model._assemble_x(x))
    y = torch.from_numpy(rng.integers(0, 2, 32).astype(np.float32)[:, None])
    model._begin_steps(3)
    losses = [float(model._train_step(X, y, torch.ones(32))[1])
              for _ in range(3)]
    for got in summary["losses"]:
        np.testing.assert_allclose(got, losses, rtol=1e-6)


def _data():
    rng = np.random.default_rng(3)
    x = {"c0": rng.integers(0, 64, 96), "c1": rng.integers(0, 32, 96),
         "d0": rng.random(96)}
    return x, rng.integers(0, 2, 96).astype(np.float64)


def test_sharded_checkpoint_is_the_one_rank_file(tmp_path):
    """A (1, 2) mesh with row-sharded tables on the sparse path trains an
    epoch and saves a checkpoint: rank 0 writes one file whose weights and
    optimizer state (the tables' accumulators gathered over the model
    axis) are the one rank's, for the same weights and steps; it loads
    back into a fresh sharded model (each rank its blocks: the same
    predictions) and into a one-process model."""
    from tests import torch_mesh_workers as W
    x, y = _data()
    # the ranks draw the same weights from seed 3 and keep their blocks
    one = W.make_model(pt, pt.models, LEG, seed=3, device="cpu")
    ckpt = tmp_path / "ckpt"
    out = spawn(WORKERS + ":sharded_persistence", 2, str(tmp_path / "run"),
                {"mesh_shape": (1, 2), "leg": LEG, "x": x, "y": y,
                 "directory": str(ckpt)}, timeout=180, device="cpu")
    one.compile("adagrad", "binary_crossentropy", sparse_table_updates=True)
    one.fit(x, y, batch_size=32, epochs=1, verbose=0)
    one_dir = tmp_path / "one"
    one.save_checkpoint(str(one_dir))
    saved = torch.load(ckpt / CHECKPOINT_FILE, weights_only=True)
    ref = torch.load(one_dir / CHECKPOINT_FILE, weights_only=True)
    assert set(saved["weights"]) == set(ref["weights"])
    for k, v in ref["weights"].items():
        assert saved["weights"][k].shape == v.shape
        torch.testing.assert_close(saved["weights"][k], v, rtol=0,
                                   atol=1e-6)
    so, ro = saved["optimizer"], ref["optimizer"]
    assert sorted(so["table_state"]) == sorted(ro["table_state"])
    for p in ro["table_state"]:
        for a, b in zip(so["table_state"][p], ro["table_state"][p]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for a, b in zip(so["dense_state"], ro["dense_state"]):
        for u, v in zip(a, b):
            torch.testing.assert_close(u, v, rtol=0, atol=1e-6)
    # every rank gathered the whole weights; the fresh sharded model that
    # loaded the file predicts as the one that wrote it, and holds its
    # blocks of the accumulators
    for r in out:
        for k, v in ref["weights"].items():
            np.testing.assert_allclose(r["full"][k], v.numpy(), rtol=0,
                                       atol=1e-6)
        np.testing.assert_array_equal(r["pred_loaded"], r["pred"])
        for p, (a, b) in r["blocks"].items():
            np.testing.assert_array_equal(
                r["state"][p][0].numpy(),
                so["table_state"][p][0][a:b].numpy())
    # and into the one-process layout
    loaded = W.make_model(pt, pt.models, LEG, seed=9, device="cpu")
    loaded.compile("adagrad", "binary_crossentropy",
                   sparse_table_updates=True)
    loaded.load_checkpoint(str(ckpt))
    np.testing.assert_allclose(loaded.predict(x, 32), out[0]["pred"],
                               rtol=0, atol=1e-6)


def test_a_failing_rank_ends_the_run(tmp_path):
    """Rank 1 raises while rank 0 waits in an all-reduce: the spawn ends
    both and raises with rank 1's error, well inside its limit."""
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(WORKERS + ":raise_on_rank_one", 2, str(tmp_path), timeout=60,
              device="cpu")
    assert time.monotonic() - start < 45


def test_initialize_passes_through_without_a_group(monkeypatch):
    """Nothing to discover: one process, ``(0, 1)``; its host-local rows
    are the whole batch, and a batch the ranks do not divide raises."""
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() == (0, 1)
    assert distributed.host_local_rows(12) == (0, 12)
    X, y = distributed.global_batch_from_host_local(
        None, np.zeros((4, 3)), np.ones(4))
    assert X.shape == (4, 3) and y.shape == (4,)
    with pytest.raises(ValueError):
        distributed.global_batch_from_host_local(None, np.zeros((4, 3)),
                                                 np.ones(5))


def test_mesh_layout_on_four_ranks(tmp_path):
    """``distributed.global_mesh(model_axis=2)`` over 4 ranks is a ``(2,
    2)`` mesh in row-major order; each rank takes its data coordinate's
    rows of a batch, every row of a replicated tensor and its model
    coordinate's block of a table whose stored rows divide the axis (the
    blocks tile the vocabulary), none of one whose stored rows do not; a
    batch or a model axis that does not divide raises."""
    from deepctr_tpu_torch.inputs import stored_rows
    from deepctr_tpu_torch.parallel.sharding import table_block
    tables = [(64, 8), (32, 16), (63, 8), (4097, 4)]
    out = spawn(WORKERS + ":mesh_layout", 4, str(tmp_path),
                {"tables": tables}, timeout=120, device="cpu")
    for r, got in enumerate(out):
        d, m = divmod(r, 2)
        assert got["shape"] == (2, 2) and got["coordinate"] == (d, m)
        assert got["batch"] == slice(4 * d, 4 * d + 4)
        assert got["replicated"] == slice(0, 10)
        assert len(got["errors"]) == 2
        assert "not divisible" in got["errors"][0]
        assert "model_axis=3" in got["errors"][1]
        for (vocab, width), rows in zip(tables, got["tables"]):
            block = table_block(2, m, vocab, width)
            if stored_rows(vocab, width)[0] % 2:
                assert block is None and rows is None
            else:
                assert rows == slice(block[0], block[1])
    for i, (vocab, width) in enumerate(tables):
        blocks = [out[m]["tables"][i] for m in (0, 1)]
        if blocks[0] is not None:
            assert blocks[0].start == 0 and blocks[1].stop == vocab
            assert blocks[0].stop == blocks[1].start
    assert any(out[0]["tables"][i] is None for i in range(len(tables)))
    assert any(out[0]["tables"][i] is not None for i in range(len(tables)))


def test_the_mesh_needs_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                     tmp_path):
    """The mesh's entry points default to the card: without CUDA,
    ``initialize`` raises before it joins a group, ``make_mesh`` raises,
    ``spawn`` raises before it starts a rank and the sim exits 1."""
    from deepctr_tpu_torch.parallel import make_mesh
    from deepctr_tpu_torch.tools import multiprocess_sim
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.initialize(init_method="file://%s" % (tmp_path / "s"),
                               world_size=1, rank=0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((1, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn(WORKERS + ":raise_on_rank_one", 2, str(tmp_path / "a"))
    assert not (tmp_path / "a").exists()
    assert multiprocess_sim.main(["--out", str(tmp_path / "b")]) == 1
    assert not (tmp_path / "b" / "summary.json").exists()


def test_sharding_runs_once_after_the_outermost_constructor(monkeypatch):
    """``_apply_sharding`` runs once a model, when its outermost
    constructor is done: for a model class, a subclass with a constructor
    of its own and one that inherits its constructor."""
    calls = []

    def spy(self):
        calls.append((type(self).__name__, hasattr(self, "extra")))
    monkeypatch.setattr(pt.models.BaseModel, "_apply_sharding", spy)

    class Inherits(DeepFM):
        pass

    class Own(DeepFM):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.extra = True
    cols = [pt.SparseFeat("c0", 8, 4)]
    for cls in (DeepFM, Inherits, Own):
        cls(cols, cols, dnn_hidden_units=(4,), device="cpu")
    assert calls == [("DeepFM", False), ("Inherits", False), ("Own", True)]
