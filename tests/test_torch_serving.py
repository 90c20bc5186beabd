"""The port's serving artifacts (``deepctr_tpu_torch/serving.py``) against
the JAX package's (``deepctr_tpu/serving.py``) and against the port's own
``predict``, on the CPU: models from the same JAX weights, the artifact at
a fixed and at a symbolic batch, before and after ``save_exported`` /
``load_exported``, within 1e-6 (float32 sums in other orders); the saved
artifact run in a fresh process that builds no model; and the exported
graphs hold the kernels' custom operators (``ops/library.py``), whose CPU
implementations are the plain versions here."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu import serving as jserving
from deepctr_tpu.models import DeepFM as JDeepFM
from deepctr_tpu_torch import serving
from deepctr_tpu_torch.models import DeepFM as PDeepFM
from deepctr_tpu_torch.ops import gather
from deepctr_tpu_torch.utils.jax_weights import load_jax_weights
from tests import test_torch_multitask as mtl
from tests.test_torch_train import _data, _pair, _redraw

ATOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _columns(m):
    return [m.SparseFeat("C1", 20, 4), m.SparseFeat("C2", 9, 4),
            m.DenseFeat("I1", 1),
            m.VarLenSparseFeat(m.SparseFeat("hist", 30, 4), maxlen=5,
                               combiner="mean")]


def _deepfm_pair(n=64, seed=0):
    """The JAX test's DeepFM (a varlen field), weights redrawn, its port,
    and a batch of ``n``."""
    rng = np.random.default_rng(seed)
    jm = JDeepFM(_columns(dt), _columns(dt))
    weights = jm.get_weights()
    weights["params"] = _redraw(weights["params"], rng)
    jm.set_weights(weights)
    pm = PDeepFM(_columns(pt), _columns(pt), device="cpu")
    load_jax_weights(pm, weights)
    x = {"C1": rng.integers(0, 20, n), "C2": rng.integers(0, 9, n),
         "I1": rng.random(n).astype("float32"),
         "hist": rng.integers(0, 30, (n, 5)) * rng.integers(0, 2, (n, 5))}
    return jm, pm, x


def _ops(exported):
    """The ``deepctr_tpu_torch::`` operators the exported graph calls."""
    return {str(node.target).split(".")[-2]
            for node in exported.program.graph.nodes
            if node.op == "call_function"
            and str(node.target).startswith("deepctr_tpu_torch.")}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_export_fixed_batch_matches_predict_and_jax(tmp_path):
    jm, pm, x = _deepfm_pair()
    X = pm.assemble_device_input(x)
    want = pm.predict(x, 64)
    exp = serving.export_predict(pm, batch_size=64)
    got = exp.call(X).numpy()
    assert got.shape == (64, 1) and got.dtype == np.float32
    _close(got, want)
    jexp = jserving.export_predict(jm, batch_size=64)
    _close(got, jexp.call(jnp.asarray(jm._assemble_x(x))))
    path = serving.save_exported(exp, str(tmp_path / "deepfm.pt2"))
    loaded = serving.load_exported(path)
    np.testing.assert_array_equal(loaded.call(X).numpy(), got)
    assert _ops(loaded) == {"gather_rows"}


def test_export_symbolic_batch_serves_any_size(tmp_path):
    jm, pm, x = _deepfm_pair()
    exp = serving.export_predict(pm)
    path = serving.save_exported(exp, str(tmp_path / "any.pt2"))
    loaded = serving.load_exported(path)
    jexp = jserving.export_predict(jm)
    X = pm._assemble_x(x)
    for b in (1, 7, 64):
        want = pm.predict({k: v[:b] for k, v in x.items()}, batch_size=64)
        got = exp.call(X[:b]).numpy()
        assert got.shape == (b, 1)
        _close(got, want)
        _close(got, jexp.call(jnp.asarray(X[:b])))
        np.testing.assert_array_equal(loaded.call(X[:b]).numpy(), got)


def test_export_multitask():
    jcols, pcols, x, _ = mtl.mtl_data(2, 2, 48, seed=1)
    jm, pm = mtl.pair("MMOE", jcols, pcols, seed=1, num_experts=3,
                      expert_dnn_hidden_units=(16, 8),
                      gate_dnn_hidden_units=(8,),
                      tower_dnn_hidden_units=(8,))
    exp = serving.export_predict(pm, batch_size=48)
    got = exp.call(pm._assemble_x(x)).numpy()
    assert got.shape == (48, 2)
    _close(got, pm.predict(x, 48))
    _close(got, jserving.export_predict(jm, batch_size=48).call(
        jnp.asarray(jm._assemble_x(x))))


def test_export_after_a_sparse_path_fit_bakes_the_trained_rows():
    """The counterpart of the JAX package's
    ``test_export_syncs_combined_storage_tables``: an export taken right
    after a fit on the sparse path, before any predict, holds the trained
    rows; and it copies them, so a later fit leaves the artifact as it
    was.  Against the JAX package after the same fit the predictions are
    held at 1e-5 (the weights themselves part by float32 rounding)."""
    jm, pm, cols = _pair(big=[2048], l2_reg_linear=0.0,
                         l2_reg_embedding=0.0)
    x, y = _data(cols, 128, np.random.default_rng(5))
    for m in (jm, pm):
        m.compile("adagrad", "binary_crossentropy",
                  sparse_table_updates=True)
        m.fit(x, y, batch_size=64, epochs=2, verbose=0, shuffle=False)
    assert "embedding_dict/big0" in [s[0] for s in pm._sparse_specs]
    exp = serving.export_predict(pm, batch_size=128)
    X = pm._assemble_x(x)
    got = exp.call(X).numpy()
    want = pm.predict(x, 128)
    _close(got, want)
    np.testing.assert_allclose(
        got, jserving.export_predict(jm, batch_size=128).call(
            jnp.asarray(X)), rtol=0, atol=1e-5)
    pm.fit(x, y, batch_size=64, epochs=1, verbose=0)
    assert np.abs(pm.predict(x, 128) - want).max() > 1e-4
    np.testing.assert_array_equal(exp.call(X).numpy(), got)


def test_export_requires_features():
    with pytest.raises(ValueError, match="no input features"):
        serving.export_predict(PDeepFM([], [], device="cpu"), batch_size=4)


def test_a_fresh_process_serves_the_artifact_without_the_model(tmp_path):
    """The artifact and a batch in files; a new interpreter that imports
    only ``deepctr_tpu_torch.serving`` (no model class, no columns) runs
    it, bit-equal to this process, and counts no kernel launch."""
    _, pm, x = _deepfm_pair(16)
    exp = serving.export_predict(pm)
    path = serving.save_exported(exp, str(tmp_path / "deepfm.pt2"))
    X = pm._assemble_x(x)
    np.save(tmp_path / "X.npy", X)
    code = (
        "import sys, numpy as np\n"
        "from deepctr_tpu_torch import serving\n"
        "from deepctr_tpu_torch.ops import gather\n"
        "out = serving.load_exported(sys.argv[1]).call(np.load(sys.argv[2]))\n"
        "np.save(sys.argv[3], out.numpy())\n"
        "print('launches', gather.GATHER_LAUNCHES)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, path, str(tmp_path / "X.npy"),
         str(tmp_path / "out.npy")], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "launches 0" in proc.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  exp.call(X).numpy())
    assert gather.GATHER_LAUNCHES >= 0 and isinstance(exp.program,
                                                      torch.export.
                                                      ExportedProgram)
    assert pt.serving is serving
