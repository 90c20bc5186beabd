"""The port's DeepFM serving slice (deepctr_tpu_torch) against the JAX
package: FM, DNN and LinearModel layer by layer, then the whole model with
the JAX weights carried across by ``load_jax_weights``, and the package's
import and device rules.

Weights are drawn at std 0.3 (not the models' init_std=1e-4, which puts
every prediction at 0.5 and would let a wrong model pass)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu.layers import DNN as JDNN, FM as JFM
from deepctr_tpu.models import DeepFM as JDeepFM
from deepctr_tpu.models.base_module import BaseModule as JBaseModule
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.layers import DNN as PDNN, FM as PFM
from deepctr_tpu_torch.models import DeepFM as PDeepFM
from deepctr_tpu_torch.models import basemodel as pt_basemodel
from deepctr_tpu_torch.models.base_module import BaseModule as PBaseModule
from deepctr_tpu_torch.ops import gather as pt_gather
from deepctr_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                 load_jax_weights,
                                                 unpack_table)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


def _redraw(tree, rng, std=0.3):
    """Every leaf of a numpy parameter tree redrawn from normal(std)."""
    return {k: _redraw(v, rng, std) if isinstance(v, dict)
            else rng.normal(0, std, np.shape(v)).astype(np.float32)
            for k, v in tree.items()}


def _columns(m):
    """6 sparse fields (one >= 131072 rows, so stored packed by the JAX
    package; one linear-only, so not fused) and 3 dense fields."""
    sparse = [m.SparseFeat("s0", 4, 8), m.SparseFeat("s1", 100, 8),
              m.SparseFeat("s2", 1000, 8), m.SparseFeat("big", 140000, 8),
              m.SparseFeat("s4", 37, 8)]
    dense = [m.DenseFeat("d0", 1), m.DenseFeat("d1", 1), m.DenseFeat("d2", 1)]
    linear = sparse + [m.SparseFeat("lin_only", 50, 8)] + dense
    return linear, sparse + dense


def _inputs(cols, n, rng):
    """{name: column} with ids in range (the last row at V - 1) and dense
    values in [0, 1)."""
    x = {}
    for fc in cols:
        if isinstance(fc, (dt.SparseFeat, pt.SparseFeat)):
            ids = rng.integers(0, fc.vocabulary_size, n)
            ids[-1] = fc.vocabulary_size - 1
            x[fc.name] = ids
        else:
            x[fc.name] = rng.random(n).astype(np.float32)
    return x


# ---------------------------------------------------------------------------
# (c) layers
# ---------------------------------------------------------------------------

def test_fm_matches_jax():
    # at this scale float32 cancellation in square_of_sum - sum_of_square
    # stays well inside atol
    v = np.random.default_rng(0).normal(0, 0.2, (64, 7, 16)).astype(
        np.float32)
    want = np.asarray(JFM().apply({}, v))
    got = PFM()(torch.from_numpy(v)).numpy()
    assert got.shape == (64, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid", "linear"])
def test_dnn_matches_jax(activation):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (32, 20)).astype(np.float32)
    jdnn = JDNN((32, 16), activation=activation)
    params = _redraw(jdnn.init(jax.random.PRNGKey(0), x)["params"], rng)
    want = np.asarray(jdnn.apply({"params": params}, x))
    pdnn = PDNN(20, (32, 16), activation=activation, device="cpu")
    pdnn.load_state_dict({
        "%s.%s" % (layer, "weight" if leaf == "kernel" else leaf):
            torch.from_numpy(np.ascontiguousarray(
                a.T if leaf == "kernel" else a))
        for layer, leaves in params.items() for leaf, a in leaves.items()})
    with torch.no_grad():
        got = pdnn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_dense_biases_start_at_zero_and_kernels_at_init_std():
    g = torch.Generator().manual_seed(0)
    dnn = PDNN(400, (400, 400), init_std=0.05, device="cpu", generator=g)
    for i in range(2):
        layer = getattr(dnn, "dense_%d" % i)
        assert torch.count_nonzero(layer.bias) == 0
        assert abs(layer.weight.std().item() - 0.05) < 0.002


class _JLinear(JBaseModule):
    """The JAX linear part inside its BaseModule, after the deep lookups
    (which create the shared tables it reads its fused columns from)."""

    def __call__(self, X):
        self.input_from_feature_columns(X, self.dnn_feature_columns)
        return self.linear_model(X)


def test_linear_model_matches_jax():
    jlin, jdnn = _columns(dt)
    plin, pdnn = _columns(pt)
    rng = np.random.default_rng(2)
    x = _inputs(plin, 128, rng)
    index = pt.build_input_features(plin + pdnn)
    X = np.stack([np.asarray(x[name], np.float32) for name in index], axis=1)
    jmod = _JLinear(tuple(jlin), tuple(jdnn))
    params = _redraw(jmod.init(jax.random.PRNGKey(0), X[:2])["params"], rng)
    # packed: 14 logical rows of width 9 in each 128-lane row
    assert params["embedding_dict"]["big"].shape == (10000, 128)
    assert params["linear_model"]["embedding_dict"]["lin_only"].shape == (
        50, 1)
    want = np.asarray(jmod.apply({"params": params}, X))

    pmod = PBaseModule(plin, pdnn, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in pmod.state_dict().items()
              if k != "out.bias"}   # no prediction head in this module
    pmod.load_state_dict({k: torch.from_numpy(v) for k, v in
                          jax_to_state_dict(params, shapes).items()},
                         strict=False)
    Xt = torch.from_numpy(X)
    with torch.no_grad():
        shared = pmod.linear_model(Xt, rows=pmod.shared_rows(Xt)).numpy()
        alone = pmod.linear_model(Xt).numpy()
    np.testing.assert_allclose(shared, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(alone, shared)


# ---------------------------------------------------------------------------
# (d) the whole slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype, atol", [
    ("float32", 1e-5),
    # one bf16 rounding of every matmul input, the JAX package's
    # bf16-rounded rows of small tables (its one-hot lookup), and another
    # summation order
    ("bfloat16", 2e-2),
])
def test_deepfm_predict_matches_jax(dtype, atol):
    dt.set_compute_dtype(dtype)   # restored by the conftest
    pt.set_compute_dtype(dtype)
    jlin, jdnn = _columns(dt)
    plin, pdnn = _columns(pt)
    rng = np.random.default_rng(3)
    x = _inputs(plin, 300, rng)

    jmodel = JDeepFM(jlin, jdnn, dnn_hidden_units=(32, 16))
    weights = jmodel.get_weights()
    weights["params"] = _redraw(weights["params"], rng)
    jmodel.set_weights(weights)
    want = jmodel.predict(x, batch_size=128)

    pmodel = PDeepFM(plin, pdnn, dnn_hidden_units=(32, 16), device="cpu")
    loaded = load_jax_weights(pmodel, weights)
    assert set(loaded) == set(pmodel.state_dict())
    got = pmodel.predict(x, batch_size=128)

    assert got.shape == want.shape == (300, 1) and got.dtype == np.float64
    assert want.std() > 0.1            # predictions spread, not all ~0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_predict_takes_a_flat_tensor_and_any_batch_size():
    plin, pdnn = _columns(pt)
    model = PDeepFM(plin, pdnn, dnn_hidden_units=(32, 16), init_std=0.3,
                    device="cpu")
    x = _inputs(plin, 50, np.random.default_rng(4))
    X = torch.from_numpy(model._assemble_x(x))
    assert X.shape == (50, model.input_dim) and X.dtype == torch.float32
    p = model.predict(x, batch_size=16)
    np.testing.assert_array_equal(model.predict(X, batch_size=16), p)
    # another batch size changes only the CPU matmul's blocking
    np.testing.assert_allclose(model.predict(X, batch_size=64), p, rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError):
        model.predict(X[:, 1:])
    with pytest.raises(ValueError):
        model._assemble_x({**x, "d0": x["d0"][:-1]})


def test_weights_round_trip_and_seeded_init():
    plin, pdnn = _columns(pt)
    a = PDeepFM(plin, pdnn, dnn_hidden_units=(8,), init_std=0.1, seed=7,
                device="cpu")
    b = PDeepFM(plin, pdnn, dnn_hidden_units=(8,), init_std=0.1, seed=7,
                device="cpu")
    c = PDeepFM(plin, pdnn, dnn_hidden_units=(8,), init_std=0.1, seed=8,
                device="cpu")
    wa = a.get_weights()
    for k, v in b.get_weights().items():
        np.testing.assert_array_equal(v, wa[k])
    assert not np.array_equal(c.get_weights()["dnn.dense_0.weight"],
                              wa["dnn.dense_0.weight"])
    c.set_weights(wa)
    x = _inputs(plin, 20, np.random.default_rng(5))
    np.testing.assert_array_equal(c.predict(x), a.predict(x))


def test_unpack_table_reads_the_packed_layout():
    V, W = 30, 17                       # pack 7, 9 waste lanes a row
    logical = np.arange(V * W, dtype=np.float32).reshape(V, W)
    packed = np.full((5, 128), -1.0, np.float32)
    padded = np.zeros((35, W), np.float32)
    padded[:V] = logical
    packed[:, :7 * W] = padded.reshape(5, 7 * W)
    np.testing.assert_array_equal(unpack_table(packed, V, W), logical)
    assert unpack_table(logical, V, W) is not None
    with pytest.raises(ValueError):
        unpack_table(np.zeros((6, 128), np.float32), V, W)


def test_load_jax_weights_raises_on_what_does_not_map():
    jlin, jdnn = _columns(dt)
    plin, pdnn = _columns(pt)
    weights = JDeepFM(jlin, jdnn, dnn_hidden_units=(8,)).get_weights()
    pmodel = PDeepFM(plin, pdnn, dnn_hidden_units=(8,), device="cpu")
    params = weights["params"]

    extra = {"params": {**params, "cin": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="cin/kernel"):
        load_jax_weights(pmodel, extra)
    short = {"params": {k: v for k, v in params.items() if k != "out"}}
    with pytest.raises(KeyError, match="out.bias"):
        load_jax_weights(pmodel, short)
    wrong = {"params": {**params, "dnn_linear": {"kernel": np.zeros((9, 1))}}}
    with pytest.raises(ValueError, match="dnn_linear/kernel"):
        load_jax_weights(pmodel, wrong)
    bad_table = {"params": {**params, "embedding_dict": {
        **params["embedding_dict"], "s1": np.zeros((99, 9))}}}
    with pytest.raises(ValueError, match="s1"):
        load_jax_weights(pmodel, bad_table)
    # a batch norm's statistics for a model without one
    with pytest.raises(KeyError, match="bn_0/mean"):
        load_jax_weights(pmodel, {"params": params,
                                  "batch_stats": {"bn_0": {"mean": 0}}})


def test_not_yet_ported_options_raise():
    plin, pdnn = _columns(pt)
    x = _inputs(plin, 16, np.random.default_rng(5))
    # the DNN's batch norm and Dice are ported, training included
    for kw in ({"dnn_use_bn": True}, {"dnn_activation": "dice"}):
        model = PDeepFM(plin, pdnn, dnn_hidden_units=(8,), device="cpu",
                        **kw)
        assert model.predict(x, batch_size=16).shape == (16, 1)
        model.compile("sgd", "binary_crossentropy")
        hist = model.fit(x, np.zeros(16), batch_size=16, verbose=0)
        assert np.isfinite(hist.history["loss"]).all()
    # dropout is ported (tests/test_torch_dropout.py)
    assert PDeepFM(plin, pdnn, dnn_dropout=0.5, device="cpu")._has_dropout()
    # use_hash is ported (tests/test_torch_native.py): strings hash on the
    # host; the mesh is not
    hashed = [pt.SparseFeat("h", 10, 4, use_hash=True)]
    model = PDeepFM(hashed, hashed, device="cpu")
    assert model.predict({"h": np.array(["a", "b", "a"])}).shape == (3, 1)
    # a mesh that is not a DeviceMesh, and sharding without a mesh
    for kw, err in (({"mesh": object()}, TypeError),
                    ({"shard_embeddings": True}, ValueError)):
        with pytest.raises(err):
            PDeepFM(plin, pdnn, device="cpu", **kw)


def test_gather_kernel_refuses_a_grad_enabled_call(monkeypatch):
    """A grad-enabled call is no longer refused: with a table that needs a
    gradient, ``gather_rows`` runs as ``GatherRows``, whose backward adds
    the rows' cotangent into each table's gradient with
    ``scatter_add_rows`` (one call for every table), as the JAX gather's
    ``_gather_bwd`` does.  A table without ``requires_grad`` gets none."""
    calls = []
    real = pt_gather.scatter_add_rows

    def spy(grad, targets, rows):
        calls.append(len(targets))
        return real(grad, targets, rows)
    monkeypatch.setattr(pt_gather, "scatter_add_rows", spy)
    rng = np.random.default_rng(6)
    tables = [torch.from_numpy(rng.normal(0, 1, (v, 3)).astype(np.float32))
              for v in (4, 9)]
    tables[0].requires_grad_()
    ids = np.stack([rng.integers(0, 4, 20), rng.integers(0, 9, 20)], axis=1)
    X = torch.from_numpy(ids.astype(np.float32))
    rows = pt_gather.gather_rows(X, tables, [0, 1])
    g = rng.normal(0, 1, (20, 2, 3)).astype(np.float32)
    (rows * torch.from_numpy(g)).sum().backward()
    assert calls == [2]
    want = np.zeros((4, 3), np.float32)
    np.add.at(want, ids[:, 0], g[:, 0])
    np.testing.assert_allclose(tables[0].grad.numpy(), want, rtol=1e-6,
                               atol=1e-6)
    assert tables[1].grad is None
    with torch.no_grad():
        assert not pt_gather.gather_rows(X, tables, [0, 1]).requires_grad


# ---------------------------------------------------------------------------
# (e) no JAX, (f) no silent CPU fallback
# ---------------------------------------------------------------------------

def test_port_imports_without_jax_or_the_jax_package():
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["deepctr_tpu"] = None
import deepctr_tpu_torch
for m in pkgutil.walk_packages(deepctr_tpu_torch.__path__,
                               "deepctr_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n, m in sys.modules.items() if m is not None and (
    n.split(".")[0] in ("jax", "jaxlib", "flax", "deepctr_tpu")))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_deepfm_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plin, pdnn = _columns(pt)
    with pytest.raises(RuntimeError, match="CUDA"):
        PDeepFM(plin, pdnn)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_basemodel.resolve_device("cuda:0")
    assert pt_basemodel.resolve_device("cpu") == torch.device("cpu")
