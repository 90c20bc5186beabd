"""The port's model-level ``input_from_feature_columns`` against the JAX
wrapper's (``deepctr_tpu/models/basemodel.py:289-306``): host input (a
dict, a list or a flat matrix), optional columns, numpy arrays out, each
embedding ``[N, 1, E]`` and each dense value ``[N, d]``.  Mirrors
``tests/test_engine_api.py::test_input_from_feature_columns_shapes`` and
holds the port's arrays to the JAX ones from the same columns, input and
weights (carried across with ``load_jax_weights`` at std 0.3) within
1e-6."""

import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu.models import DeepFM as JDeepFM
from deepctr_tpu_torch.models import DeepFM as PDeepFM
from deepctr_tpu_torch.utils.jax_weights import load_jax_weights

ATOL = 1e-6
N = 32


def _columns(m):
    return [m.SparseFeat("C1", 10, 4), m.SparseFeat("C2", 7, 4),
            m.DenseFeat("I1", 2),
            m.VarLenSparseFeat(m.SparseFeat("hist", 12, 4), maxlen=3,
                               combiner="sum")]


def _inputs(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return {"C1": rng.integers(0, 10, n), "C2": rng.integers(0, 7, n),
            "I1": rng.random((n, 2)).astype("float32"),
            "hist": rng.integers(0, 12, (n, 3)) * rng.integers(0, 2, (n, 3))}


def _redraw(tree, rng, std=0.3):
    return {k: _redraw(v, rng, std) if isinstance(v, dict)
            else rng.normal(0, std, np.shape(v)).astype(np.float32)
            for k, v in tree.items()}


def _pair(seed=1):
    jcols, pcols = _columns(dt), _columns(pt)
    jm = JDeepFM(jcols, jcols)
    weights = jm.get_weights()
    weights["params"] = _redraw(weights["params"],
                                np.random.default_rng(seed))
    jm.set_weights(weights)
    pm = PDeepFM(pcols, pcols, device="cpu")
    load_jax_weights(pm, weights)
    return jm, pm, jcols, pcols


def _assert_same(got, want, atol=ATOL):
    se, dv = got
    jse, jdv = want
    assert len(se) == len(jse) and len(dv) == len(jdv)
    for a, b in zip(se + dv, jse + jdv):
        assert isinstance(a, np.ndarray) and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _as_list(x, index):
    return [x[name] for name in index]


def _as_matrix(x, index):
    return np.concatenate([np.asarray(x[n], np.float32).reshape(N, -1)
                           for n in index], axis=1)


@pytest.mark.parametrize("form", ["dict", "list", "matrix"])
def test_input_from_feature_columns_takes_host_input_as_jax_does(form):
    jm, pm, _, _ = _pair()
    x = _inputs()
    index = list(pm.feature_index)
    arg = {"dict": lambda: x, "list": lambda: _as_list(x, index),
           "matrix": lambda: _as_matrix(x, index)}[form]()
    se, dv = pm.input_from_feature_columns(arg)
    # 2 sparse + 1 pooled varlen embeddings, each [N, 1, E]; 1 dense [N, 2]
    assert len(se) == 3 and len(dv) == 1
    for e in se:
        assert e.shape == (N, 1, 4)
    assert dv[0].shape == (N, 2)
    np.testing.assert_allclose(dv[0], x["I1"], rtol=1e-6)
    _assert_same((se, dv), jm.input_from_feature_columns(x))


def test_input_from_feature_columns_takes_explicit_columns():
    jm, pm, jcols, pcols = _pair(seed=2)
    x = _inputs(seed=3)
    got = pm.input_from_feature_columns(x, [pcols[1], pcols[3]])
    want = jm.input_from_feature_columns(x, [jcols[1], jcols[3]])
    assert len(got[0]) == 2 and got[1] == []
    _assert_same(got, want)
    # the default is dnn_feature_columns, and the model is left as it was
    pm.train()
    _assert_same(pm.input_from_feature_columns(x),
                 jm.input_from_feature_columns(x))
    assert pm.training


def test_input_from_feature_columns_after_a_sparse_fit():
    """After ``fit`` with ``sparse_table_updates=True`` the hook reads the
    updated tables: exactly the port's table rows, and the JAX hook's
    arrays within 1e-5, the spread of the two packages' 4-step
    trajectories (the backward sums in another order)."""
    jm, pm, _, _ = _pair(seed=4)
    x = _inputs(seed=5)
    y = np.random.default_rng(6).integers(0, 2, N).astype(np.float32)
    before = pm.input_from_feature_columns(x)
    for m in (jm, pm):
        m.compile("sgd", "binary_crossentropy", learning_rate=0.05,
                  sparse_table_updates=True)
        m.fit(x, y, batch_size=8, epochs=1, verbose=0, shuffle=False)
    got = pm.input_from_feature_columns(x)
    assert any(not np.array_equal(a, b) for a, b in zip(got[0], before[0]))
    _assert_same(got, jm.input_from_feature_columns(x), atol=1e-5)
    # the port's arrays are its tables' rows
    c1 = pm.embedding_dict.tables["C1"].detach()
    np.testing.assert_array_equal(
        got[0][0][:, 0], c1[torch.from_numpy(x["C1"])][:, :4].numpy())
