"""The port's zoo models WDL, NFM, DCN, DCNMix, AutoInt, AFM, FiBiNET and
PNN (``deepctr_tpu_torch.models``) against the JAX package's: ``predict``
for every dropout-free constructor case of their ``tests/models/
<Model>_test.py`` (on that file's data layout: sparse, dense and three
pooled sequence features), ``load_jax_weights`` on each model's tree, and
the options that are not ported yet.  ``tests/test_torch_zoo_pairwise.py``
holds the predict cases of AutoInt, AFM, FiBiNET and PNN,
``tests/test_torch_zoo_train.py`` and
``tests/test_torch_zoo_loops.py`` their training.

Both packages start from the same JAX weights, redrawn at std 0.3 (PNN's
at 0.5, ``STD``), so that predictions spread.
Tolerance: predict within 1e-5 (float32; another order of sums)."""

import jax
import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu import models as jmodels
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch import models as pmodels
from deepctr_tpu_torch.utils.jax_weights import jax_path, load_jax_weights

NAMES = ("WDL", "NFM", "DCN", "DCNMix", "AutoInt", "AFM", "FiBiNET", "PNN")


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


def redraw(tree, rng, std=0.3):
    return {k: redraw(v, rng, std) if isinstance(v, dict)
            else rng.normal(0, std, np.shape(v)).astype(np.float32)
            for k, v in tree.items()}


# PNN has no linear part and reads its product layer through one narrow
# DNN: at std 0.3 its predictions spread by only 0.02-0.05
STD = {"PNN": 0.5}


def build(name, jcols, pcols, **kw):
    """The JAX model and the port's, each on its own columns (PNN takes
    only the deep ones)."""
    jcls, pcls = getattr(jmodels, name), getattr(pmodels, name)
    if name == "PNN":
        return jcls(jcols, **kw), pcls(pcols, device="cpu", **kw)
    return (jcls(jcols, jcols, **kw),
            pcls(pcols, pcols, device="cpu", **kw))


def pair(name, jcols, pcols, seed=0, **kw):
    """A JAX model with redrawn weights and the port's copy of it."""
    jm, pm = build(name, jcols, pcols, **kw)
    weights = jm.get_weights()
    weights["params"] = redraw(weights["params"],
                               np.random.default_rng(seed), STD.get(name,
                                                                    0.3))
    jm.set_weights(weights)
    loaded = load_jax_weights(pm, weights)
    assert set(loaded) == set(pm.state_dict())
    return jm, pm


def zoo_data(sparse_num, dense_num, n, seed, embedding_size=4):
    """``tests/utils.py:get_test_data``'s layout from a numpy seed:
    ``sparse_feature_<i>`` of 1-9 rows, ``dense_feature_<i>`` and the
    pooled ``sequence_{sum,mean,max}`` of 2-10 rows and maxlen 1-9 (ids
    from 0, the padding id).  Returns (JAX columns, port columns, x, y)."""
    rng = np.random.default_rng(seed)
    specs, x = [], {}
    for i in range(sparse_num):
        name, dim = "sparse_feature_%d" % i, int(rng.integers(1, 10))
        specs.append(("sparse", name, dim))
        x[name] = rng.integers(0, dim, n)
    for i in range(dense_num):
        name = "dense_feature_%d" % i
        specs.append(("dense", name, 1))
        x[name] = rng.random(n).astype(np.float32)
    for mode in ("sum", "mean", "max"):
        name = "sequence_" + mode
        dim, maxlen = int(rng.integers(1, 10)), int(rng.integers(1, 10))
        specs.append(("varlen", name, (dim + 1, maxlen, mode)))
        x[name] = rng.integers(0, dim, (n, maxlen))

    def columns(m):
        cols = []
        for kind, name, arg in specs:
            if kind == "sparse":
                cols.append(m.SparseFeat(name, arg, embedding_size))
            elif kind == "dense":
                cols.append(m.DenseFeat(name, 1))
            else:
                vocab, maxlen, mode = arg
                cols.append(m.VarLenSparseFeat(
                    m.SparseFeat(name, vocab, embedding_size),
                    maxlen=maxlen, combiner=mode))
        return cols
    return columns(dt), columns(pt), x, rng.integers(0, 2, n)


# every constructor case of tests/models/<Model>_test.py, without dropout:
# (model, sparse features, dense features, constructor arguments)
CASES = (
    [("WDL", s, d, dict(dnn_activation="prelu", dnn_hidden_units=(32, 32)))
     for s, d in ((2, 0), (0, 2), (2, 2))]
    + [("NFM", s, s, dict(dnn_hidden_units=(32,))) for s in (3, 2, 1)]
    + [("DCN", s, s, dict(cross_num=c, dnn_hidden_units=h,
                          cross_parameterization=p))
       for c, h, s, p in ((2, (32,), 2, "vector"), (1, (32,), 2, "matrix"),
                          (1, (), 2, "vector"), (0, (32,), 2, "vector"))]
    + [("DCNMix", s, s, dict(cross_num=c, dnn_hidden_units=h, low_rank=4,
                             num_experts=2))
       for c, h, s in ((2, (32,), 2), (1, (32,), 3))]
    + [("AutoInt", s, s, dict(att_layer_num=a, dnn_hidden_units=h))
       for a, h, s in ((1, (4,), 2), (0, (4,), 2), (2, (4, 4), 2),
                       (1, (), 1), (1, (4,), 1))]
    + [("AFM", s, d, dict(use_attention=a))
       for a, s, d in ((True, 3, 0), (False, 2, 0), (True, 1, 0))]
    + [("FiBiNET", 2, 2, dict(bilinear_type=b, dnn_hidden_units=(8,)))
       for b in ("all", "each", "interaction")]
    + [("PNN", s, s, dict(dnn_hidden_units=(8,), use_inner=i,
                          use_outter=o, kernel_type=k))
       for i, o, k, s in ((True, True, "mat", 2), (True, False, "mat", 2),
                          (False, True, "vec", 3), (False, True, "num", 3),
                          (False, False, "mat", 1))])


def check_predict(case):
    name, n_sparse, n_dense, kw = case
    jcols, pcols, x, _ = zoo_data(n_sparse, n_dense, 200,
                                  seed=len(name) + n_sparse)
    jm, pm = pair(name, jcols, pcols, **kw)
    want = jm.predict(x, batch_size=64)
    got = pm.predict(x, batch_size=64)
    assert got.shape == want.shape == (200, 1)
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def case_ids(cases):
    return ["%s-%d" % (c[0], i) for i, c in enumerate(cases)]


# the first four models' cases here, the others' in
# tests/test_torch_zoo_pairwise.py
FIRST = [c for c in CASES if c[0] in ("WDL", "NFM", "DCN", "DCNMix")]


@pytest.mark.parametrize("case", FIRST, ids=case_ids(FIRST))
def test_zoo_predict_matches_jax(case):
    check_predict(case)


# one model of each kind with every leaf its layers have
LEAF_CASES = {
    "WDL": dict(dnn_hidden_units=(8,), dnn_activation="prelu"),
    "NFM": dict(dnn_hidden_units=(8,)),
    "DCN": dict(dnn_hidden_units=(8,), cross_parameterization="matrix"),
    "DCNMix": dict(dnn_hidden_units=(8,), low_rank=3, num_experts=2),
    "AutoInt": dict(dnn_hidden_units=(8,), att_layer_num=2),
    "AFM": dict(attention_factor=5),
    "FiBiNET": dict(dnn_hidden_units=(8,), bilinear_type="each"),
    "PNN": dict(dnn_hidden_units=(8,), use_outter=True),
}
# the leaves kept in the JAX package's layout (no transpose)
KEPT = {"crossnet/kernels", "crossnet/bias", "crossnet/U_list",
        "crossnet/V_list", "crossnet/C_list", "crossnet/gating",
        "int_layer_1/W_Query", "int_layer_0/W_Res", "fm/attention_W",
        "fm/attention_b", "fm/projection_h", "fm/projection_p",
        "Bilinear/kernel", "outterproduct/kernel"}


@pytest.mark.parametrize("name", NAMES)
def test_load_jax_weights_maps_every_zoo_leaf(name):
    """A JAX tree loads with no leaf left over and no weight left
    unfilled; the interaction layers' stacked and square leaves keep their
    layout, ``Dense`` kernels (``SE/reduce``, ``dnn_linear``) are
    transposed, and jax_path gives back the JAX leaf of every weight."""
    n_dense = 0 if name == "AFM" else 2
    jcols, pcols, x, _ = zoo_data(3, n_dense, 16, seed=7)
    jm, pm = build(name, jcols, pcols, **LEAF_CASES[name])
    params = jm.get_weights()["params"]
    state = load_jax_weights(pm, {"params": params})
    assert set(state) == set(pm.state_dict())
    leaves = {"/".join(str(k.key) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {jax_path(k) for k in pm.state_dict()} == set(leaves)
    for key, value in state.items():
        leaf = leaves[jax_path(key)]
        if jax_path(key) in KEPT:
            np.testing.assert_array_equal(value, leaf, err_msg=key)
        elif jax_path(key).endswith("/kernel"):
            np.testing.assert_array_equal(value, leaf.T, err_msg=key)
    assert any(jax_path(k) in KEPT for k in state) == (name not in (
        "WDL", "NFM"))
    before = pm.predict(x)
    pm.set_weights(pm.get_weights())
    np.testing.assert_array_equal(pm.predict(x), before)


# each model's dropout arguments, and one that is no dropout
DROPOUTS = {"WDL": ["dnn_dropout"], "NFM": ["dnn_dropout", "bi_dropout"],
            "DCN": ["dnn_dropout"], "DCNMix": ["dnn_dropout"],
            "AutoInt": ["dnn_dropout"], "AFM": ["afm_dropout"],
            "FiBiNET": ["dnn_dropout"], "PNN": ["dnn_dropout"]}


@pytest.mark.parametrize("name", NAMES)
def test_zoo_options_not_ported_raise(name, monkeypatch):
    """Dropout above 0, ``mesh`` and ``shard_embeddings`` raise (ROADMAP
    section 1 items 4 and 9); without ``device`` a model asks for CUDA
    and raises where it is absent."""
    n_dense = 0 if name == "AFM" else 1
    _, cols, _, _ = zoo_data(3, n_dense, 8, seed=8)
    pcls = getattr(pmodels, name)
    args = (cols,) if name == "PNN" else (cols, cols)
    for kw in ([{k: 0.5} for k in DROPOUTS[name]]
               + [{"mesh": object()}, {"shard_embeddings": True}]):
        with pytest.raises(NotImplementedError):
            pcls(*args, device="cpu", **kw)
    pcls(*args, device="cpu", **{k: 0 for k in DROPOUTS[name]})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pcls(*args)


def test_zoo_constructors_raise_where_the_jax_models_do():
    _, cols, _, _ = zoo_data(3, 1, 8, seed=9)
    with pytest.raises(ValueError):
        pmodels.AutoInt(cols, cols, att_layer_num=0, dnn_hidden_units=(),
                        device="cpu")
    with pytest.raises(ValueError):
        pmodels.PNN(cols, kernel_type="tensor", device="cpu")
    with pytest.raises(ValueError):
        pmodels.DCN(cols, cols, cross_parameterization="diagonal",
                    device="cpu")
    with pytest.raises(NotImplementedError):
        pmodels.FiBiNET(cols, cols, bilinear_type="pairwise", device="cpu")
    model = pmodels.AFM(cols, cols, device="cpu")
    x = {c.name: np.zeros((4, getattr(c, "maxlen", 1)), np.float32)
         for c in cols}
    with pytest.raises(ValueError, match="DenseFeat"):
        model.predict(x)
