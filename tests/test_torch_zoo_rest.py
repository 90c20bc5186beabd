"""The rest of the port's zoo, ONN, CCPM, AFN, IFM, DIFM and MLR
(``deepctr_tpu_torch.models``), against the JAX package's: ``predict`` for
every constructor case of their ``tests/models/<Model>_test.py`` (on that
file's data layout; the cases' dropout is kept, and is the identity at
inference), ``load_jax_weights`` on each model's tree, and the options
that raise.  ONN, CCPM and AFN predict here, IFM, DIFM and MLR in
``tests/test_torch_zoo_rest_fm.py``; ``tests/test_torch_zoo_rest_train.py``
holds their training, ``tests/test_torch_zoo_rest_loops.py`` the device
loop.

Both packages start from the same JAX weights, redrawn at std 0.3
(MLR's at 1.0, ``STD``), so that predictions spread.
Tolerance: predict within 1e-5 (float32; another order of sums)."""

import jax
import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu import models as jmodels
from deepctr_tpu_torch import models as pmodels
from deepctr_tpu_torch.utils.jax_weights import jax_path, load_jax_weights
from tests.test_torch_zoo import redraw, zoo_data
from tests.test_torch_zoo import _restore_port_config  # noqa: F401

NAMES = ("ONN", "CCPM", "AFN", "IFM", "DIFM", "MLR")


def mlr_data(parts, n, seed):
    """``tests/models/MLR_test.py``'s data: ``parts`` is ``{prefix:
    (sparse, dense, sequence modes)}``, each a ``get_test_data`` layout
    with its prefix, ids from a numpy seed.  Returns ({prefix: JAX
    columns}, {prefix: port columns}, x, y)."""
    rng = np.random.default_rng(seed)
    jcols, pcols, x = {}, {}, {}
    for prefix, (n_sparse, n_dense, modes) in parts.items():
        specs = []
        for i in range(n_sparse):
            name, dim = prefix + "sparse_feature_%d" % i, int(
                rng.integers(1, 10))
            specs.append(("sparse", name, dim))
            x[name] = rng.integers(0, dim, n)
        for i in range(n_dense):
            name = prefix + "dense_feature_%d" % i
            specs.append(("dense", name, 1))
            x[name] = rng.random(n).astype(np.float32)
        for mode in modes:
            name = prefix + "sequence_" + mode
            dim, maxlen = int(rng.integers(1, 10)), int(rng.integers(1, 10))
            specs.append(("varlen", name, (dim + 1, maxlen, mode)))
            x[name] = rng.integers(0, dim, (n, maxlen))
        for m, out in ((dt, jcols), (pt, pcols)):
            out[prefix] = [
                m.SparseFeat(name, arg, 4) if kind == "sparse" else
                m.DenseFeat(name, 1) if kind == "dense" else
                m.VarLenSparseFeat(m.SparseFeat(name, arg[0], 4),
                                   maxlen=arg[1], combiner=arg[2])
                for kind, name, arg in specs]
    return jcols, pcols, x, rng.integers(0, 2, n)


def build(name, jcols, pcols, **kw):
    """The JAX model and the port's.  MLR's columns are ``{"region":,
    "base":, "bias":}`` (base and bias may be absent)."""
    jcls, pcls = getattr(jmodels, name), getattr(pmodels, name)
    if name == "MLR":
        def args(cols):
            return (cols["region"], cols.get("base"), cols.get("bias"))
        return (jcls(*args(jcols), **kw),
                pcls(*args(pcols), device="cpu", **kw))
    return (jcls(jcols, jcols, **kw),
            pcls(pcols, pcols, device="cpu", **kw))


def pair(name, jcols, pcols, seed=0, std=0.3, **kw):
    """A JAX model with redrawn weights and the port's copy of it."""
    jm, pm = build(name, jcols, pcols, **kw)
    weights = jm.get_weights()
    weights["params"] = redraw(weights["params"],
                               np.random.default_rng(seed), std)
    jm.set_weights(weights)
    loaded = load_jax_weights(pm, weights)
    assert set(loaded) == set(pm.state_dict())
    return jm, pm


# every constructor case of tests/models/<Model>_test.py: (model, sparse
# features, dense features, sequence features, constructor arguments); for
# MLR the region/base/bias layouts
CASES = (
    [("ONN", s, s, True, dict(dnn_hidden_units=h, dnn_dropout=0.5))
     for h, s in (((8,), 2), ((8, 8), 3))]
    + [("CCPM", s, 0, q, dict(conv_kernel_width=(3, 2), conv_filters=(2, 1),
                              dnn_hidden_units=(32,), dnn_dropout=0.5))
       for s, q in ((3, True), (2, False))]
    + [("AFN", 3, d, True, dict(ltl_hidden_size=32,
                                afn_dnn_hidden_units=(32, 16),
                                dnn_dropout=0.5))
       for d in (0, 3)]
    + [("IFM", s, s, True, dict(dnn_hidden_units=(32,), dnn_dropout=0.5))
       for s in (3, 2, 1)]
    + [("DIFM", s, s, True, dict(att_head_num=a, dnn_hidden_units=h,
                                 dnn_dropout=0.5))
       for a, h, s in ((1, (4,), 2), (2, (4, 4), 2), (1, (4,), 1))]
    + [("MLR", dict(region=(rs, rd, ("mean",)), base=(bs, bd, ()),
                    bias=(cs, cd, ())), None, None, {})
       for rs, rd, bs, bd, cs, cd in ((0, 2, 0, 2, 0, 1), (0, 1, 1, 0, 2, 0),
                                      (1, 0, 2, 2, 2, 1), (2, 0, 2, 0, 0, 0))]
    + [("MLR", dict(region=(2, 2, ("sum", "mean", "max"))), None, None,
        {})])


def case_data(case, n, seed):
    name, n_sparse, n_dense, seq, _ = case
    if name == "MLR":
        return mlr_data(n_sparse, n, seed)
    jcols, pcols, x, y = zoo_data(n_sparse, n_dense, n, seed)
    if not seq:
        keep = [c.name for c in jcols if not isinstance(
            c, dt.VarLenSparseFeat)]
        jcols = [c for c in jcols if c.name in keep]
        pcols = [c for c in pcols if c.name in keep]
        x = {k: v for k, v in x.items() if k in keep}
    return jcols, pcols, x, y


# MLR's logits are sums of a few width-1 rows and dense weights: at std 0.3
# its predictions spread by only 0.01
STD = {"MLR": 1.0}


def check_predict(case, i):
    name, kw = case[0], case[4]
    jcols, pcols, x, _ = case_data(case, 200, seed=len(name) + i)
    jm, pm = pair(name, jcols, pcols, std=STD.get(name, 0.3), **kw)
    want = jm.predict(x, batch_size=64)
    got = pm.predict(x, batch_size=64)
    assert got.shape == want.shape == (200, 1)
    assert want.std() > 0.02
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def case_ids(cases):
    return ["%s-%d" % (c[0], i) for i, c in enumerate(cases)]


FIRST = [c for c in CASES if c[0] in ("ONN", "CCPM", "AFN")]


@pytest.mark.parametrize("i", range(len(FIRST)), ids=case_ids(FIRST))
def test_zoo_rest_predict_matches_jax(i):
    check_predict(FIRST[i], i)


# one case of each model with every leaf its layers have
LEAF_CASES = {
    "ONN": dict(dnn_hidden_units=(8,), dnn_use_bn=True),
    "CCPM": dict(conv_kernel_width=(3, 2), conv_filters=(2, 2),
                 dnn_hidden_units=(8,)),
    "AFN": dict(ltl_hidden_size=6, afn_dnn_hidden_units=(8,)),
    "IFM": dict(dnn_hidden_units=(8,)),
    "DIFM": dict(dnn_hidden_units=(8,), att_head_num=2),
    "MLR": dict(region_num=3),
}
# the leaves kept in the JAX package's layout (no transpose); the others
# named kernel are a Dense layer's, transposed
KEPT = ("conv_layer/conv_", "vector_wise_net/W_")


@pytest.mark.parametrize("name", NAMES)
def test_load_jax_weights_maps_every_leaf_of_the_rest(name):
    """A JAX tree (batch statistics included) loads with no leaf left over
    and no weight left unfilled; the convolution kernels (OIHW), the
    attention's squares and ONN's [V, F-1, E] pair tables keep their
    layout, ``Dense`` kernels are transposed; jax_path gives back the JAX
    leaf of every weight.  MLR holds only its linear models."""
    if name == "MLR":
        jcols, pcols, x, _ = mlr_data({"region": (3, 2, ("mean",)),
                                       "base": (2, 1, ()),
                                       "bias": (1, 1, ())}, 16, seed=7)
    else:
        jcols, pcols, x, _ = zoo_data(3, 0 if name == "CCPM" else 2, 16,
                                      seed=7)
    jm, pm = build(name, jcols, pcols, **LEAF_CASES[name])
    weights = jm.get_weights()
    state = load_jax_weights(pm, weights)
    assert set(state) == set(pm.state_dict())
    params = weights["params"]
    leaves = {"/".join(str(k.key) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(
                  params)[0]}
    assert {jax_path(k) for k, _ in pm.named_parameters()} == set(leaves)
    for key, value in state.items():
        path = jax_path(key)
        if path not in leaves:
            continue                           # a batch statistic
        if path.endswith("/kernel") and not path.startswith(KEPT):
            np.testing.assert_array_equal(value, leaves[path].T,
                                          err_msg=key)
        else:
            np.testing.assert_array_equal(value, leaves[path], err_msg=key)
    if name == "ONN":
        pairs = [p for p in leaves if p.startswith("second_order_embedding")]
        assert len(pairs) == 3
        assert all(leaves[p].shape[1:] == (2, 4) for p in pairs)
    if name == "MLR":
        assert {p.split("/")[0] for p in leaves} == {
            "region_linear_0", "region_linear_1", "region_linear_2",
            "base_linear_0", "base_linear_1", "base_linear_2",
            "bias_linear"}
        assert "region_linear_0/weight" in leaves
    before = pm.predict(x)
    pm.set_weights(pm.get_weights())
    np.testing.assert_array_equal(pm.predict(x), before)


# each model's dropout arguments
DROPOUTS = {"ONN": ["dnn_dropout"], "CCPM": ["dnn_dropout"],
            "AFN": ["dnn_dropout"], "IFM": ["dnn_dropout"],
            "DIFM": ["dnn_dropout"], "MLR": []}


@pytest.mark.parametrize("name", NAMES)
def test_zoo_rest_options_not_ported_raise(name, monkeypatch):
    """A ``mesh`` that is not a ``DeviceMesh`` and ``shard_embeddings``
    without one raise (the mesh runs: tests/test_torch_parallel.py);
    dropout builds; without ``device`` a model asks for CUDA and raises
    where it is absent."""
    _, cols, _, _ = zoo_data(3, 0 if name == "CCPM" else 1, 8, seed=8)
    pcls = getattr(pmodels, name)
    args = (cols,) if name == "MLR" else (cols, cols)
    # a mesh that is not a DeviceMesh, and sharding without a mesh
    for kw, err in (({"mesh": object()}, TypeError),
                    ({"shard_embeddings": True}, ValueError)):
        with pytest.raises(err):
            pcls(*args, device="cpu", **kw)
    model = pcls(*args, device="cpu", **{k: 0.5 for k in DROPOUTS[name]})
    assert model._has_dropout() == bool(DROPOUTS[name])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pcls(*args)


def test_zoo_rest_constructors_raise_where_the_jax_models_do():
    _, cols, _, _ = zoo_data(3, 1, 8, seed=9)
    with pytest.raises(ValueError):
        pmodels.CCPM(cols, cols, conv_kernel_width=(3,),
                     conv_filters=(2, 2), device="cpu")
    for cls in (pmodels.IFM, pmodels.DIFM):
        with pytest.raises(ValueError):
            cls(cols, cols, dnn_hidden_units=(), device="cpu")
    with pytest.raises(ValueError):
        pmodels.MLR(cols, region_num=1, device="cpu")
    # use_hash is ported: MLR hashes its bias columns too
    hashed = [pt.SparseFeat("h", 10, 4, use_hash=True)]
    model = pmodels.MLR(cols, bias_feature_columns=hashed, device="cpu")
    assert set(model._hash_feats) == {"h"}
    # CCPM's convolution takes sparse fields only, as the JAX model's
    model = pmodels.CCPM(cols, cols, device="cpu")
    x = {c.name: np.zeros((4, getattr(c, "maxlen", 1)), np.float32)
         for c in cols}
    with pytest.raises(ValueError, match="DenseFeat"):
        model.predict(x)
