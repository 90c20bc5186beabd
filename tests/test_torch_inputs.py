"""The port's EmbeddingDict (deepctr_tpu_torch/inputs.py) against the JAX
package's, over tiny, small and packed big tables with fused wide
columns."""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import deepctr_tpu as dt
import deepctr_tpu_torch as pt
from deepctr_tpu.inputs import EmbeddingDict as JEmbeddingDict, sparse_ids
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch import inputs as pt_inputs
from deepctr_tpu_torch.utils.jax_weights import unpack_table


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


def _columns(m):
    """E in {8, 16} with every table fused (widths 9 and 17, neither
    dividing 128 when packed); one packed table of each width, and one
    feature that shares another's table."""
    return [m.SparseFeat("tiny", 3, 8), m.SparseFeat("small", 1000, 16),
            m.SparseFeat("small8", 500, 8),
            m.SparseFeat("big", 140000, 16),
            m.SparseFeat("big8", 131072, 8),
            m.SparseFeat("small_again", 1000, 16, embedding_name="small")]


class _Lookups(fnn.Module):
    """Deep and wide lookups of every column through a JAX EmbeddingDict,
    as a model makes them."""
    cols: tuple
    wide_names: tuple

    @fnn.compact
    def __call__(self, X):
        ed = JEmbeddingDict(self.cols, 1e-4, wide_names=self.wide_names,
                            name="embedding_dict")
        index = dt.build_input_features(list(self.cols))
        deep, wide = [], []
        for fc in self.cols:
            span = tuple(index[fc.name])
            ids = sparse_ids(X, span)
            deep.append(ed(fc.embedding_name, ids, key=span))
            wide.append(ed.wide(fc.embedding_name, ids, key=span))
        return deep, wide


def _data(cols, B, rng):
    X = np.stack([rng.integers(0, fc.vocabulary_size, B) for fc in cols],
                 axis=1).astype(np.float32)
    X[0] = [fc.vocabulary_size - 1 for fc in cols]
    return X


def test_embedding_dict_matches_jax_deep_and_wide_exactly():
    jcols, pcols = tuple(_columns(dt)), _columns(pt)
    wide_names = ("tiny", "small", "small8", "big", "big8")
    rng = np.random.default_rng(0)
    X = _data(pcols, 256, rng)
    jmod = _Lookups(jcols, wide_names)
    params = jmod.init(jax.random.PRNGKey(0), X[:2])["params"]
    stored = {name: rng.normal(0, 0.3, np.shape(a)).astype(np.float32)
              for name, a in params["embedding_dict"].items()}
    assert stored["big"].shape == (20000, 128)        # 7 rows of 17
    assert stored["big8"].shape == (9363, 128)        # 14 rows of 9
    jdeep, jwide = jmod.apply({"params": {"embedding_dict": stored}}, X)

    ed = pt_inputs.EmbeddingDict(pcols, wide_names=wide_names, device="cpu")
    ed.load_state_dict({
        "tables." + name: torch.from_numpy(unpack_table(
            a, *ed.tables[name].shape)) for name, a in stored.items()})
    index = pt.build_input_features(pcols)
    with torch.no_grad():
        rows = ed.gather(torch.from_numpy(X), index, pcols)
    for i, fc in enumerate(pcols):
        np.testing.assert_array_equal(
            ed(fc.embedding_name, rows[fc.name]).numpy(),
            np.asarray(jdeep[i]))
        np.testing.assert_array_equal(
            ed.wide(fc.embedding_name, rows[fc.name]).numpy(),
            np.asarray(jwide[i]))


def test_embedding_lookup_matches_jax_grouped_by_group_name():
    cols = [pt.SparseFeat("a", 10, 4, group_name="g1"),
            pt.SparseFeat("b", 20, 4, group_name="g2"),
            pt.SparseFeat("c", 30, 4, group_name="g1")]
    rng = np.random.default_rng(3)
    X = torch.from_numpy(_data(cols, 16, rng))
    ed = pt_inputs.EmbeddingDict(cols, init_std=0.3, device="cpu")
    index = pt.build_input_features(cols)
    groups = pt_inputs.embedding_lookup(X, ed, index, cols)
    assert list(groups) == ["g1", "g2"]
    assert [e.shape for e in groups["g1"]] == [(16, 1, 4), (16, 1, 4)]
    ids = X[:, 2].long()
    torch.testing.assert_close(groups["g1"][1][:, 0], ed.tables["c"][ids],
                               rtol=0, atol=0)


def test_one_gather_per_row_width(monkeypatch):
    calls = []
    real = pt_inputs.gather_rows

    def spy(X, tables, cols):
        calls.append(tables[0].shape[1])
        return real(X, tables, cols)

    monkeypatch.setattr(pt_inputs, "gather_rows", spy)
    pcols = _columns(pt)
    ed = pt_inputs.EmbeddingDict(pcols, wide_names=("tiny", "small", "big"),
                                 device="cpu")
    X = torch.from_numpy(_data(pcols, 8, np.random.default_rng(1)))
    ed.gather(X, pt.build_input_features(pcols), pcols)
    # widths: 9 (tiny), 17 (small, big, small_again), 8 (small8, big8)
    assert sorted(calls) == [8, 9, 17]


def test_varlen_lookups_are_not_ported_yet():
    """Varlen lookups are ported now (the name is older): a span of
    ``maxlen`` columns gathers as ``maxlen`` fields of its table, in the
    same launch as a sparse field of that width, and ids truncate."""
    seq = pt.VarLenSparseFeat(pt.SparseFeat("hist", 10, 4,
                                            embedding_name="item"),
                              maxlen=3)
    item = pt.SparseFeat("item", 10, 4)
    cols = [item, seq]
    ed = pt_inputs.EmbeddingDict(cols, init_std=0.3, device="cpu")
    index = pt.build_input_features(cols)
    X = torch.tensor([[4., 1., 2.9, 9.], [0., 0., 0., 3.]])
    rows = ed.gather(X, index, cols)
    assert rows["item"].shape == (2, 1, 4) and rows["hist"].shape == (2, 3, 4)
    table = ed.tables["item"]
    torch.testing.assert_close(rows["hist"], table[X[:, 1:].long()],
                               rtol=0, atol=0)
    seqs = pt_inputs.varlen_embedding_lookup(X, ed, index, [seq])
    torch.testing.assert_close(seqs["hist"], rows["hist"], rtol=0, atol=0)
    assert pt_inputs.varlen_embedding_lookup(X, ed, index, []) == {}
    lengths = pt_inputs.maxlen_lookup(torch.tensor([[2.7], [0.]]),
                                      {"len": (0, 1)}, ["len"])
    assert lengths.dtype == torch.int32 and lengths[:, 0].tolist() == [2, 0]
    with pytest.raises(ValueError, match="max length column"):
        pt_inputs.maxlen_lookup(X, index, [])


def test_dense_input_and_dnn_input_width_match_jax():
    jcols = [dt.SparseFeat("s", 5, 4), dt.DenseFeat("d2", 2),
             dt.DenseFeat("d1", 1)]
    pcols = [pt.SparseFeat("s", 5, 4), pt.DenseFeat("d2", 2),
             pt.DenseFeat("d1", 1)]
    from deepctr_tpu import inputs as jinputs
    X = np.random.default_rng(2).random((6, 4)).astype(np.float32)
    jd = jinputs.get_dense_input(X, dt.build_input_features(jcols), jcols)
    pd = pt_inputs.get_dense_input(torch.from_numpy(X),
                                   pt.build_input_features(pcols), pcols)
    for a, b in zip(jd, pd):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (pt_inputs.compute_input_dim(pcols)
            == jinputs.compute_input_dim(jcols) == 7)
    assert pt_inputs.embedding_size_of(pcols) == 4
    emb = [torch.ones(6, 1, 4), torch.zeros(6, 1, 4)]
    assert pt_inputs.combined_dnn_input(emb, pd).shape == (6, 11)
