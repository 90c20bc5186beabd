"""The port's multi-table row gather (deepctr_tpu_torch/ops/gather.py)
against the JAX package's Pallas gather and against numpy indexing.

On the CPU the wrapper runs its plain version; the CUDA kernel itself is
checked on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from deepctr_tpu.ops import pallas_gather as PG
from deepctr_tpu_torch import config as pt_config
from deepctr_tpu_torch.ops import _build
from deepctr_tpu_torch.ops import gather as G


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = pt_config._COMPUTE_DTYPE
    yield
    pt_config._COMPUTE_DTYPE = saved


@pytest.mark.parametrize("W", [16, 32])
def test_gather_rows_ref_matches_jax_pallas_gather(W):
    V, n = 4096, 2048
    rng = np.random.default_rng(W)
    table = rng.normal(0, 1, (V, W)).astype(np.float32)
    ids = rng.integers(0, V, n).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(PG.gather_rows(jnp.asarray(table),
                                         jnp.asarray(ids)))
    X = torch.from_numpy(ids.astype(np.float32)[:, None])
    got = G.gather_rows(X, [torch.from_numpy(table)], [0])
    assert got.shape == (n, 1, W)
    np.testing.assert_array_equal(got[:, 0].numpy(), want)


def test_gather_rows_many_tables_truncation_and_out_of_range():
    rng = np.random.default_rng(1)
    vocabs = [3, 50, 1000]
    tables = [rng.normal(0, 1, (v, 9)).astype(np.float32) for v in vocabs]
    B = 64
    X = rng.normal(0, 1, (B, 5)).astype(np.float32)   # cols 1 and 3 dense
    cols = [0, 2, 4]
    for t, c in zip(vocabs, cols):
        X[:, c] = rng.integers(0, t, B)
    X[0, 0] = 2.7            # truncates to 2
    X[1, 0] = -0.5           # truncates to 0
    X[2, 2] = 50.0           # == V: out of range
    X[3, 4] = -1.0           # negative: out of range
    X[4, 4] = 999.0          # V - 1
    got = G.gather_rows(torch.from_numpy(X),
                        [torch.from_numpy(t) for t in tables], cols).numpy()
    assert got.shape == (B, 3, 9)
    for f, (t, c) in enumerate(zip(tables, cols)):
        ids = np.trunc(X[:, c]).astype(np.int64)
        bad = (ids < 0) | (ids >= t.shape[0])
        assert np.isnan(got[bad, f]).all()
        np.testing.assert_array_equal(got[~bad, f], t[ids[~bad]])
    np.testing.assert_array_equal(got[0, 0], tables[0][2])
    np.testing.assert_array_equal(got[1, 0], tables[0][0])
    assert np.isnan(got[2, 1]).all() and np.isnan(got[3, 2]).all()
    np.testing.assert_array_equal(got[4, 2], tables[2][999])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(monkeypatch):
    def no_kernel(name):
        raise AssertionError("the CPU path must not load a kernel")
    monkeypatch.setattr(_build, "load", no_kernel)
    before = _build.LAUNCHES["gather_rows"]
    X = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    tables = [torch.arange(6.0).reshape(3, 2), torch.arange(4.0).reshape(2, 2)]
    out = G.gather_rows(X, tables, [0, 1])
    torch.testing.assert_close(out, G.gather_rows_ref(X, tables, [0, 1]),
                               rtol=0, atol=0)
    assert _build.LAUNCHES["gather_rows"] == before


@pytest.mark.parametrize("tables, cols", [
    ([torch.zeros(3, 2), torch.zeros(3, 4)], [0, 1]),      # two widths
    ([torch.zeros(3, 2)], [0, 1]),                          # count mismatch
    ([torch.zeros(3, 2)], [5]),                              # column outside X
    ([torch.zeros(3, 2, dtype=torch.float64)], [0]),         # not float32
])
def test_gather_rows_rejects_bad_arguments(tables, cols):
    with pytest.raises(ValueError):
        G.gather_rows(torch.zeros(4, 2), tables, cols)


def test_gather_args_rebuilt_only_when_a_table_moves():
    t = [torch.zeros(3, 2), torch.zeros(5, 2)]
    m1, _ = G.kernel_args(t, [0, 1], torch.device("cpu"))
    assert m1.tolist() == [t[0].data_ptr(), t[1].data_ptr(), 0, 1, 3, 5]
    assert G.kernel_args(t, [0, 1], torch.device("cpu"))[0] is m1
    t[1] = t[1].clone()
    m2, _ = G.kernel_args(t, [0, 1], torch.device("cpu"))
    assert m2 is not m1 and m2[1].item() == t[1].data_ptr()
    # the first array stays cached, unchanged: a graph that read it keeps it
    assert G.kernel_args(t[:1] + [t[1]], [0, 1],
                         torch.device("cpu"))[0] is m2
    assert m1.tolist()[2:] == [0, 1, 3, 5]


def test_vector_rows_needs_a_width_of_four_floats_and_aligned_tables():
    """The kernel moves 16-byte units only where every row is 16-byte
    aligned: a width that is a multiple of 4 and tables that start on 16
    bytes (a table cut from another at an odd offset does not)."""
    big = torch.zeros(11, 32)
    assert G.vector_rows([big, torch.zeros(5, 32)])
    assert not G.vector_rows([torch.zeros(5, 17)])
    assert not G.vector_rows([torch.zeros(5, 2)])
    shifted = big.view(-1)[2:2 + 4 * 10].view(10, 4)
    assert shifted.is_contiguous() and not G.vector_rows([shifted])
    assert G.vector_rows([big.view(-1)[4:4 + 4 * 10].view(10, 4)])
    assert G.kernel_args([big], [0], torch.device("cpu"))[1]
    assert not G.kernel_args([shifted], [0], torch.device("cpu"))[1]


def test_kernel_build_names_the_library_by_source_hash_and_needs_nvcc(
        monkeypatch, tmp_path):
    src, lib = _build._paths("gather_rows")
    assert src.exists() and src.parent == _build.SRC_DIR
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("libgather_rows-") and lib.suffix == ".so"
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all(["gather_rows"])
