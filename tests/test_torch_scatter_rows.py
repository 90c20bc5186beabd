"""The port's row scatter of the scatter micro-benchmark
(deepctr_tpu_torch/ops/scatter_rows.py, tools/scatter_micro.py) against the
JAX package's: ``static_scatter_ref`` bit for bit against the static
scatter of ``tools/scatter_issue_micro.py`` in interpret mode, the dynamic
variants against the same copies cut at their counts, and the tool's
phases at a tiny shape.

On the CPU the wrappers take their plain versions; the CUDA kernel
(``csrc/static_scatter.cu``) is held against them on the card by
``chip_smoke.py``.  Copies are exact, so everything is held bit for bit."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepctr_tpu_torch.ops import scatter_rows as sr
from deepctr_tpu_torch.tools import scatter_micro

REPO = Path(__file__).resolve().parent.parent


def _jax_tool():
    """tools/scatter_issue_micro.py, loaded by its path (tools/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        "scatter_issue_micro", REPO / "tools" / "scatter_issue_micro.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _case(seed, pairs=3000, n=1024, nv=700, L=2, W=128):
    """A [(pairs + 1) * L, W] table, vals [n*L, W] and starts [n] int32 as
    the tool builds them: nv sorted distinct pair rows, then the dump row
    past the table."""
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 0.01, ((pairs + 1) * L, W)).astype(np.float32)
    vals = rng.normal(0, 0.01, (n * L, W)).astype(np.float32)
    starts = np.full(n, pairs * L, np.int32)
    starts[:nv] = np.sort(rng.choice(pairs, nv, replace=False)) * L
    return table, vals, starts


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("unroll", [1, 8])
def test_static_scatter_ref_is_bit_equal_to_the_tools_kernel(unroll):
    table, vals, starts = _case(unroll)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_tool().static_scatter(jnp.asarray(table),
                                          jnp.asarray(vals),
                                          jnp.asarray(starts), unroll)
    got = sr.static_scatter_ref(torch.from_numpy(table.copy()),
                                torch.from_numpy(vals),
                                torch.from_numpy(starts))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the dump row holds the last padding slot's rows; the others are
    # untouched where no slot names them
    dump = starts[-1]
    np.testing.assert_array_equal(got[dump:dump + 2].numpy(), vals[-2:])
    named = np.zeros(len(table), bool)
    named[(starts[:, None] + np.arange(2)).reshape(-1)] = True
    np.testing.assert_array_equal(got.numpy()[~named], table[~named])


def _loop(table, vals, starts, counts, L):
    """The copies one slot at a time, group by group."""
    out = table.copy()
    vals = vals.reshape(-1, vals.shape[-2], vals.shape[-1])
    starts = starts.reshape(len(vals), -1)
    for g, count in enumerate(counts):
        for j in range(min(int(count), starts.shape[1])):
            s = starts[g, j]
            out[s:s + L] = vals[g, j * L:(j + 1) * L]
    return out


def test_dynamic_variants_copy_the_valid_slots_only():
    table, vals, starts = _case(3, pairs=200, n=64, nv=40, L=2, W=6)
    t = torch.from_numpy
    sr.SCATTER_ROWS_LAUNCHES = 0
    got = sr.scatter_rows(t(table.copy()), t(vals), t(starts),
                          t(np.array([40], np.int32)), L=2)
    np.testing.assert_array_equal(got.numpy(),
                                  _loop(table, vals, starts, [40], 2))
    # three groups into one arena; a count past n takes every slot
    vals3 = np.stack([vals, vals + 1, vals + 2])
    starts3 = np.stack([starts, starts[::-1].copy(), starts])
    counts = np.array([40, 0, 70], np.int32)
    want = _loop(table, vals3, starts3, counts, 2)
    got = sr.scatter_rows(t(table.copy()), t(vals3), t(starts3), t(counts),
                          L=2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sr.scatter_rows_ref(t(table.copy()), t(vals3), t(starts3), t(counts),
                            L=2).numpy(), want)
    assert sr.SCATTER_ROWS_LAUNCHES == 0


def test_static_scatter_on_the_cpu_takes_the_plain_version():
    """Overlapping slots (later wins, row by row), any row width, groups
    in one call, the counter untouched; bad arguments raise."""
    rng = np.random.default_rng(4)
    table = rng.normal(0, 1, (30, 5)).astype(np.float32)
    vals = rng.normal(0, 1, (2, 6 * 3, 5)).astype(np.float32)
    starts = np.array([[0, 1, 27, 4, 4, 10], [9, 0, 12, 20, 27, 3]],
                      np.int32)
    want = _loop(table, vals, starts, [6, 6], 3)
    sr.STATIC_SCATTER_LAUNCHES = 0
    got = sr.static_scatter(torch.from_numpy(table.copy()),
                            torch.from_numpy(vals), torch.from_numpy(starts),
                            unroll=4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert sr.STATIC_SCATTER_LAUNCHES == 0
    t = torch.from_numpy
    with pytest.raises(ValueError):
        sr.static_scatter_ref(t(table.copy()), t(vals),
                              t(np.array([[0, 1, 28, 4, 4, 10]] * 2,
                                         np.int32)))
    with pytest.raises(ValueError):
        sr.static_scatter_ref(t(table.copy()), t(vals[:, :-1]), t(starts))
    with pytest.raises(ValueError):
        sr.static_scatter_ref(t(table[:, :4].copy()), t(vals), t(starts))
    with pytest.raises(ValueError):
        sr.static_scatter_ref(t(table.copy()), t(vals).double(), t(starts))


def test_the_tools_phases_at_a_tiny_shape():
    """The micro-benchmark's inputs and phases on CPU tensors (the timing
    itself needs the card): every scatter phase leaves the arena the plain
    copies give, and the gather and the adagrad math have their shapes."""
    inp = scatter_micro.make_inputs(seed=5, device="cpu", g=3, r=50, n=16,
                                    nv=9)
    arena0 = inp["arena"].clone()
    assert tuple(inp["arena"].shape) == ((3 * 50 + 1) * 2, 128)
    assert bool((inp["starts"][:, 9:] == 3 * 50 * 2).all())
    valid = inp["starts"][:, :9]
    assert bool((valid[:, 1:] > valid[:, :-1]).all())
    runs = scatter_micro.phases(inp)
    assert list(runs) == ["pair_gather", "math", "scatter_dyn_per_table",
                          "scatter_dyn_arena", "scatter_static_u1",
                          "scatter_static_u2", "scatter_static_u4",
                          "scatter_static_u8"]
    assert tuple(runs["pair_gather"][0]().shape) == (27, 2, 128)
    assert tuple(runs["math"][0]().shape) == (27, 2, 128)
    a, v, s = arena0.numpy(), inp["vals"].numpy(), inp["starts"].numpy()
    dyn = _loop(a, v, s, [9, 9, 9], 2)
    for name in ("scatter_dyn_per_table", "scatter_dyn_arena"):
        inp["arena"].copy_(arena0)
        runs[name][0]()
        np.testing.assert_array_equal(inp["arena"].numpy(), dyn, name)
    inp["arena"].copy_(arena0)
    runs["scatter_static_u8"][0]()
    np.testing.assert_array_equal(inp["arena"].numpy(),
                                  _loop(a, v, s, [16, 16, 16], 2))
    assert runs["scatter_static_u1"][1] == 3 * 16
    assert runs["scatter_dyn_arena"][1] == 3 * 9


def test_the_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        scatter_micro.main([])
