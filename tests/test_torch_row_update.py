"""The row update's launch plan and by-value arguments
(``deepctr_tpu_torch/ops/row_update.py``: ``launch_plan``,
``kernel_args``) on the CPU.

The plan is expanded here as the kernel (``csrc/row_update.cu``) walks
it: a warp takes run ``r`` of a launch, finds its table as the last whose
first run is at or before ``r``, and its lanes take unit ``i = lane + 32 k``
(``k`` below the row's units) of the run's rows, a float or, on the 16-byte
route, four.  Every touched (table, row, column) element must come out
exactly once.  The kernel's arithmetic is held against the JAX package in
``tests/test_torch_train_ops.py``, and the kernel against ``row_update_ref``
on the card, past the capacity too, by ``chip_smoke.py``; here
``row_update`` on the CPU (``row_update_ref``) is held against the JAX
package's row math table by table past the capacity.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from deepctr_tpu_torch.ops import _build
from deepctr_tpu_torch.ops import row_update as RU
from deepctr_tpu_torch.tools import row_update_parts
from tests.test_torch_train_ops import _jax_rows_math


def _expand(plan, n_valid, widths, routes, capacity):
    """{(table, row, column): count} over the plan's launches, as the
    kernel's warps and lanes take them."""
    seen = {}
    for route, launch in plan:
        assert 0 < len(launch) <= capacity
        assert {routes[t] for t, _, _ in launch} == {route}
        first = [f for _, f, _ in launch]
        assert first[0] == 0 and first == sorted(set(first))
        n_runs = launch[-1][1] + launch[-1][2]
        vec = route == RU.VEC
        for run in range(n_runs):
            i_table = sum(f <= run for f in first[1:])
            t, f, runs = launch[i_table]
            assert f <= run < f + runs
            j0 = (run - f) * RU.RUN_ROWS
            n = min(RU.RUN_ROWS, n_valid[t] - j0)
            assert n > 0
            units = widths[t] // 4 if vec else widths[t]
            for lane in range(32):
                for k in range(-(-RU.RUN_ROWS * units // 32)):
                    i = lane + 32 * k
                    if i >= n * units:
                        continue
                    row, u = j0 + i // units, i % units
                    for col in (range(4 * u, 4 * u + 4) if vec else (u,)):
                        key = (t, row, col)
                        seen[key] = seen.get(key, 0) + 1
    return seen


PLAN_CASES = {
    # tables with no touched row between others
    "empty tables between": ([5, 0, 40, 0, 0, 33, 1, 0], [17] * 8),
    # every route: 17 as an instance of its own, 1 in floats, 32 and 128
    # in 16-byte units
    "widths 1 17 32 128": ([70, 64, 3, 129, 9, 17], [1, 17, 32, 128, 17, 1]),
    # one more table than a launch holds
    "capacity + 1": ([7 + 5 * t for t in range(RU.CAPACITY + 1)],
                     [17] * RU.CAPACITY + [32]),
    "capacity + 1 of one route": ([7 + 5 * t for t in range(RU.CAPACITY + 1)],
                                  [17] * (RU.CAPACITY + 1)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("capacity", [RU.CAPACITY, 2])
def test_launch_plan_covers_every_element_once(case, capacity):
    n_valid, widths = PLAN_CASES[case]
    routes = [RU.route_of(W, True) for W in widths]
    plan = RU.launch_plan(n_valid, routes, capacity)
    seen = _expand(plan, n_valid, widths, routes, capacity)
    want = {(t, j, c) for t, n in enumerate(n_valid) for j in range(n)
            for c in range(widths[t])}
    assert set(seen) == want
    assert set(seen.values()) == {1}
    per_route = {}
    for t, n in enumerate(n_valid):
        if n > 0:
            per_route.setdefault(routes[t], []).append(t)
    assert len(plan) == sum(-(-len(ts) // capacity)
                            for ts in per_route.values())
    for route, ts in per_route.items():
        assert [t for r, launch in plan if r == route
                for t, _, _ in launch] == ts


def test_launch_plan_past_the_capacity_takes_a_second_launch():
    n = RU.CAPACITY + 1
    plan = RU.launch_plan([1] * n, [RU.W17] * n)
    assert [(r, len(launch)) for r, launch in plan] == [
        (RU.W17, RU.CAPACITY), (RU.W17, 1)]
    assert plan[1][1] == [(RU.CAPACITY, 0, 1)]


@pytest.mark.parametrize("n_valid", [[0], [0, 0, 0], [0] * (RU.CAPACITY + 1)])
def test_launch_plan_of_no_touched_rows_is_empty(n_valid):
    assert RU.launch_plan(n_valid, [RU.W17] * len(n_valid)) == []


@pytest.mark.parametrize("width, aligned, route", [
    (17, True, RU.W17), (17, False, RU.W17), (32, True, RU.VEC),
    (32, False, RU.SCALAR), (128, True, RU.VEC), (8, True, RU.VEC),
    (1, True, RU.SCALAR), (33, True, RU.SCALAR)])
def test_route_of_takes_16_byte_units_only_where_the_rows_allow(
        width, aligned, route):
    assert RU.route_of(width, aligned) == route


def test_capacity_holds_every_criteo_table_and_fits_the_parameter_space():
    """The Criteo model with every table sparse (26 tables) goes in one
    launch, and the struct stays in the classic 4 KB of kernel
    parameters."""
    assert RU.CAPACITY >= 26
    assert ctypes.sizeof(RU._Args) <= 4096
    assert len(RU.launch_plan([4096] * 26, [RU.W17] * 26)) == 1


def test_the_kernel_source_declares_the_layout_the_host_mirrors():
    src = (_build.SRC_DIR / "row_update.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxTables"]) == RU.CAPACITY
    assert int(consts["kRunRows"]) == RU.RUN_ROWS
    assert "const __grid_constant__ Args" in src
    table = re.search(r"struct Table \{(.*?)\};", src, re.S).group(1)
    table = re.sub(r"//[^\n]*", "", table)
    fields = re.findall(r"(\w+);", table)
    assert fields == [name for name, _ in RU._Table._fields_]
    # what kernel_args packs covers the ctypes layout without a gap
    assert RU._TABLE.size == ctypes.sizeof(RU._Table)
    assert RU._FIRST.size == RU._Args.table.offset
    assert RU._Args.n_tables.offset + RU._HEAD.size == ctypes.sizeof(
        RU._Args)


def _tables(seed, widths, rows=(40, 90), offsets=None, touched=None):
    """Tables, touched rows (distinct; ``touched`` of each, or a random
    count), gradients and l2 vectors."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("w", "g", "r", "l2")}
    for i, W in enumerate(widths):
        V = int(rng.integers(*rows))
        n = touched or int(rng.integers(1, V))
        w = torch.from_numpy(rng.normal(size=(V, W)).astype(np.float32))
        if offsets and offsets[i]:
            buf = torch.empty(V * W + offsets[i])
            w = buf[offsets[i]:].view(V, W).copy_(w)
        out["w"].append(w)
        out["r"].append(torch.from_numpy(rng.permutation(V)[:n]
                                         .astype(np.int64)))
        out["g"].append(torch.from_numpy(
            rng.normal(size=(n, W)).astype(np.float32)))
        out["l2"].append(torch.from_numpy(
            (rng.random(W) * 1e-3).astype(np.float32)))
    return out


def test_kernel_args_pass_every_table_by_value():
    """One host struct a launch: its route, each table's pointers (adam's
    bias pair's among them), rows, capacity and W, first runs padded with
    INT_MAX, the optimizer's constants; nothing on a device."""
    widths = [17] * (RU.CAPACITY + 6) + [32, 32, 1, 128]
    d = _tables(3, widths, offsets=[1 if t == len(widths) - 3 else 0
                                    for t in range(len(widths))])
    # every ninth table from the fifth lists no row
    for key in ("r", "g"):
        d[key] = [a[:0] if t % 9 == 4 else a for t, a in enumerate(d[key])]
    n_valid = [len(r) for r in d["r"]]
    states = [(torch.zeros_like(w), torch.zeros_like(w)) for w in d["w"]]
    bias = [torch.tensor([0.5 + t / 100, 0.25 + t / 100])
            for t in range(len(widths))]
    args = RU.kernel_args("adam", d["w"], states, d["g"], d["r"], d["l2"],
                          0.01, bias)
    routes = RU.table_routes(d["w"], states, d["g"], d["r"], d["l2"])
    # the table one float past a 16-byte boundary takes floats
    assert routes[-4:] == [RU.VEC, RU.SCALAR, RU.SCALAR, RU.VEC]
    plan = RU.launch_plan(n_valid, routes)
    assert len(args) == len(plan) == 4
    for a, (route, launch) in zip(args, plan):
        assert isinstance(a, RU._Args)
        assert (a.n_tables, a.mode, a.route) == (
            len(launch), RU.MODES["adam"][0], route)
        assert a.n_runs == launch[-1][1] + launch[-1][2]
        assert list(a.first_run) == [f for _, f, _ in launch] + [
            2 ** 31 - 1] * (RU.CAPACITY - len(launch))
        assert (a.lr, a.d1, a.c1) == pytest.approx((0.01, RU.ADAM_B1,
                                                    1 - RU.ADAM_B1))
        for i, (t, _, _) in enumerate(launch):
            s = a.table[i]
            w = d["w"][t]
            assert (s.w, s.s1, s.s2, s.g, s.rows, s.l2, s.bias) == (
                w.data_ptr(), states[t][0].data_ptr(),
                states[t][1].data_ptr(), d["g"][t].data_ptr(),
                d["r"][t].data_ptr(), d["l2"][t].data_ptr(),
                bias[t].data_ptr())
            assert (s.vocab, s.capacity, s.width) == (
                w.shape[0], n_valid[t], w.shape[1])


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rmsprop", "adam"])
def test_row_update_past_the_capacity_matches_jax_table_by_table(opt):
    """More W=17 tables than a launch holds and a table of each other
    route (widths 1 to 128), some with no touched row and some with
    padding past the table among their rows: ``row_update`` in one call
    equals the JAX
    package's row math (deepctr_tpu/models/basemodel.py:1221-1258) on each
    table alone, to the rtol 1e-6 of tests/test_torch_train_ops.py (XLA's
    float32 pow for adam's bias correction may differ by an ulp), and
    leaves the untouched rows' bits."""
    widths = [17] * (RU.CAPACITY + 8) + [32, 1, 128, 8, 33]
    # one table size and three n_valid: few shapes for JAX to compile
    d = _tables(7, widths, rows=(64, 65), touched=40)
    n_valid = [0 if t % 7 == 2 else len(r) - (t % 3) * (len(r) // 4)
               for t, r in enumerate(d["r"])]
    # the rows past n_valid become padding past the table; a table of no
    # touched row lists none
    rows = [torch.cat([r[:n], w.shape[0] + torch.arange(len(r) - n)])
            if n else r[:0] for r, n, w in zip(d["r"], n_valid, d["w"])]
    grads = [g if n else g[:0] for g, n in zip(d["g"], n_valid)]
    plan = RU.launch_plan([len(r) for r in rows],
                          [RU.route_of(W, True) for W in widths])
    assert [r for r, _ in plan].count(RU.W17) == 2
    rng = np.random.default_rng(8)
    states = [tuple(torch.from_numpy(rng.random(w.shape).astype(np.float32))
                    for _ in range(RU.MODES[opt][1])) for w in d["w"]]
    bias = ([torch.tensor(RU.adam_bias_corrections(t + 1))
             for t in range(len(widths))] if opt == "adam" else None)
    got_w = [w.clone() for w in d["w"]]
    got_s = [tuple(s.clone() for s in st) for st in states]
    RU.row_update(opt, got_w, got_s, grads, rows, d["l2"], 0.01, bias)
    for t in range(len(widths)):
        want_w, want_s = _jax_rows_math(
            opt, d["w"][t].numpy(), [s.numpy() for s in states[t]],
            d["g"][t].numpy(), d["r"][t].numpy(), n_valid[t],
            d["l2"][t].numpy(), 0.01, t=t + 1)
        for a, b in zip((got_w[t],) + got_s[t], [want_w] + want_s):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
        untouched = torch.ones(d["w"][t].shape[0], dtype=torch.bool)
        untouched[d["r"][t][:n_valid[t]]] = False
        for a, a0 in zip((got_w[t],) + got_s[t], (d["w"][t],) + states[t]):
            assert torch.equal(a[untouched], a0[untouched])
        if n_valid[t]:
            assert not torch.equal(got_w[t], d["w"][t])


def test_table_routes_need_every_array_on_a_16_byte_boundary():
    a, g, l2 = torch.zeros(10, 32), torch.zeros(3, 32), torch.zeros(32)
    r = torch.zeros(5, dtype=torch.int64)[1:]    # row ids: any boundary
    off = torch.zeros(321)[1:].view(10, 32)
    assert RU.table_routes([a], [()], [g], [r], [l2]) == [RU.VEC]
    assert RU.table_routes([a], [(off,)], [g], [r], [l2]) == [RU.SCALAR]
    assert RU.table_routes([off], [()], [g], [r], [l2]) == [RU.SCALAR]


def test_row_update_parts_finds_every_part_in_the_kernel_source():
    """tools/row_update_parts.py builds the kernel with other run lengths
    and with parts cut out by editing its text: every text it replaces is
    in the source once, and each build names the run length it takes."""
    source = (_build.SRC_DIR / "row_update.cu").read_text()
    for build, (name, edits) in row_update_parts.VARIANTS.items():
        assert name == "row_update"
        for old, new in edits:
            assert source.count(old) == 1, (build, old)
            assert old != new
        rows = row_update_parts._BUILDS[build][0]
        built = source
        for old, new in edits:
            built = built.replace(old, new)
        assert "constexpr int kRunRows = %d;" % rows in built
    assert {b for b in row_update_parts.VARIANTS if b.startswith("rows")} \
        == {"rows %d" % r for r in (8, 16, 32) if r != RU.RUN_ROWS}


def test_the_generic_routes_the_parts_tool_times_cover_every_element():
    """tools/row_update_parts.py times W=17 tables on the instance for any
    width in floats (``GENERIC_ROUTES``): launched so, the plan still
    covers every element once."""
    n_valid, widths = PLAN_CASES["capacity + 1"]
    routes = [RU.route_of(W, True) for W in widths]
    generic = [row_update_parts.GENERIC_ROUTES.get(r, r) for r in routes]
    assert RU.W17 in routes and RU.W17 not in generic
    plan = [(row_update_parts.GENERIC_ROUTES.get(r, r), launch)
            for r, launch in RU.launch_plan(n_valid, routes)]
    seen = _expand(plan, n_valid, widths, generic, RU.CAPACITY)
    assert set(seen.values()) == {1}
    assert len(seen) == sum(n * W for n, W in zip(n_valid, widths))
