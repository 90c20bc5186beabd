"""The row-update scatter's cost structure, phase by phase, on one card.

    python -m deepctr_tpu_torch.tools.scatter_micro [--repeats N] [--seed S]

The port's form of ``tools/scatter_issue_micro.py``, at its shape: G = 26
tables of R = 142,858 pair rows (a 1M-row vocabulary packed 7 to a
128-lane row), each pair row L = 2 rows of 128 float32 (the weight and its
adagrad accumulator), laid end to end in one arena with a dump pair row
past them (3.8 GB); N = 5,120 slots a table, of which NV = 4,097 are
valid (sorted distinct rows) and the rest name the dump row.  Each phase
is timed alone, in device time by CUDA events, median of ``--repeats``:

- ``pair_gather``: the pair rows of every valid slot (``index_select``);
- ``math``: the adagrad row step alone, on pairs gathered beforehand;
- ``scatter_dyn_per_table``: the dynamic-count scatter
  (``ops.scatter_rows.scatter_rows``), one launch a table;
- ``scatter_dyn_arena``: the same over all tables in one launch;
- ``scatter_static_u{1,2,4,8}``: the static-trip-count scatter
  (``static_scatter``) over all tables in one launch, every slot written,
  with each lane holding 1, 2, 4 or 8 slots' loads in flight.

Prints one JSON line a phase, ``{"phase", "ms", "ns_per_row"}``: rows are
the slots the phase handles (G * N for the static scatter, G * NV for the
others).  Without a CUDA device it raises.
"""

import argparse
import json
import statistics

import torch

from ..ops import scatter_rows as sr

G = 26
R = 142858           # pair rows a table (vocabulary 1M, 7 rows a pair row)
N = 5120             # slots a table
NV = 4097            # valid slots a table
L = 2
W = 128


def make_inputs(seed=0, device="cuda", g=G, r=R, n=N, nv=NV):
    """The arena [(g*r + 1) * L, W], vals [g, n*L, W], starts [g, n] int32
    (valid slots at sorted distinct rows of their table, then the dump
    row), n_valids [g] int32, the valid slots' pair rows and a gradient
    [g*nv, W], all made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pairs = g * r
    arena = 0.01 * torch.randn((pairs + 1) * L, W, generator=gen,
                               device=device)
    vals = 0.01 * torch.randn(g, n * L, W, generator=gen, device=device)
    rows = torch.stack([torch.randperm(r, generator=gen, device=device)[:nv]
                        .sort().values for _ in range(g)])
    tables = torch.arange(g, device=device)[:, None] * r
    starts = torch.full((g, n), pairs * L, dtype=torch.int64, device=device)
    starts[:, :nv] = (tables + rows) * L
    return {
        "arena": arena, "vals": vals, "starts": starts.to(torch.int32),
        "n_valids": torch.full((g,), nv, dtype=torch.int32, device=device),
        "pair_rows": (tables + rows).reshape(-1),
        "grad": 0.01 * torch.randn(g * nv, W, generator=gen, device=device),
        "shape": (g, r, n, nv)}


def time_ms(fn, repeats=20, inner=5):
    """Median over ``repeats`` of the mean device time of ``inner`` calls
    (CUDA events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phases(inp):
    """``{phase: (fn, rows)}`` over the inputs of :func:`make_inputs`."""
    arena, vals, starts = inp["arena"], inp["vals"], inp["starts"]
    nvs, grows, grad = inp["n_valids"], inp["pair_rows"], inp["grad"]
    g, _, n, nv = inp["shape"]
    pair_view = arena.view(-1, L, W)
    pairs0 = pair_view.index_select(0, grows)

    def math():
        w, a = pairs0[:, 0], pairs0[:, 1]
        gp = grad + 2e-5 * w
        a2 = a + gp * gp
        wn = w - 0.01 * gp * torch.rsqrt(a2 + 1e-10)
        return torch.stack([wn, a2], dim=1)

    def per_table():
        for t in range(g):
            sr.scatter_rows(arena, vals[t], starts[t], nvs[t:t + 1], L=L)

    out = {
        "pair_gather": (lambda: pair_view.index_select(0, grows), g * nv),
        "math": (math, g * nv),
        "scatter_dyn_per_table": (per_table, g * nv),
        "scatter_dyn_arena": (lambda: sr.scatter_rows(
            arena, vals, starts, nvs, L=L), g * nv),
    }
    for u in sr.UNROLLS:
        out["scatter_static_u%d" % u] = (
            lambda u=u: sr.static_scatter(arena, vals, starts, unroll=u),
            g * n)
    return out


def run(inp, repeats=20):
    """Times every phase; returns the records, one a phase."""
    records = []
    with torch.no_grad():
        for name, (fn, rows) in phases(inp).items():
            ms = time_ms(fn, repeats)
            records.append({"phase": name, "ms": ms,
                            "ns_per_row": ms * 1e6 / rows})
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scatter_micro: no CUDA device; it measures the "
                         "card")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    inp = make_inputs(args.seed)
    for rec in run(inp, args.repeats):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
