"""Where the row update kernel spends its time, on one card.

    python -m deepctr_tpu_torch.tools.row_update_parts [--seed S]

Builds ``csrc/row_update.cu`` as it is, with other run lengths (the
touched rows a warp takes: ``rows 8``, ``rows 16``, ``rows 32``), and
with one part taken out, and times each build on two shapes: Criteo's
(the touched rows of a batch of 4096 uniform ids, row 0 included, in the 8
Criteo tables of at least 16384 rows, W=17) and DIEN's sparse one (the
rows a batch of 1024 touches in the user, item and cate tables of
1000 / 10000 / 100 rows, W=32, histories of 100 and their negative
samples included), each table's rows at the train step's fixed capacity
``min(1 + ids, V)``, padded past the table, for sgd, adagrad and adam,
with a cold and a warm L2, in device ms, median of 20.  The parts:

- ``arithmetic``: the optimizer's math (a unit stores w + l2 g; the state
  goes back unchanged);
- ``table loads``: the table and state loads (the stores write the
  gradient);
- ``runs``: everything after a warp has found its run's table (the
  launch, its parameters and the search remain).

The build as it is is timed a second time as ``generic routes``: its W=17
tables on the instance for any width in floats instead of the one fixed to
W=17.

A build with another run length takes its own launch plan; a build
without a part computes wrong values: only its time is read.  The parts
are cut out by editing the source's text, so an edit of the kernel that
moves those lines stops this tool with the line it missed.  Prints one
JSON line a build, shape, optimizer and L2 state, ``{"build", "shape",
"optimizer", "l2", "ms"}``.  Without a CUDA device it raises.
"""

import argparse
import ctypes
import json

import torch

from ..ops import row_update as RU
from .gru_parts import build_variants, device_ms

CRITEO_SPARSE_VOCABS = (10131227, 2202608, 93145, 8351593, 5461306, 7046547,
                        286181, 142572)
CRITEO_BATCH, CRITEO_W = 4096, 17
# DIEN's sparse tables and how many ids of each a batch reads: the user,
# and the item and cate ids with their 100-step histories and negative
# samples
DIEN_TABLES = ((1000, 1024), (10000, 1024 * 201), (100, 1024 * 201))
DIEN_W = 32

_RUN_ROWS = "constexpr int kRunRows = %d;"
# build -> (run rows, [(text, replacement)])
_BUILDS = {
    "as is": (RU.RUN_ROWS, []),
    "arithmetic": (RU.RUN_ROWS, [(
        "  const float gp = __fadd_rn(g, __fmul_rn(__fmul_rn(2.0f, l2), w));",
        "  return __fadd_rn(w, __fmul_rn(l2, g));\n  const float gp = 0.0f;")]),
    "table loads": (RU.RUN_ROWS, [(
        "      wv[u] = w[at];\n"
        "      if (M != kSgd) av[u] = s1[at];\n"
        "      if (M == kAdam) bv[u] = s2[at];",
        "      wv[u] = gv[u];\n      av[u] = gv[u];\n      bv[u] = gv[u];")]),
    "runs": (RU.RUN_ROWS, [(
        "    const long long row = lane < n ? __ldg(tb.rows + j0 + lane) : 0;",
        "    if (n > 0) continue;\n    const long long row = 0;")]),
}
for _rows in (8, 16, 32):
    if _rows != RU.RUN_ROWS:
        _BUILDS["rows %d" % _rows] = (_rows, [(_RUN_ROWS % RU.RUN_ROWS,
                                               _RUN_ROWS % _rows)])
VARIANTS = {build: ("row_update", edits)
            for build, (_, edits) in _BUILDS.items()}
OPTIMIZERS = ("sgd", "adagrad", "adam")
# "generic routes": the "as is" build's launches with W=17 on the
# instance for any width in floats, in place of the one fixed to W=17
GENERIC_ROUTES = {RU.W17: RU.SCALAR}


def make_shape(tables_ids, width, gen):
    """Tables of the given rows (normal), the distinct rows the ids touch
    (row 0 included) padded past the table to the train step's capacity
    ``min(1 + ids, V)``, their gradients (normal) and l2 vectors, on the
    card."""
    tables, rows, grads, l2s = [], [], [], []
    for vocab, n_ids in tables_ids:
        tables.append(torch.randn(vocab, width, generator=gen,
                                  device="cuda"))
        ids = torch.randint(0, vocab, (n_ids,), generator=gen,
                            device="cuda")
        r = torch.unique(torch.cat([ids.new_zeros(1), ids]))
        cap = min(1 + n_ids, vocab)
        r = torch.cat([r, vocab + torch.arange(cap - r.numel(),
                                               device="cuda")])
        rows.append(r)
        grads.append(torch.randn(r.numel(), width, generator=gen,
                                 device="cuda"))
        l2s.append(torch.full((width,), 1e-5, device="cuda"))
    return tables, rows, grads, l2s


def run(seed=0):
    if not torch.cuda.is_available():
        raise RuntimeError("row_update_parts times the kernel on a CUDA "
                           "device; none is available")
    libs = build_variants(VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = {
        "criteo": make_shape([(v, CRITEO_BATCH)
                              for v in CRITEO_SPARSE_VOCABS], CRITEO_W, gen),
        "dien": make_shape(DIEN_TABLES, DIEN_W, gen),
    }
    stream = torch.cuda.current_stream().cuda_stream
    default_rows = RU.RUN_ROWS
    try:
        for build, lib in libs.items():
            run_rows = _BUILDS[build][0]
            built = RU._KERNEL.layout_of(lib)["row_update_run_rows"]
            if built != run_rows:
                raise RuntimeError("build %r takes %d rows a run, not %d"
                                   % (build, built, run_rows))
            fn = RU._KERNEL.bind(lib)
            RU.RUN_ROWS = run_rows
            for shape, (tables, rows, grads, l2s) in shapes.items():
                for opt in OPTIMIZERS:
                    states = [tuple(torch.rand_like(t) for _ in range(
                        RU.MODES[opt][1])) for t in tables]
                    bias = ([torch.tensor(RU.adam_bias_corrections(3),
                                          device="cuda")] * len(tables)
                            if opt == "adam" else None)
                    timed = [(build, {})]
                    if build == "as is":
                        timed.append(("generic routes", GENERIC_ROUTES))
                    for label, routes in timed:
                        args = RU.kernel_args(opt, tables, states, grads,
                                              rows, l2s, 0.01, bias)
                        for a in args:
                            a.route = routes.get(a.route, a.route)

                        def call():
                            for a in args:
                                rc = fn(ctypes.addressof(a), stream)
                                if rc != 0:
                                    raise RuntimeError("launch failed: CUDA "
                                                       "error %d" % rc)
                        for l2 in ("cold", "warm"):
                            print(json.dumps({
                                "build": label, "shape": shape,
                                "optimizer": opt, "l2": l2,
                                "ms": device_ms(call, cold=l2 == "cold")}),
                                flush=True)
                    del states
    finally:
        RU.RUN_ROWS = default_rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    run(args.seed)


if __name__ == "__main__":
    main()
