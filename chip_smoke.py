"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, DeepFM serving at Criteo width, through the
entry points a user calls (``DeepFM(...)``, ``model.predict``), and holds
every CUDA kernel of that path against its plain PyTorch version:

1. build: compile every kernel under ``deepctr_tpu_torch/csrc/`` (one
   ``nvcc`` a source, all started together) and print the build time;
2. kernel vs plain: ``gather_rows`` at the bench shape (B=4096, the 26
   Criteo tables, row width 17) must equal ``gather_rows_ref`` bit for
   bit, ids at V-1 and out-of-range ids (NaN rows) included;
3. DeepFM predict, float32: the 26 real Criteo vocabularies (33.8M rows),
   13 dense fields, DNN 400-400-400, weights drawn at std 0.05 from a
   seed; 8 batches of 4096 requests through the kernel (its launch count
   must rise), every prediction finite and in (0, 1), and the first batch
   within 1e-5 of the same model on the CPU;
4. timing, bfloat16 compute: predict in examples/s (CUDA events, median
   of 5 runs after warm-up) and its device time by kernel
   (``torch.profiler``); the kernel, its plain version and a library
   gather in ms of device time with a cold L2 and, apart, per call with
   the host included; the kernel's bound from this run's bytes.

Any failure exits non-zero.  Without a CUDA device it fails at once and
runs nothing on the CPU.  The last two lines before the final one are the
card (``nvidia-smi`` name and power limit) and a JSON line describing each
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import deepctr_tpu_torch as pt  # noqa: E402
from deepctr_tpu_torch.models import DeepFM  # noqa: E402
from deepctr_tpu_torch.ops import _build  # noqa: E402
from deepctr_tpu_torch.ops import gather  # noqa: E402

# Criteo Kaggle display-advertising layout, as bench.py runs it
CRITEO_KAGGLE_VOCABS = [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
    15, 286181, 105, 142572]
N_DENSE = 13
EMB_DIM = 16
HIDDEN = (400, 400, 400)
BATCH = 4096
N_BATCHES = 8
INIT_STD = 0.05
SEED = 1024
ATOL_CPU = 1e-5

# H100 SXM device-memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12

KERNELS = {
    "gather_rows": {
        "route": "cuda",
        "source": "deepctr_tpu_torch/csrc/gather_rows.cu",
        "replaces": "deepctr_tpu/ops/pallas_gather.py:33",
    },
}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, runs=5):
    """Median over ``runs`` of the mean time of ``reps`` calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def criteo_columns():
    sparse = [pt.SparseFeat("C%d" % i, v, EMB_DIM)
              for i, v in enumerate(CRITEO_KAGGLE_VOCABS)]
    dense = [pt.DenseFeat("I%d" % i, 1) for i in range(N_DENSE)]
    return sparse + dense


def criteo_requests(n, generator, device):
    """A flat [n, 39] float32 batch: uniform ids in every field, dense
    values in [0, 1)."""
    vocabs = torch.tensor(CRITEO_KAGGLE_VOCABS, dtype=torch.float64,
                          device=device)
    u = torch.rand(n, len(vocabs), generator=generator, device=device,
                   dtype=torch.float64)
    ids = torch.floor(u * vocabs).clamp_max(vocabs - 1)
    dense = torch.rand(n, N_DENSE, generator=generator, device=device)
    return torch.cat([ids.float(), dense], dim=1).contiguous()


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def check_predictions(pred, n):
    check(pred.shape == (n, 1), "predictions of shape %s" % (pred.shape,))
    check(np.isfinite(pred).all(), "non-finite predictions")
    check(((pred > 0) & (pred < 1)).all(), "predictions outside (0, 1)")


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    for name, text in sorted(logs.items()):
        log("nvcc %s:\n%s" % (name, text.strip()))
    log("build: %d kernel source(s) compiled in %.2f s"
        % (len(logs), seconds))


def phase_kernel_vs_plain(model, X):
    """gather_rows against gather_rows_ref at the main path's shapes."""
    tables = [model.embedding_dict.tables["C%d" % i]
              for i in range(len(CRITEO_KAGGLE_VOCABS))]
    cols = list(range(len(tables)))
    with torch.no_grad():
        got = gather.gather_rows(X, tables, cols)
        want = gather.gather_rows_ref(X, tables, cols)
        torch.cuda.synchronize()
        check(same_bits(got, want), "gather_rows differs from its plain "
              "version at the bench shape")
        check(not torch.isnan(got).any(), "in-range ids gave NaN rows")

        edge = X[:8].clone()
        vocabs = torch.tensor(CRITEO_KAGGLE_VOCABS, dtype=torch.float32,
                              device=X.device)
        edge[0, :len(tables)] = vocabs - 1          # last row of each table
        edge[1, :len(tables)] = vocabs              # == V: out of range
        edge[2, :len(tables)] = -1.0                # negative: out of range
        edge[3, :len(tables)] = 0.9                 # truncates to row 0
        got_e = gather.gather_rows(edge, tables, cols)
        want_e = gather.gather_rows_ref(edge, tables, cols)
        torch.cuda.synchronize()
        check(same_bits(got_e, want_e), "gather_rows differs from its "
              "plain version on edge ids")
        for f, t in enumerate(tables):
            check(torch.equal(got_e[0, f], t[-1]), "id V-1 of field %d" % f)
            check(torch.equal(got_e[3, f], t[0]), "id 0.9 of field %d" % f)
        check(torch.isnan(got_e[1:3]).all(), "out-of-range ids must give "
              "NaN rows")
    finite = ~torch.isnan(want)
    err = (got[finite] - want[finite]).abs().max().item()
    log("kernel vs plain: gather_rows bit-equal at B=%d F=%d W=%d "
        "(max_abs_err %r), edge ids ok" % (X.shape[0], len(tables),
                                           tables[0].shape[1], err))
    return err


def phase_predict_f32(model, X_all):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_compute_dtype("float32")
    gather.GATHER_LAUNCHES = 0
    pred = model.predict(X_all, batch_size=BATCH)
    launches = gather.GATHER_LAUNCHES
    check(launches >= N_BATCHES, "the kernel launched %d times over %d "
          "batches" % (launches, N_BATCHES))
    check_predictions(pred, X_all.shape[0])
    log("predict f32: %d requests in %d batches, %d gather launches, "
        "predictions in [%.6f, %.6f], std %.6f"
        % (pred.shape[0], N_BATCHES, launches, pred.min(), pred.max(),
           pred.std()))

    first = X_all[:BATCH].cpu()
    model.to("cpu")
    try:
        pred_cpu = model.predict(first, batch_size=BATCH)
    finally:
        model.to("cuda")
    diff = float(np.abs(pred[:BATCH] - pred_cpu).max())
    check(diff <= ATOL_CPU, "card vs CPU: max |dp| %r > %r"
          % (diff, ATOL_CPU))
    log("predict f32: first batch vs CPU max |dp| = %r (atol %r)"
        % (diff, ATOL_CPU))
    return launches


def device_ms(fn, runs=20):
    """Device time of ``fn``'s kernels with a cold L2, median of ``runs``.

    Before each run the stream is stalled (``torch.cuda._sleep``) for
    longer than the host takes to enqueue ``fn``, so host overhead is not
    timed, and a 128 MB write evicts the 50 MB L2, as a new batch finds
    the rows of 2.3 GB of tables cold."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    stall_cycles = int((4 * host_s + 2e-4) * 2e9)
    events = []
    for _ in range(runs):
        torch.cuda._sleep(stall_cycles)
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def predict_profile(model, X_all):
    """Device time of one predict by kernel (torch.profiler, kernels
    only): returns the total in ms, or None where the profiler saw no
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.predict(X_all, batch_size=BATCH)
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    total = sum(us for us, _, _ in rows)
    if total <= 0:
        log("predict profile: device time not measured (the profiler saw "
            "no kernel)")
        return None
    for us, count, key in rows[:6] + [r for r in rows[6:]
                                      if "gather_rows" in r[2]]:
        log("predict profile: %r ms in %d launches (%.1f%%) %s"
            % (us / 1e3, count, 100 * us / total, key[:90]))
    return total / 1e3


def phase_timing_bf16(model, X_all):
    log("timing on: %s" % card_line())
    pt.set_compute_dtype("bfloat16")
    n = X_all.shape[0]
    pred = model.predict(X_all, batch_size=BATCH)
    check_predictions(pred, n)

    dev_ms = time_ms(lambda: model.predict(X_all, batch_size=BATCH),
                     reps=3)
    host = X_all.cpu().numpy()
    host_ms = time_ms(lambda: model.predict(host, batch_size=BATCH),
                      reps=3)
    log("predict bf16, device input: %r examples/s (%r ms for %d)"
        % (n / dev_ms * 1e3, dev_ms, n))
    log("predict bf16, host numpy input: %r examples/s (%r ms for %d)"
        % (n / host_ms * 1e3, host_ms, n))
    busy_ms = predict_profile(model, X_all)
    if busy_ms is not None:
        log("predict bf16, device input: device busy %r ms of %r ms, idle "
            "share %r" % (busy_ms, dev_ms, 1 - busy_ms / dev_ms))

    X = X_all[:BATCH].contiguous()
    tables = [model.embedding_dict.tables["C%d" % i]
              for i in range(len(CRITEO_KAGGLE_VOCABS))]
    cols = list(range(len(tables)))
    args = gather.GatherArgs()
    ids = [X[:, c].to(torch.int32).to(torch.int64) for c in cols]
    timed = {
        "kernel": lambda: gather.gather_rows(X, tables, cols, args=args),
        "plain": lambda: gather.gather_rows_ref(X, tables, cols),
        # the library's row gather, one call per table, ids cast beforehand
        "library": lambda: [torch.index_select(t, 0, i)
                            for t, i in zip(tables, ids)],
    }
    ms, call_ms = {}, {}
    with torch.no_grad():
        for name, fn in timed.items():
            ms[name] = device_ms(fn)
            call_ms[name] = time_ms(fn, reps=20)

    # bytes the function must move: the id of every (b, f), every row the
    # ids touch (once), the [B, F, W] output
    width = tables[0].shape[1]
    unique_rows = sum(int(torch.unique(i).numel()) for i in ids)
    n_bytes = (4 * X.shape[0] * len(tables) + 4 * width * unique_rows
               + 4 * X.shape[0] * len(tables) * width)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log("gather_rows at B=%d F=%d W=%d, device time, cold L2: kernel %r ms, "
        "plain %r ms, library (index_select per table) %r ms; bound %r ms "
        "(%d bytes: %d unique rows, at %.3g B/s)"
        % (X.shape[0], len(tables), width, ms["kernel"], ms["plain"],
           ms["library"], bound_ms, n_bytes, unique_rows, HBM_BYTES_PER_S))
    log("gather_rows at B=%d F=%d W=%d, back-to-back calls, host included: "
        "kernel %r ms, plain %r ms, library %r ms a call"
        % (X.shape[0], len(tables), width, call_ms["kernel"],
           call_ms["plain"], call_ms["library"]))
    return {"ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "bound_ms": bound_ms,
            "bound_by": "bytes"}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    if Path(pt.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: deepctr_tpu_torch must come from this checkout, "
              "not %s" % pt.__file__, file=sys.stderr)
        return 1
    device = torch.device("cuda")
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))

    phase_build()

    t0 = time.perf_counter()
    cols = criteo_columns()
    model = DeepFM(cols, cols, dnn_hidden_units=HIDDEN, init_std=INIT_STD,
                   seed=SEED, device=device)
    n_rows = sum(CRITEO_KAGGLE_VOCABS)
    log("DeepFM built on %s in %.2f s: %d table rows, %.3f GB of tables"
        % (device, time.perf_counter() - t0, n_rows,
           sum(t.numel() * 4 for t in model.embedding_dict.tables.values())
           / 1e9))
    generator = torch.Generator(device=device).manual_seed(SEED)
    X_all = criteo_requests(BATCH * N_BATCHES, generator, device)

    err = phase_kernel_vs_plain(model, X_all[:BATCH])
    launches = phase_predict_f32(model, X_all)
    timing = phase_timing_bf16(model, X_all)

    log(card_line())
    kernels = [dict(name="gather_rows", launches=launches,
                    max_abs_err=err, ms=timing["ms"],
                    plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
                    bound_by=timing["bound_by"],
                    library_ms=timing["library_ms"],
                    **KERNELS["gather_rows"])]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
