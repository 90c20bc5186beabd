"""The driver of a serving cell: ``predict`` on a dict of host arrays, the
port's serving path (``BaseModel.predict`` -> ``_assemble_x`` / ``native``
-> ``graphs.ForwardGraph``), as a closed loop with one request in flight:
``predict`` serves one call at a time, and each request is sent the moment
the one before it is answered.  The load is thus the most the port's
serving path takes, and the end-to-end metric is the candidates scored a
second.

Set-up builds the model, loads the weights the benchmark drew, makes the
pool of requests and sends a few of them, the shortest and the longest
among them (which captures the forward the window replays).  The window
sends the pool's requests in order, round and round, each timed from the
call to ``predict`` until its scores are on the host, until ``--seconds``
have passed; ``serve_candidates_per_s`` is every candidate scored over the
window's wall time.  A traced run makes the same window unprofiled, whose
service times give the tail (``service_p95_ms.serve``), then profiles the
traffic's ``traced_requests`` more.

After the window the program is freed, and the plain reference scores a
sample of the requests drawn from the seed (the longest among them) from
the same weights; ``score_gap`` is the widest gap of a served score.
"""

import gc
import statistics
import sys
import time

import numpy as np
import torch

from portbench.harness import program, traffic, weights
from portbench.harness.trace import Profiler, View
from portbench.reference import _common

WARM_REQUESTS = 8


class Cell:
    """A serving cell set up on ``device`` from ``seed``: the model and
    the request pool."""

    def __init__(self, spec, seed, device):
        cfg, tr = spec.config, spec.traffic
        self.spec, self.seed, self.device = spec, seed, device
        self.B = tr["batch_size"]
        self.model = program.build(cfg, device, seed=seed % 2 ** 31)
        self.layout = program.layout(self.model)
        self.model.load_state_dict(weights.draw(cfg, self.layout, seed,
                                                device))
        self.model.eval()
        self.pool = traffic.request_pool(tr, cfg, seed, device)
        self.sizes = [len(next(iter(r.values()))) for r in self.pool]
        order = np.argsort(self.sizes)
        for k in list(order[:WARM_REQUESTS // 2]) + list(
                order[-(WARM_REQUESTS // 2):]):
            self.model.predict(self.pool[k], batch_size=self.B)
        rng = np.random.default_rng([seed % 2 ** 63, 11])
        n = min(tr["checked_requests"], len(self.pool))
        picked = rng.choice(len(self.pool), n - 1, replace=False).tolist()
        longest = int(order[-1])
        self.checked = sorted(set(picked + [longest]))
        self.answers = {}

    def serve(self, k):
        """Request ``k`` of the pool: (seconds, scores)."""
        t = time.perf_counter()
        p = self.model.predict(self.pool[k], batch_size=self.B)
        return time.perf_counter() - t, p

    def window(self, seconds, count=None, start=0):
        """Requests in order from ``start``, each sent once the one before
        it is answered, until ``seconds`` have passed (or ``count``
        requests): (service times, candidates, failed, wall s, requests
        sent by index)."""
        lat, sent = [], []
        cand = failed = 0
        t0 = time.perf_counter()
        i = start
        while True:
            k = i % len(self.pool)
            dt, p = self.serve(k)
            lat.append(dt)
            sent.append(k)
            cand += self.sizes[k]
            if not np.all(np.isfinite(p)):
                failed += 1
            if k in self.checked:
                self.answers[k] = p[:, 0]
            i += 1
            now = time.perf_counter()
            if (count is None and now - t0 >= seconds) or (
                    count is not None and i - start >= count):
                return lat, cand, failed, now - t0, sent

    def request_batch(self, k, rows=None):
        """Request ``k``'s columns as tensors on the device (ids int64),
        its rows ``rows`` where given, padded with zero rows to ``B``."""
        req = self.pool[k]
        out = {}
        for name, a in req.items():
            t = torch.from_numpy(a).to(self.device)
            if rows is not None:
                t = t[rows]
                pad = self.B - t.shape[0]
                if pad:
                    t = torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
            out[name] = t if a.dtype == np.float32 else t.long()
        return out

    def free_program(self):
        self.model._drop_graphs()
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def reference_scores(spec, cell, precision="f32"):
    """``{request: reference scores}`` of the checked requests."""
    _common.exact_float32()
    w0 = weights.draw(spec.config, cell.layout, cell.seed, cell.device)
    ref = spec.reference()
    out = {}
    with torch.no_grad():
        for k in cell.checked:
            p, _ = ref.forward(spec.config, w0, cell.request_batch(k),
                               precision, training=False)
            out[k] = p.double().cpu().numpy()
    return out


def score_gap(answers, scores):
    """The widest gap between a served score and the reference's, over
    the checked requests that were answered (inf where none was)."""
    gaps = [float(np.max(np.abs(answers[k] - scores[k])))
            for k in answers if k in scores]
    return max(gaps) if gaps else float("inf")


def run(spec, args, device, t_start):
    """One run of a serving cell: ``(result fields, numbers compared)``."""
    cell = Cell(spec, args.seed, device)
    start_wall = time.time()
    lat, cand, failed, wall, sent = cell.window(args.seconds)
    tenth = max(len(lat) // 10, 2)
    print("window: %d requests in %.4f s; p50 %.4f ms, max %.4f ms; p95 by "
          "tenths of the window %s" % (
              len(lat), wall, 1e3 * statistics.median(lat), 1e3 * max(lat),
              " ".join("%.4f" % (1e3 * statistics.quantiles(
                  lat[i:i + tenth], n=20)[18])
                  for i in range(0, len(lat) - tenth + 1, tenth))),
          file=sys.stderr)
    out = {"attempted": len(lat), "failed": failed}
    if args.trace:
        profiler = Profiler(device)
        profiler.start()
        t_lat, t_cand, t_failed, _, t_sent = cell.window(
            0, count=spec.traffic["traced_requests"], start=len(sent))
        records = profiler.stop()
        out["attempted"] += len(t_lat)
        out["failed"] += t_failed
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    if args.trace:
        counts = {}
        for k in t_sent:
            counts[k] = counts.get(k, 0) + 1
        B = cell.B
        replays = sum(m * -(-cell.sizes[k] // B) for k, m in counts.items())
        ref = spec.reference()
        samples, flops = [], 0.0
        for k, m in counts.items():
            n = cell.sizes[k]
            flops += m * n * ref.matmul_flops(spec.config,
                                              cell.request_batch(k), False)
            for j in range(0, n, B):
                samples.append((m / replays, cell.request_batch(
                    k, slice(j, min(j + B, n)))))
        out["view"] = View(records, config=spec.config,
                           traffic=spec.traffic, units=replays,
                           requests=len(t_sent), examples=t_cand,
                           window_s=records.window_s, samples=samples,
                           sparse_tables={},
                           flops_per_example=flops / t_cand,
                           latencies=lat)
    else:
        out["metrics"] = {"serve_candidates_per_s": cand / wall,
                          "setup_s": start_wall - t_start}
    cell.free_program()
    scores = reference_scores(spec, cell)
    return out, {"score_gap": score_gap(cell.answers, scores)}
