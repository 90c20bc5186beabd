"""The readings a cell's limits are set from, on the card at the cell's
own size:

    python -m portbench.control --workload <cell> --seeds 11,12,... \\
        --control-seeds 11,12,13 [--seconds 2]

For every seed of ``--seeds``, the numbers of the sound program against
the plain reference (``check.py``): a training cell's first steps, or a
serving cell's answers in a short window.  For every seed of
``--control-seeds`` also the numbers of

- ``control``: the reference computed with its products' and lookups'
  operands rounded to float8 (``reference/_common.py``), the precision
  below the configuration's bfloat16, in the program's place;
- the faults a check must catch, planted in the reference put in the
  program's place (training: ``half_batch``; the state left unchanged
  reads 1 by the change's measure and needs no run)
  or in the program's answers (serving: ``altered_answer``, one score a
  request whose logit is off by one; ``half_batch``, the second half of
  each request's scores those of the first half).

One JSON line a reading, then a summary: for each number the largest
sound reading and the least control and fault readings.
"""

import argparse
import gc
import json
import sys

import numpy as np
import torch

from portbench.harness import check, serve, train
from portbench.harness.spec import Spec


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def train_readings(spec, seed, device, control):
    cell = train.Cell(spec, seed, device)
    cell.free_program()
    ref = train.reference_readings(spec, cell)
    out = [("sound", check.training_numbers(cell.readings, ref))]
    print(json.dumps({"seed": seed, "worst": check.worst_leaves(
        cell.readings, ref)}), flush=True)
    if control:
        out.append(("control", check.training_numbers(
            train.reference_readings(spec, cell, precision="fp8"), ref)))
        for fault in ("half_batch",):
            out.append((fault, check.training_numbers(
                train.reference_readings(spec, cell, fault=fault), ref)))
    return out


def altered(answers):
    """Each answer with its first score's logit off by one."""
    out = {}
    for k, a in answers.items():
        a = a.astype(np.float64).copy()
        logit = np.log(a[0]) - np.log1p(-a[0])
        a[0] = 1.0 / (1.0 + np.exp(-(logit + 1.0)))
        out[k] = a
    return out


def half_left_out(answers):
    """Each answer's second half replaced by its first half."""
    out = {}
    for k, a in answers.items():
        a = a.copy()
        h = len(a) // 2
        a[len(a) - h:] = a[:h]
        out[k] = a
    return out


def serve_readings(spec, seed, device, control, seconds, count=None):
    """The numbers of a serving cell's answers in a window of ``seconds``
    (or of ``count`` requests)."""
    cell = serve.Cell(spec, seed, device)
    cell.window(seconds, count=count)
    cell.free_program()
    ref = serve.reference_scores(spec, cell)
    out = [("sound", {"score_gap": serve.score_gap(cell.answers, ref)})]
    if control:
        low = serve.reference_scores(spec, cell, precision="fp8")
        out.append(("control", {"score_gap": serve.score_gap(low, ref)}))
        out.append(("altered_answer", {"score_gap": serve.score_gap(
            altered(cell.answers), ref)}))
        out.append(("half_batch", {"score_gap": serve.score_gap(
            half_left_out(cell.answers), ref)}))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    spec = Spec(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    summary = {}
    for seed in seeds + sorted(controls - set(seeds)):
        if spec.traffic["driver"] == "train":
            rows = train_readings(spec, seed, device, seed in controls)
        else:
            rows = serve_readings(spec, seed, device, seed in controls,
                                  args.seconds)
        for kind, numbers in rows:
            if kind == "sound" and seed not in seeds:
                continue
            print(json.dumps({"seed": seed, "kind": kind,
                              "numbers": numbers}), flush=True)
            for k, v in numbers.items():
                agg = summary.setdefault(kind, {}).setdefault(k, [])
                agg.append(v)
        _free(device)
    out = {kind: {k: (max(v) if kind == "sound" else min(v))
                  for k, v in numbers.items()}
           for kind, numbers in summary.items()}
    print(json.dumps({"summary": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
