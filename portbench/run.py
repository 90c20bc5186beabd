"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled slice of the window.  Either way the
run then checks what the timed path produced against the plain reference
and prints each number compared beside its limit, as the last lines of
standard error and under ``checks``, the last key of the result line.

The run needs an NVIDIA GPU: without CUDA, or with fewer cards than the
cell asks for, it exits with code 2 and prints no result.  It exits with
code 3, and prints no result, where the process has loaded ``jax``,
``jaxlib``, ``flax``, ``optax`` or ``deepctr_tpu``.
"""

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench.harness.spec import ROOT, Spec, forbidden_modules  # noqa


def process_start():
    """This process's start on the wall clock (``/proc``), or the time
    this module was imported where ``/proc`` is not there."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None, root=ROOT, device=None):
    """Run the cell; returns the exit code.  ``device`` None means the
    card, which must be there; a test passes a CPU device to drive the
    rest of a run."""
    t_start = process_start()
    args = parse(argv)
    spec = Spec(args.workload, root)
    import torch
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < spec.chips):
            print("portbench: %s needs %d CUDA device(s); this machine has "
                  "%s" % (spec.name, spec.chips,
                          torch.cuda.device_count()
                          if torch.cuda.is_available() else "none"),
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    driver = importlib.import_module("portbench.harness."
                                     + spec.traffic["driver"])
    fields, numbers = driver.run(spec, args, device, t_start)
    bad = forbidden_modules()
    if bad:
        print("portbench: the process loaded %s" % ", ".join(bad),
              file=sys.stderr)
        return 3
    from portbench.harness import check
    correct, rows = check.judge(numbers, spec.limits)
    result = {"correct": correct, "attempted": fields["attempted"],
              "failed": fields["failed"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": spec.chips,
           "memory_peak_bytes": fields["memory_peak_bytes"]}
    if args.trace:
        view = fields["view"]
        metrics = {}
        for name, unit, reader in spec.metrics("per_layer"):
            value = reader.read(view)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        dev["busy_s"] = view.records.busy_s
        dev["window_s"] = view.records.window_s
        result["breakdown"] = view.records.breakdown()
    else:
        units = {n: u for n, u, _ in spec.metrics("end_to_end")}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in fields["metrics"].items() if k in units}
    if device.type == "cuda":
        dev["power"] = power_limit()
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]}
                        for r in rows}
    for r in rows:
        print("check %s %r limit %r" % (r["name"], r["value"], r["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
