"""The traced run: ``torch.profiler`` over a slice of the window, reduced
to what the per-layer readers (``metrics/<metric>.py``) read, and to the
``breakdown`` of the result line.

Device time comes from the profiler's device records (kernels, copies,
fills) alone: ``busy_s`` is the union of their intervals, a kernel's time
the sum of its launches' durations.  The breakdown lists the kernels that
took most time, and the longest idle gaps of the device labelled by the
innermost host operation under way at each gap's middle.
"""

import re
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

_TOP = 10
# the longest gaps labelled, then summed by label
_GAPS_LABELLED = 200


def base_name(name):
    """A kernel's function name: ``void (anonymous namespace)::
    gather_rows_kernel<17, false>(...)`` -> ``gather_rows_kernel``."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void\s+", "", s.strip())
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.rsplit("::", 1)[-1].strip()


class Profiler:
    """Start and stop a device trace; :meth:`stop` returns its records."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.prof = None
        self.t0 = None

    def start(self):
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        self.prof.stop()
        return Records(self.prof.profiler.kineto_results.events(), window)


class Records:
    """The device and host records of one traced window of ``window_s``
    seconds of wall time."""

    def __init__(self, events, window_s):
        self.window_s = window_s
        dev, host = [], []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.start_ns(), e.duration_ns(), e.name()))
            elif e.device_type() == DeviceType.CPU and e.duration_ns() > 0:
                host.append((e.start_ns(), e.duration_ns(), e.name()))
        dev.sort()
        self.device = dev
        self.host = host
        self.kernels = defaultdict(lambda: [0, 0.0])
        for _, dur, name in dev:
            k = self.kernels[base_name(name)]
            k[0] += 1
            k[1] += dur * 1e-9
        self.busy_s, self.gaps = self._busy_and_gaps()

    def _busy_and_gaps(self):
        busy, gaps = 0, []
        end = None
        for start, dur, _ in self.device:
            if end is None or start > end:
                if end is not None:
                    gaps.append((start - end, end, start))
                busy += dur
                end = start + dur
            elif start + dur > end:
                busy += start + dur - end
                end = start + dur
        return busy * 1e-9, gaps

    def kernel(self, names):
        """``(launches, seconds)`` of the kernels whose function name is in
        ``names``."""
        n, s = 0, 0.0
        for name in names:
            if name in self.kernels:
                n += self.kernels[name][0]
                s += self.kernels[name][1]
        return n, s

    def launches(self):
        return sum(k[0] for k in self.kernels.values())

    def breakdown(self):
        ops = sorted(([name, k[1]] for name, k in self.kernels.items()),
                     key=lambda x: -x[1])[:_TOP]
        gaps = sorted(self.gaps, reverse=True)[:_GAPS_LABELLED]
        idle = defaultdict(float)
        if gaps and self.host:
            starts = np.array([h[0] for h in self.host], dtype=np.int64)
            durs = np.array([h[1] for h in self.host], dtype=np.int64)
            for length, a, b in gaps:
                mid = (a + b) // 2
                inside = np.nonzero((starts <= mid) & (starts + durs >= mid))[0]
                label = "host idle"
                if inside.size:
                    label = self.host[inside[np.argmin(durs[inside])]][2]
                idle[label] += length * 1e-9
        gap_list = sorted(([k, v] for k, v in idle.items()),
                          key=lambda x: -x[1])[:_TOP]
        return {"device_ops": ops, "idle_gaps": gap_list}


class View:
    """What a per-layer reader reads: the records of the traced window and
    the facts of the cell.

    - ``records``: :class:`Records`; ``window_s``: their wall time;
    - ``config``, ``traffic``: the cell's files;
    - ``units``: the window's train steps or graph replays, ``examples``
      its training examples or scored candidates, ``requests`` its
      requests (serving), ``latencies`` their service times in s;
    - ``samples``: ``[(weight, {column: tensor})]``, batches as a kernel
      launch sees them, weights summing to 1 (training: batches drawn at
      random from the cell's data; serving: the window's graph replays,
      padded with zero rows);
    - ``sparse_tables``: ``{table: [id columns]}`` on the sparse path;
    - ``flops_per_example``: the forward's matrix-product operations an
      example (the reference's count).
    """

    def __init__(self, records, **facts):
        self.records = records
        self.__dict__.update(facts)
