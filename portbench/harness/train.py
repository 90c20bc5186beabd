"""The driver of a training cell: ``fit`` on a flat device tensor, the
port's device-resident loop (``BaseModel.fit`` -> ``_fit_device`` ->
``graphs.StepGraph`` -> ``_train_step``).

Set-up builds the model, loads the weights the benchmark drew, compiles it
and makes the data on the device.  It then drives the model through its
first three steps by the window's own call: ``fit`` over the whole data,
shuffled, at the window's batch, which makes, loads and captures the one
``StepGraph`` the window replays.  Its first step is the capture's warm-up,
the next two are replays of that graph; the harness reads the optimizer's
state after the first and each parameter after the third, takes the three
steps' losses from the loop, and stops the epoch there.  The rows of those
steps are the ones the loop's permutation gave them.  Then warm epochs over
the whole data, through the same graph, until the traffic's
``warm_seconds`` have passed: the card runs a step's graph more slowly for
the first seconds to half a minute of load, and the window measures the
steady state a training job spends its hours in.  The window is one ``fit``
call over the whole data, stopped at the end of the first epoch that ends
``--seconds`` after the window began; ``train_examples_per_s`` counts the
window's whole epochs over the time from the first one's start to the
synchronise after the last.  A traced run profiles the window's second
epoch and stops there.  The run fails where the window replayed another
loop than the one the check steps went through.

After the window the program is freed, and the plain reference runs the
same three steps from the same weights and rows.
"""

import contextlib
import gc
import math
import sys
import time

import torch

from deepctr_tpu_torch.callbacks import Callback
from deepctr_tpu_torch.models import graphs

from portbench.harness import check, program, traffic, weights
from portbench.harness.trace import Profiler, View
from portbench.reference import _common, _train

CHECK_STEPS = 3
# random batches whose distinct ids stand for a shuffled epoch's
SAMPLE_BATCHES = 8
# the "auto" gate of sparse_table_updates, as the port (and the JAX
# package) apply it: rows counted as the JAX package stores them
AUTO_MIN_MODEL_ROWS = 1_000_000
AUTO_MIN_TABLE_ROWS = 16384
PACKED_VOCAB_THRESHOLD = 131072


def _stored_rows(vocab, width):
    if vocab >= PACKED_VOCAB_THRESHOLD and width <= 64:
        return -(-vocab // (128 // width))
    return vocab


def sparse_tables(config):
    """``{table parameter name: [its id columns]}`` of the tables that
    ``sparse_table_updates`` puts on the touched-row path."""
    mode = config["sparse_table_updates"]
    tables, cols = {}, {}
    for c in config["columns"]:
        if c["kind"] in ("sparse", "varlen"):
            t = c.get("table", c["name"])
            width = c["dim"] + (1 if config["linear_columns"] == "all"
                                else 0)
            tables[t] = (c["vocab"], width)
            cols.setdefault(t, []).append(c["name"])
    if mode is False:
        return {}
    if mode == "auto":
        if sum(_stored_rows(*vw) for vw in tables.values()) \
                < AUTO_MIN_MODEL_ROWS:
            return {}
        tables = {t: vw for t, vw in tables.items()
                  if vw[0] >= AUTO_MIN_TABLE_ROWS}
    return {"embedding_dict.tables." + t: cols[t] for t in tables}


class _Stop(Exception):
    """Ends the check's epoch after its steps."""


@contextlib.contextmanager
def _between_steps(before):
    """Calls ``before(k, loop)`` ahead of each step that a training loop
    (``graphs.StepGraph``) runs, ``k`` the steps it ran before: an eager
    step (on the CPU, or the warm-up of a capture) or a replay of the
    captured step; the capture's recording runs nothing and is not
    counted.  Yields ``{"steps": steps run, "loop": the loop}``."""
    step, replay = graphs.StepGraph.step, graphs._Captured.replay
    seen = {"steps": 0, "loop": None}

    def counted(loop):
        before(seen["steps"], loop)
        seen["steps"] += 1

    def hooked_step(self):
        if not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            seen["loop"] = self
            counted(self)
        return step(self)

    def hooked_replay(self):
        counted(seen["loop"])
        return replay(self)

    graphs.StepGraph.step = hooked_step
    graphs._Captured.replay = hooked_replay
    try:
        yield seen
    finally:
        graphs.StepGraph.step = step
        graphs._Captured.replay = replay


class Cell:
    """A training cell set up on ``device`` from ``seed``: the model,
    the data, and the program's readings of its first steps."""

    def __init__(self, spec, seed, device):
        cfg, tr = spec.config, spec.traffic
        self.spec, self.seed, self.device = spec, seed, device
        self.B = tr["batch"]
        self.model = program.build(cfg, device, seed=seed % 2 ** 31)
        self.layout = program.layout(self.model)
        self.model.load_state_dict(weights.draw(cfg, self.layout, seed,
                                                device))
        program.compile_model(self.model, cfg)
        cols, self.y = traffic.train_data(tr, cfg, seed, device)
        self.n = tr["rows"]
        self.X = traffic.flat(cols, self.model.feature_index, self.n,
                              device)
        del cols
        self.index = dict(self.model.feature_index)
        self.loop = None
        self.readings = self._first_steps()

    def columns(self, rows):
        """The data's ``rows`` as columns (ids int64, values float32)."""
        return traffic.columns_of(self.X[rows], self.index,
                                  self.spec.config)

    def _first_steps(self):
        """The first CHECK_STEPS steps through the window's own ``fit``
        call and loop: each step's total loss, the first gradient's norms
        and each parameter's change after the steps; keeps the loop and
        the rows of those steps."""
        m, B, cfg = self.model, self.B, self.spec.config
        if self.n % B:
            raise ValueError("the rows (%d) are not whole batches of %d"
                             % (self.n, B))
        out = {}

        def before(k, loop):
            if k == 1:
                out["grad_norms"] = check.first_gradient_norms(
                    cfg["optimizer"], program.optimizer_state(m))
            elif k == CHECK_STEPS:
                self._read_steps(loop, out)
                raise _Stop()

        with _between_steps(before) as seen:
            try:
                m.fit(self.X, self.y, batch_size=B, epochs=1, verbose=0,
                      shuffle=True)
            except _Stop:
                pass
        if "change_norms" not in out:
            if seen["steps"] != CHECK_STEPS:
                raise ValueError("an epoch of %d steps; the check takes %d"
                                 % (seen["steps"], CHECK_STEPS))
            self._read_steps(seen["loop"], out)
        return out

    def _read_steps(self, loop, out):
        """The losses and changes after CHECK_STEPS steps of ``loop``, and
        the rows those steps trained on."""
        m, B = self.model, self.B
        self.loop = loop
        self.rows = loop.perm[:CHECK_STEPS * B].clone()
        self.head = self.columns(self.rows)
        out["losses"] = [float(v) for v in
                         loop.losses[:CHECK_STEPS].double().cpu()]
        params = dict(m.named_parameters())
        changes = {}
        with torch.no_grad():
            for name, _, is_param in self.layout:
                if is_param:
                    start = weights.redraw(self.spec.config, self.layout,
                                           self.seed, self.device, name)
                    changes[name] = float(
                        (params[name] - start).double().norm())
        out["change_norms"] = changes

    def window_loop_is_checked(self):
        """Whether the model's one training loop is the one the check
        steps went through."""
        loops = [g for g in self.model._graphs.values()
                 if isinstance(g, graphs.StepGraph)]
        return len(loops) == 1 and loops[0] is self.loop

    def check_batches(self):
        """The rows of the first steps, as the reference takes them."""
        B = self.B
        y = self.y[self.rows]
        return ([{k: v[i * B:(i + 1) * B] for k, v in self.head.items()}
                 for i in range(CHECK_STEPS)],
                [y[i * B:(i + 1) * B] for i in range(CHECK_STEPS)])

    def sample_batches(self):
        """SAMPLE_BATCHES batches of B rows drawn at random from the data,
        each with weight 1 / SAMPLE_BATCHES."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed % 2 ** 63)
        out = []
        for _ in range(SAMPLE_BATCHES):
            idx = torch.randint(0, self.n, (self.B,), generator=g,
                                device=self.device)
            out.append((1.0 / SAMPLE_BATCHES, self.columns(idx)))
        return out

    def free_program(self):
        """Drop the model, its graphs and the flat data (the rows of the
        first steps stay)."""
        self.model._drop_graphs()
        self.model = self.X = self.loop = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def reference_readings(spec, cell, precision="f32", fault=None):
    """The plain reference's readings of the first steps, from the weights
    drawn again from the seed."""
    _common.exact_float32()
    w0 = weights.draw(spec.config, cell.layout, cell.seed, cell.device)
    batches, labels = cell.check_batches()
    return _train.train(spec.reference(), spec.config, w0, cell.layout,
                        batches, labels, sparse_tables(spec.config),
                        steps=CHECK_STEPS, precision=precision, fault=fault)


class Window(Callback):
    """Times the window's epochs and stops ``fit``: after the first epoch
    that ends ``seconds`` after the window began, or, traced, after the
    profiled second epoch."""

    def __init__(self, seconds, device, trace):
        super().__init__()
        self.seconds, self.device = seconds, device
        self.profiler = Profiler(device) if trace else None
        self.records = None
        self.t0 = self.start_wall = self.t_end = None
        self.epochs = self.bad_epochs = 0
        self.epoch_s = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def on_epoch_begin(self, epoch, logs=None):
        if self.t0 is None:
            self._sync()
            self.start_wall = time.time()
            self.t0 = time.perf_counter()
        if self.profiler is not None and self.epochs == 1:
            self.profiler.start()

    def on_epoch_end(self, epoch, logs=None):
        self._sync()
        now = time.perf_counter()
        self.epoch_s.append(now - (self.t_end or self.t0))
        self.t_end = now
        self.epochs += 1
        if not math.isfinite((logs or {}).get("loss", float("nan"))):
            self.bad_epochs += 1
        if self.profiler is not None:
            if self.epochs == 2:
                self.records = self.profiler.stop()
                self.model.stop_training = True
        elif self.t_end - self.t0 >= self.seconds:
            self.model.stop_training = True


def run(spec, args, device, t_start):
    """One run of a training cell: ``(result fields, numbers compared)``.
    """
    cell = Cell(spec, args.seed, device)
    B, n = cell.B, cell.n
    steps = -(-n // B)
    # the warm epochs: the first captures the step the window replays; the
    # card's launches run slower for the first seconds of load
    warm = Window(spec.traffic["warm_seconds"], device, False)
    cell.model.fit(cell.X, cell.y, batch_size=B, epochs=10 ** 9, verbose=0,
                   shuffle=True, callbacks=[warm])
    print("warm: %d epochs, seconds each %s" % (
        warm.epochs, " ".join("%.4f" % t for t in warm.epoch_s)),
        file=sys.stderr)
    window = Window(args.seconds, device, args.trace)
    cell.model.fit(cell.X, cell.y, batch_size=B, epochs=10 ** 9, verbose=0,
                   shuffle=True, callbacks=[window])
    if not cell.window_loop_is_checked():
        raise RuntimeError("the window replayed another training loop than "
                           "the one the check steps went through")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    print("window: %d epochs, seconds each %s" % (
        window.epochs, " ".join("%.4f" % t for t in window.epoch_s)),
        file=sys.stderr)
    out = {"attempted": window.epochs * steps,
           "failed": window.bad_epochs * steps,
           "memory_peak_bytes": peak}
    if args.trace:
        records = window.records
        samples = cell.sample_batches()
        ref = spec.reference()
        flops = sum(w * ref.matmul_flops(spec.config, b, True)
                    for w, b in samples)
        out["view"] = View(records, config=spec.config,
                           traffic=spec.traffic, units=steps,
                           examples=n, window_s=records.window_s,
                           samples=samples,
                           sparse_tables=sparse_tables(spec.config),
                           flops_per_example=flops)
    else:
        out["metrics"] = {
            "train_examples_per_s": window.epochs * n
            / (window.t_end - window.t0),
            "setup_s": window.start_wall - t_start}
    cell.free_program()
    ref = reference_readings(spec, cell)
    return out, check.training_numbers(cell.readings, ref)
