"""The device-resident loops' bodies, captured into CUDA graphs.

The JAX package compiles a train step, and a whole epoch of them inside
one ``lax.fori_loop``, into one XLA program (``deepctr_tpu/models/
basemodel.py:1509-1656``); ``predict`` runs one compiled forward a batch.
Here the counterpart of those programs is a captured CUDA graph:

- :class:`StepGraph` is one step of the epoch loop: it reads the model's
  device step counter, gathers its batch from the epoch's permutation of
  static ``X``/``y``/``sw`` buffers, runs ``BaseModel._train_step`` (which
  advances the counter) and stores the step's loss, and its predictions
  where train metrics need them.  Replaying it ``steps`` times is the
  JAX loop at one graph launch a step; the host reads one loss vector an
  epoch.  On a CPU model the same body runs eagerly.  The streamed
  ``fit`` loads each chunk into the buffers of one such loop for its
  geometry (no shuffle) and replays it, the step numbering carried on
  across chunks (``BaseModel._fit_stream``).
- :class:`ForwardGraph` is ``model(x, training=False)`` on a static batch;
  the first batch is the capture's warm-up, every later one a replay.

A capture follows the whole-network pattern: the body runs once on a side
stream (which builds every kernel and every cached argument array; for a
step it is the epoch's first step, run for real), the dense gradients are
set to None, and ``torch.cuda.graph`` records the body, with Python's
cyclic garbage collector run before and held off during it (a CUDA graph
it destroys mid-capture would end the capture).  A capture that fails
raises.  A step with dropout registers the model's dropout
generator with its graph (``CUDAGraph.register_generator_state``): each
replay then draws from the generator's state at that replay and advances
it by what the capture drew, as the eager step does, so that every step
draws new masks and the graphed steps draw the eager steps' bits.  A
replay runs no host code, so the launch counts (``ops._build.LAUNCHES``),
which count at the Python call, do not move: each graph keeps the counts
its capture recorded and adds them once a replay.  Nor does a replay enter a
span (``tracing.span``): a trace shows ``graph.capture`` around a
capture, with the spans of its warm-up inside it and none from its
recording (``tracing.paused``); ``ForwardGraph.run`` records a batch's
``predict.upload`` and ``predict.forward``.

A graph holds the addresses of every tensor it read at capture: the model
drops its graphs (``BaseModel._invalidate_graphs``) whenever it makes new
ones (``compile``, ``set_weights``, ``load_state_dict``, ``.to()``, a new
optimizer state or a larger table of adam's bias corrections).
"""

import collections
import gc

import torch

from ..ops._build import LAUNCHES
from ..tracing import paused, span

# graph replays since import (or since a caller reset it to 0)
GRAPH_REPLAYS = 0


class _Captured:
    """A CUDA graph of ``body`` on ``device`` and the kernel launches it
    holds (``launches``: the counts its capture added to ``LAUNCHES``, the
    kernels it holds none of left out); ``warm`` is what the warm-up run
    of ``body`` returned, ``out`` what each replay overwrites."""

    def __init__(self, body, device, generators=()):
        with span("graph.capture"), torch.cuda.device(device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.warm = body()
            current.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            for g in generators:
                self.graph.register_generator_state(g)
            before = collections.Counter(LAUNCHES)
            # a graph of a model left in a reference cycle (a model and its
            # loops point at each other) is destroyed when the collector
            # reaches it, and a destruction during this capture would end
            # it: collect first, and not while capturing
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with paused(), torch.cuda.graph(self.graph):
                    self.out = body()
            finally:
                if collecting:
                    gc.enable()
                recorded = LAUNCHES - before
                LAUNCHES.clear()
                LAUNCHES.update(before)
        self.launches = list(recorded.items())

    def replay(self):
        global GRAPH_REPLAYS
        self.graph.replay()
        GRAPH_REPLAYS += 1
        for name, n in self.launches:
            LAUNCHES[name] += n


class StepGraph:
    """The epoch loop of ``fit`` on a device tensor at one geometry:
    batch ``B``, ``steps`` a epoch over ``n_pad = steps * B`` padded rows,
    with or without a shuffle, with or without the epoch's predictions."""

    def __init__(self, model, B, steps, n_pad, n_out, shuffle, need_preds):
        device = model._device
        self.model, self.B, self.steps = model, B, steps
        self.shuffle = shuffle
        self.X = torch.zeros(n_pad, model.input_dim, device=device)
        self.y = torch.zeros(n_pad, n_out, device=device)
        self.sw = torch.zeros(n_pad, device=device)
        self.perm = torch.arange(n_pad, device=device)
        self.losses = torch.zeros(steps, device=device)
        self.preds = (torch.zeros(n_pad, n_out, device=device)
                      if need_preds else None)
        self.captured = None

    def load(self, X, y):
        """The training data, ``X`` [N, D] and ``y`` [N, n_out] (on the
        model's device, or in pinned host memory, which is copied without
        blocking the host), into the static buffers: padding rows are
        zeros at sample weight 0."""
        n = X.shape[0]
        self.X[:n].copy_(X, non_blocking=True)
        self.X[n:].zero_()
        self.y[:n].copy_(y, non_blocking=True)
        self.y[n:].zero_()
        self.sw[:n].fill_(1.0)
        self.sw[n:].zero_()

    def step(self):
        """One step of the loop, on the device alone: the batch of step
        ``i`` (the model's step counter), one train step, its total loss
        into ``losses[i]`` and its predictions at their samples."""
        i = self.model._step_i.clone()
        idx = self.perm.view(self.steps, self.B).index_select(0, i).view(-1)
        rows = self.model._put_batch(idx)   # on a mesh, this rank's rows
        _, total, y_pred = self.model._train_step(
            self.X.index_select(0, rows), self.y.index_select(0, rows),
            self.sw.index_select(0, rows))
        self.losses.index_copy_(0, i, total.view(1))
        if self.preds is not None:
            self.preds.index_copy_(0, idx,
                                   y_pred.reshape(self.B, -1).float())

    @property
    def capturable(self):
        """Whether the step can be captured: always, but for an optimizer
        object whose ``step()`` cannot (``basemodel.TorchOptimizer``)."""
        return self.model._dense_opt.capturable

    def begin_epoch(self, generator, epoch):
        """Epoch ``epoch`` made ready: the permutation (drawn from
        ``generator`` with a shuffle) and the steps
        (``BaseModel._begin_steps``)."""
        if self.shuffle:
            self.perm.copy_(torch.randperm(self.perm.shape[0],
                                           generator=generator,
                                           device=self.perm.device))
        self.model._begin_steps(self.steps, epoch)

    def run_epoch(self, generator, epoch):
        """:meth:`begin_epoch`, then :meth:`run`.  Returns the per-step
        losses, still on the device."""
        self.begin_epoch(generator, epoch)
        return self.run()

    def run(self):
        """``steps`` steps over the loaded data, made ready beforehand
        (the step counter at 0): graph replays on the card, after a
        capture whose warm-up is the first step; eager steps on the CPU,
        on a mesh (its collectives are not captured) and for an optimizer
        that cannot be captured.  Returns the
        per-step losses, still on the device, which the next run
        overwrites."""
        m = self.model
        first = 0
        if (self.X.device.type != "cuda" or not self.capturable
                or m.mesh is not None):
            for _ in range(self.steps):
                self.step()
            return self.losses
        if self.captured is None:
            self.captured = _Captured(
                self._capture_body, self.X.device,
                [m._dropout_generator()] if m._has_dropout() else [])
            first = 1
        for _ in range(first, self.steps):
            self.captured.replay()
        return self.losses

    def _capture_body(self):
        """The step, with the dense gradients set to None before the
        capture (the warm-up left them in memory outside the graph's)."""
        if torch.cuda.is_current_stream_capturing():
            for p in self.model.parameters():
                p.grad = None
        self.step()

    def release(self):
        self.captured = None


class ForwardGraph:
    """``model(x, training=False)`` on a static ``[B, input_dim]`` batch."""

    def __init__(self, model, B):
        self.model = model
        self.x = torch.zeros(B, model.input_dim, device=model._device)
        self.captured = None

    def _forward(self):
        with torch.no_grad():
            return self.model(self.x, training=False).float()

    def run(self, xb):
        """The forward of the rows ``xb`` (at most B, any device), the
        batch padded with zero rows: the capture's warm-up on the first
        call, a replay after.  Returns a copy of the output's first
        ``len(xb)`` rows."""
        n = xb.shape[0]
        with span("predict.upload"):
            self.x[:n].copy_(xb, non_blocking=True)
            self.x[n:].zero_()
        with span("predict.forward"):
            if self.captured is None:
                self.captured = _Captured(self._forward, self.x.device)
                out = self.captured.warm
            else:
                self.captured.replay()
                out = self.captured.out
            return out[:n].clone()

    def release(self):
        self.captured = None
