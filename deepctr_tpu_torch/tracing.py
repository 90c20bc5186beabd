"""Spans: named intervals of the host's work, recorded as events of the
``torch.profiler`` trace that is running, and nothing when none is.

``with span("assemble.batcher"): ...`` records a CPU operation of that
name on the profiler's own clock, the clock of its device records, so an
idle gap of the card can be put down to the span open at the time.  A
span's parent is the span that encloses it on the thread.  It is recorded
as a plain CPU operation, not as a ``record_function`` user annotation,
which the profiler also projects onto the device's timeline as a device
record.  With no profiler running a span costs one check (under 1 us).

Names are ``<layer>.<part>``; the README's ``fit(profile=)`` paragraph
lists them.
"""

import contextlib

import torch

_OFF = contextlib.nullcontext()
_Record = torch._C._profiler._RecordFunctionFast
_profiling = torch.autograd._profiler_enabled
_paused = False


def span(name):
    """A context manager that records ``name`` over its body while a
    profiler runs (and :func:`paused` is not in force)."""
    if _paused or not _profiling():
        return _OFF
    return _Record(name)


@contextlib.contextmanager
def paused():
    """No span inside: a CUDA graph's recording, whose host work is not
    the work that a replay of the graph does."""
    global _paused
    was, _paused = _paused, True
    try:
        yield
    finally:
        _paused = was
