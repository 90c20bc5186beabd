"""The device's idle time inside the program's ``assemble`` spans, a
request of the traced serving window, ms: ``BaseModel._assemble_x``, the
columns' float32 casts and hashing and the batcher (which
``batcher_idle_ms_per_request.serve`` reads alone)."""

from portbench.metrics import _spans


def read(view):
    return _spans.idle_ms_per_request(view, "assemble")
