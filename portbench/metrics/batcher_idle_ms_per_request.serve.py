"""The device's idle time inside the program's ``assemble.batcher``
spans, a request of the traced serving window, ms: the C++ batcher
(``native.assemble``) that copies the columns into one float32 matrix."""

from portbench.metrics import _spans


def read(view):
    return _spans.idle_ms_per_request(view, "assemble.batcher")
