"""The device's idle time inside the program's ``predict.readback``
spans, a request of the traced serving window, ms: the predictions'
concatenation, their copy to the host (which waits for the card) and
their float64 cast."""

from portbench.metrics import _spans


def read(view):
    return _spans.idle_ms_per_request(view, "predict.readback")
