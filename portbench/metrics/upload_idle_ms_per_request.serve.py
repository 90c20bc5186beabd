"""The device's idle time inside the program's ``predict.upload`` spans,
a request of the traced serving window, ms: each batch's copy into the
captured forward's static buffer on the card and its zero padding."""

from portbench.metrics import _spans


def read(view):
    return _spans.idle_ms_per_request(view, "predict.upload")
