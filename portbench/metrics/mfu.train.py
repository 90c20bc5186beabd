"""The whole train step's share of the H100's bf16 peak (989 TFLOP/s),
in percent: the model's matrix products (forward x 3) at the traced
epoch's rate."""


from portbench.metrics import _roofline


def read(view):
    if view.records.busy_s <= 0:
        return None
    return _roofline.mfu(view, training=True)
