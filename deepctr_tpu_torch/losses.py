"""Training losses (sum-reduction with sample-weight masking).

Counterpart of ``deepctr_tpu/losses.py``.  The engine pads the last batch
of an epoch to the batch size and masks the padded rows through ``sw``;
reductions are sums, so the step size scales with the batch size as in the
JAX package.
"""

import inspect

import torch


def binary_crossentropy(y_pred, y_true, sw):
    """Sum-reduced BCE on probabilities, clipped to [1e-7, 1-1e-7] before
    the log (the gradient stays finite at a saturated sigmoid)."""
    eps = 1e-7
    p = torch.clamp(y_pred, eps, 1.0 - eps)
    return -torch.sum(sw * (y_true * torch.log(p) +
                            (1.0 - y_true) * torch.log(1.0 - p)))


def mse(y_pred, y_true, sw):
    return torch.sum(sw * (y_pred - y_true) ** 2)


def mae(y_pred, y_true, sw):
    return torch.sum(sw * torch.abs(y_pred - y_true))


_BUILTIN = {"binary_crossentropy": binary_crossentropy, "mse": mse,
            "mae": mae}


def _wrap_custom(fn):
    """Adapt a user callable to the (y_pred, y_true, sw) protocol.

    Accepts the native 3-arg form, a 2-arg per-sample form, or a
    ``fn(y_pred, y_true, reduction=...)`` form, which is called with
    ``reduction='none'`` and masked and summed here: a ``reduction='sum'``
    call would add the padded rows of the last batch into the loss.
    """
    try:
        n_params = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n_params = 2
    if n_params >= 3:
        if "reduction" in inspect.signature(fn).parameters:
            def masked(yp, yt, sw):
                try:
                    per_sample = fn(yp, yt, reduction="none")
                except Exception as e:
                    raise ValueError(
                        "custom loss %r accepts reduction= but failed "
                        "under reduction='none' (%s) — the engine needs "
                        "per-sample values to mask padded batches; "
                        "support reduction='none' or use the native "
                        "(y_pred, y_true, sw) protocol" % (fn, e))
                return torch.sum(per_sample * sw)
            return masked
        return fn
    return lambda yp, yt, sw: torch.sum(fn(yp, yt) * sw)


def resolve_loss(loss):
    """Name / callable / list thereof -> canonical (yp, yt, sw) callables."""
    if loss is None:
        return None
    if isinstance(loss, str):
        if loss not in _BUILTIN:
            raise NotImplementedError("unknown loss %r" % loss)
        return _BUILTIN[loss]
    if isinstance(loss, (list, tuple)):
        return [resolve_loss(l) for l in loss]
    return _wrap_custom(loss)
