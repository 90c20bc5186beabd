"""Interaction ops as the layers call them (counterpart of
``deepctr_tpu/ops/dispatch.py``)."""

from . import reference as _ref


def fm_cross(inputs):
    # no kernel, as in the JAX package: the FM reduction is a few
    # elementwise passes over [B, F, E]
    return _ref.fm_cross_ref(inputs)
