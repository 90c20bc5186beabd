"""Interaction ops as the layers call them (counterpart of
``deepctr_tpu/ops/dispatch.py``)."""

from . import reference as _ref


def fm_cross(inputs):
    # no kernel, as in the JAX package: the FM reduction is a few
    # elementwise passes over [B, F, E]
    return _ref.fm_cross_ref(inputs)


def din_attention(scores, keys, keys_masks, weight_normalization,
                  return_score):
    # the composition the fused kernel (ops/attention.py) stands in for at
    # inference; training and return_score run it, as in the JAX package
    return _ref.din_attention_ref(scores, keys, keys_masks,
                                  weight_normalization, return_score)
