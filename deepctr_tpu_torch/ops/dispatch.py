"""Interaction ops as the layers call them (counterpart of
``deepctr_tpu/ops/dispatch.py``)."""

from . import cin as _cin
from . import reference as _ref


def fm_cross(inputs):
    # no kernel, as in the JAX package: the FM reduction is a few
    # elementwise passes over [B, F, E]
    return _ref.fm_cross_ref(inputs)


def cin_layer(hidden, x0, w, b):
    return _ref.cin_layer_ref(hidden, x0, w, b)


def cin_mix(hidden_t, x0_t, w3, wt=None, wm=None, out_dtype=None):
    # the kernel on CUDA tensors in training and at inference alike (the
    # JAX package runs its kernel at inference unless set_use_pallas(True)),
    # float32 output included; the plain version on CPU tensors
    return _cin.cin_mix(hidden_t, x0_t, w3, wt=wt, wm=wm,
                        out_dtype=out_dtype)


def cross_net(x, kernels, bias, parameterization="vector"):
    # no kernel, as in the JAX package: two small products a layer
    return _ref.cross_net_ref(x, kernels, bias, parameterization)


def din_attention(scores, keys, keys_masks, weight_normalization,
                  return_score):
    # the composition the fused kernel (ops/attention.py) stands in for at
    # inference; training and return_score run it, as in the JAX package
    return _ref.din_attention_ref(scores, keys, keys_masks,
                                  weight_normalization, return_score)
