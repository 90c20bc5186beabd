"""What the plain references share: products and lookups in float32 (TF32
off) or, for the control, with their operands rounded to float8 (e4m3, one
scale a tensor), the precision below the bfloat16 the configurations
state.  Imports torch alone."""

import torch

F8_MAX = 448.0


def exact_float32():
    """Keep float32 products in float32: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t):
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    to 448), back in float32."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # rounding as a straight-through step: the control's gradients are
    # those of its rounded operands
    return t + (q - t).detach()


def operand(t, precision):
    return fp8(t) if precision == "fp8" else t


def linear(x, weight, bias, precision):
    """``x @ weight.T + bias`` with ``weight`` [out, in]."""
    y = operand(x, precision) @ operand(weight, precision).t()
    return y if bias is None else y + bias


def lookup(table, ids, precision):
    """Rows of ``table`` at ``ids`` (any shape)."""
    return operand(table[ids], precision)


def dnn(x, weights, prefix, n_layers, activation, precision):
    """A tower of ``n_layers`` dense layers ``<prefix>.dense_<i>``, each
    followed by ``activation(x, i)``."""
    for i in range(n_layers):
        x = linear(x, weights["%s.dense_%d.weight" % (prefix, i)],
                   weights["%s.dense_%d.bias" % (prefix, i)], precision)
        x = activation(x, i)
    return x


def bce_sum(p, y):
    """Sum of the binary cross-entropy of probabilities ``p`` clipped to
    [1e-7, 1 - 1e-7]."""
    p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
    return -torch.sum(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
