"""The optimizer step of every dense parameter, in one launch.

The train step's dense optimizer (``models/basemodel.py:DenseOptimizer``)
steps each parameter ``p`` with its gradient ``g`` (None steps with a
zero gradient, as optax steps every leaf) in the JAX package's arithmetic
(``deepctr_tpu/models/basemodel.py:59-136`` and ``optax.adam``)::

    sgd      p += -lr * g
    adagrad  a += g^2;  p += -lr * g / (sqrt(a) + 1e-10)
    rmsprop  v = 0.99 v + 0.01 g^2;  p += -lr * g / (sqrt(v) + 1e-8)
    adam     m = 0.1 g + 0.9 m;  v = 0.001 g^2 + 0.999 v;
             p += -lr * ((m / bc1) / (sqrt(v / bc2) + 1e-8))

with adam's bias corrections ``bias = (bc1, bc2) = (1 - b1^t, 1 - b2^t)``
a float32 [2] on the device.  ``dense_update`` launches the CUDA kernel in
``csrc/dense_update.cu`` for CUDA tensors (up to ``CAPACITY`` parameters a
launch, their arguments passed by value: ``launch_plan``,
``kernel_args``), or raises; it takes the plain version
``dense_update_ref`` (PyTorch operations, one parameter at a time) only
because its tensors lie on the CPU.  The two round the same operations in
the same order with the same float32 constants, so they agree bit for
bit.
"""

import ctypes

import torch

from . import _build
from .row_update import (ADAGRAD_EPS, ADAM_B1, ADAM_B2, ADAM_EPS, MODES,
                         RMS_DECAY, RMS_EPS)


@torch.no_grad()
def dense_update_ref(name, params, grads, states, lr, bias=None):
    """Plain PyTorch version, one parameter at a time.  Arguments as
    :func:`dense_update`."""
    if name == "adam" and params:
        # device tensors: CUDA divides by a host scalar as a multiply by
        # its reciprocal
        bc1, bc2 = bias[0], bias[1]
    for p, g, st in zip(params, grads, states):
        if g is None:
            g = torch.zeros_like(p)
        if name == "sgd":
            u = -lr * g
        elif name == "adagrad":
            st[0].add_(g * g)
            u = -lr * g / (torch.sqrt(st[0]) + ADAGRAD_EPS)
        elif name == "rmsprop":
            v = st[0]
            v.copy_(RMS_DECAY * v + (1 - RMS_DECAY) * (g * g))
            u = -lr * g / (torch.sqrt(v) + RMS_EPS)
        else:
            m, v = st
            m.copy_((1 - ADAM_B1) * g + ADAM_B1 * m)
            v.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * v)
            u = -lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
        p.add_(u)


def _check(name, params, grads, states, bias):
    if name not in MODES:
        raise ValueError("dense_update supports %s, got %r"
                         % (sorted(MODES), name))
    if not len(params) == len(grads) == len(states):
        raise ValueError("dense_update needs one gradient and one state "
                         "tuple a parameter, got %d parameters, %d "
                         "gradients, %d state tuples"
                         % (len(params), len(grads), len(states)))
    n_state = MODES[name][1]
    devices = set()
    for p, g, st in zip(params, grads, states):
        if len(st) != n_state:
            raise ValueError("%s carries %d state tensors a parameter, got "
                             "%d" % (name, n_state, len(st)))
        for a in (p,) + ((g,) if g is not None else ()) + tuple(st):
            if a.dtype != torch.float32 or a.shape != p.shape:
                raise ValueError(
                    "parameter, gradient and state must be float32 of one "
                    "shape, got %s %s beside a %s %s parameter"
                    % (a.dtype, tuple(a.shape), p.dtype, tuple(p.shape)))
            if not a.is_contiguous():
                raise ValueError("dense_update needs contiguous tensors, got "
                                 "strides %s" % (a.stride(),))
            devices.add(a.device)
    if name == "adam" and params:
        if (bias is None or tuple(bias.shape) != (2,)
                or bias.dtype != torch.float32 or not bias.is_contiguous()):
            raise ValueError("adam's (1-b1^t, 1-b2^t) must be a contiguous "
                             "float32 [2] tensor, got %s" % (
                                 None if bias is None else "%s %s" % (
                                     bias.dtype, tuple(bias.shape)),))
        devices.add(bias.device)
    if len(devices) > 1:
        raise ValueError("dense_update's tensors must be on one device, got "
                         "%s" % sorted(map(str, devices)))


# the kernel's layout (csrc/dense_update.cu: kMaxTensors, kChunk, Args),
# checked against the built library at first use
CAPACITY = 64     # parameters one launch's argument struct holds
CHUNK = 2048      # floats a block takes
_INT_MAX = 2 ** 31 - 1


def launch_plan(numels, capacity=CAPACITY):
    """The kernel's launches for parameters of ``numels`` floats: a list of
    ``[(parameter, first_block, blocks), ...]``, one a launch, at most
    ``capacity`` parameters each, in order.  A parameter's floats go in
    blocks of CHUNK (the last one shorter), numbered from 0 in each
    launch; an empty parameter is left out.  Nothing to update, no
    launch."""
    ts = [i for i, n in enumerate(numels) if n > 0]
    plan = []
    for c in range(0, len(ts), capacity):
        planned, first = [], 0
        for i in ts[c:c + capacity]:
            blocks = -(-numels[i] // CHUNK)
            planned.append((i, first, blocks))
            first += blocks
        plan.append(planned)
    return plan


class _Tensor(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in ("p", "g", "s1", "s2")]
                + [("numel", ctypes.c_longlong)])


class _Args(ctypes.Structure):
    _fields_ = ([("first_block", ctypes.c_int * CAPACITY),
                 ("tensor", _Tensor * CAPACITY),
                 ("bias", ctypes.c_void_p)]
                + [(name, ctypes.c_int) for name in ("n_tensors", "n_blocks",
                                                     "mode")]
                + [(name, ctypes.c_float)
                   for name in ("neg_lr", "eps", "d1", "c1", "d2", "c2")])


# each optimizer's (eps, d1, c1, d2, c2), the Python doubles its plain
# version multiplies and adds, rounded to float32 by the struct as PyTorch
# rounds a scalar operand of a float32 tensor
_CONSTS = {"sgd": (0.0, 0.0, 0.0, 0.0, 0.0),
           "adagrad": (ADAGRAD_EPS, 0.0, 0.0, 0.0, 0.0),
           "rmsprop": (RMS_EPS, RMS_DECAY, 1 - RMS_DECAY, 0.0, 0.0),
           "adam": (ADAM_EPS, ADAM_B1, 1 - ADAM_B1, ADAM_B2, 1 - ADAM_B2)}


_KERNEL = _build.StructFn("dense_update", "dense_update_f32", {
    "dense_update_args_bytes": ctypes.sizeof(_Args),
    "dense_update_capacity": CAPACITY, "dense_update_chunk": CHUNK})


def kernel_args(name, params, grads, states, lr, bias=None):
    """The kernel's argument structs, one a launch of :func:`launch_plan`,
    in host memory: nothing is allocated on or copied to the device.
    Arguments as :func:`dense_update`, already checked."""
    mode, _ = MODES[name]
    out = []
    for planned in launch_plan([p.numel() for p in params]):
        a = _Args()
        first = [_INT_MAX] * CAPACITY
        for j, (i, first_block, _) in enumerate(planned):
            first[j] = first_block
            st = states[i]
            g = grads[i]
            a.tensor[j] = _Tensor(
                params[i].data_ptr(), 0 if g is None else g.data_ptr(),
                st[0].data_ptr() if st else 0,
                st[1].data_ptr() if len(st) > 1 else 0, params[i].numel())
        a.first_block[:] = first
        a.bias = bias.data_ptr() if name == "adam" else 0
        a.n_tensors = len(planned)
        a.n_blocks = planned[-1][1] + planned[-1][2]
        a.mode = mode
        a.neg_lr = -lr
        a.eps, a.d1, a.c1, a.d2, a.c2 = _CONSTS[name]
        out.append(a)
    return out


def cached_args(cache, name, params, grads, states, lr, bias):
    """:func:`kernel_args` from ``cache`` (a :class:`~._args.DeviceArgs`),
    rebuilt only when their key (the optimizer, its rate and every pointer
    and size they hold) changes: an eager step whose gradients are new
    tensors rebuilds them; a captured graph holds its launches and builds
    nothing on a replay."""
    key = (name, lr, 0 if bias is None else bias.data_ptr(),
           tuple((p.data_ptr(), p.numel(), 0 if g is None else g.data_ptr(),
                  tuple(s.data_ptr() for s in st))
                 for p, g, st in zip(params, grads, states)))
    return cache.get(key, lambda: kernel_args(name, params, grads, states,
                                              lr, bias))


def launch(args, device):
    """Launches the kernel once for each struct of ``args``
    (:func:`kernel_args`) on ``device``'s current stream."""
    _KERNEL.launch_all(device, args, "dense_update")


def dense_update(name, params, grads, states, lr, bias=None, cache=None):
    """One ``name`` optimizer step of every parameter of ``params``, in the
    launches of :func:`launch_plan` (one for up to CAPACITY parameters).

    ``params`` are float32 tensors, updated in place; ``grads`` one a
    parameter, of its shape, or None for a zero gradient; ``states`` a
    tuple a parameter (none for sgd, ``(acc,)`` for adagrad and rmsprop,
    ``(m, v)`` for adam), each tensor shaped like its parameter and updated
    in place; ``lr`` a Python float; ``bias`` adam's float32 [2]
    ``(1-b1^t, 1-b2^t)``, on the parameters' device.  Every tensor is
    contiguous.  ``cache``, a :class:`~._args.DeviceArgs` the caller
    keeps, holds the argument structs between calls
    (:func:`cached_args`).

    On CUDA tensors this launches the kernel (building it at first use) or
    raises; on CPU tensors it runs ``dense_update_ref``."""
    _check(name, params, grads, states, bias)
    if not params:
        return
    device = params[0].device
    if device.type == "cpu":
        dense_update_ref(name, params, grads, states, lr, bias)
        return
    if device.type != "cuda":
        raise ValueError("no dense-update kernel for device %s" % device)
    launch(kernel_args(name, params, grads, states, lr, bias)
           if cache is None else
           cached_args(cache, name, params, grads, states, lr, bias), device)
    # the kernel writes behind PyTorch's back: advance the version counters
    # as the in-place operations of the plain version do, so that a copy
    # kept against them (ops._args.ParamCache) is rebuilt
    torch.autograd.graph.increment_version(
        list(params) + [s for st in states for s in st])
