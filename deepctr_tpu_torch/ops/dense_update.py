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
a float32 [2] on the device.  A parameter may carry an L2 vector ``l2``,
float32 [period] (a table's columns, period its width, or one float): its
gradient is then ``g + (2 * l2) * p`` by column before the step (``(2 *
l2) * p`` alone for a None gradient), the L2 penalty ``sum(l2 * p^2)``'s
gradient, rounded as the row update K2 adds it (``ops/row_update.py``).

``dense_update`` launches the CUDA kernel in
``csrc/dense_update.cu`` for CUDA tensors (up to ``CAPACITY`` parameters a
launch, their arguments passed by value: ``launch_plan``,
``kernel_args``), or raises; it takes the plain version
``dense_update_ref`` (PyTorch operations, one parameter at a time) only
because its tensors lie on the CPU.  The two round the same operations in
the same order with the same float32 constants, so they agree bit for
bit.

``dense_penalty`` launches the penalty's value, ``sum_p sum(l2 * p^2)``
over every parameter with an L2 vector, into one float32 on the device
(the same structs and plan; a deterministic sum in a fixed order, within
float32 rounding of ``dense_penalty_ref``, which sums parameter by
parameter).
"""

import ctypes

import torch

from . import _build
from .row_update import (ADAGRAD_EPS, ADAM_B1, ADAM_B2, ADAM_EPS, MODES,
                         RMS_DECAY, RMS_EPS)


@torch.no_grad()
def dense_update_ref(name, params, grads, states, lr, bias=None, l2s=None):
    """Plain PyTorch version, one parameter at a time.  Arguments as
    :func:`dense_update`."""
    if name == "adam" and params:
        # device tensors: CUDA divides by a host scalar as a multiply by
        # its reciprocal
        bc1, bc2 = bias[0], bias[1]
    for p, g, st, l2 in zip(params, grads, states, _l2_list(l2s, params)):
        if l2 is not None:
            # element i's L2 is l2[i % period]
            r = ((2 * l2) * p.reshape(-1, l2.numel())).view_as(p)
            g = r if g is None else g + r
        elif g is None:
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


@torch.no_grad()
def dense_penalty_ref(params, l2s):
    """Plain PyTorch version of :func:`dense_penalty`, one parameter at a
    time; None where no parameter has an L2 vector."""
    total = None
    for p, l2 in zip(params, l2s):
        if l2 is not None:
            term = torch.sum(l2 * (p * p).reshape(-1, l2.numel()))
            total = term if total is None else total + term
    return total


def _l2_list(l2s, params):
    return [None] * len(params) if l2s is None else l2s


def _check_l2(params, l2s):
    if len(l2s) != len(params):
        raise ValueError("dense_update needs one L2 vector or None a "
                         "parameter, got %d for %d parameters"
                         % (len(l2s), len(params)))
    for p, l2 in zip(params, l2s):
        if l2 is None:
            continue
        if (l2.dtype != torch.float32 or l2.dim() != 1
                or not l2.is_contiguous() or l2.device != p.device
                or l2.numel() not in (1, p.shape[-1] if p.dim() else 1)):
            raise ValueError(
                "an L2 vector must be a contiguous float32 [1] or [width] "
                "on its parameter's device, got %s %s %s beside a %s "
                "parameter on %s" % (l2.dtype, tuple(l2.shape), l2.device,
                                     tuple(p.shape), p.device))


def _check(name, params, grads, states, bias, l2s=None):
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
    if l2s is not None:
        _check_l2(params, l2s)


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
    _fields_ = ([(name, ctypes.c_void_p)
                 for name in ("p", "g", "s1", "s2", "l2")]
                + [("numel", ctypes.c_longlong), ("period", ctypes.c_int)])


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


_LAYOUT = {"dense_update_args_bytes": ctypes.sizeof(_Args),
           "dense_update_capacity": CAPACITY, "dense_update_chunk": CHUNK}
_KERNEL = _build.StructFn("dense_update", "dense_update_f32", _LAYOUT)
# (args, partials, done, out, accumulate, stream)
_PENALTY = _build.StructFn("dense_update", "dense_penalty_f32", _LAYOUT,
                           extra=[ctypes.c_void_p] * 3 + [ctypes.c_int])


def _pack(tensors, **fields):
    """``tensors`` (a :class:`_Tensor` each) in one :class:`_Args` a launch
    of :func:`launch_plan`, each with ``fields`` set."""
    out = []
    for planned in launch_plan([t.numel for t in tensors]):
        a = _Args(**fields)
        first = [_INT_MAX] * CAPACITY
        for j, (i, first_block, _) in enumerate(planned):
            first[j] = first_block
            a.tensor[j] = tensors[i]
        a.first_block[:] = first
        a.n_tensors = len(planned)
        a.n_blocks = planned[-1][1] + planned[-1][2]
        out.append(a)
    return out


def kernel_args(name, params, grads, states, lr, bias=None, l2s=None):
    """The kernel's argument structs, one a launch of :func:`launch_plan`,
    in host memory: nothing is allocated on or copied to the device.
    Arguments as :func:`dense_update`, already checked."""
    tensors = []
    for p, g, st, l2 in zip(params, grads, states, _l2_list(l2s, params)):
        tensors.append(_Tensor(
            p.data_ptr(), 0 if g is None else g.data_ptr(),
            st[0].data_ptr() if st else 0,
            st[1].data_ptr() if len(st) > 1 else 0,
            0 if l2 is None else l2.data_ptr(), p.numel(),
            0 if l2 is None else l2.numel()))
    eps, d1, c1, d2, c2 = _CONSTS[name]
    return _pack(tensors, bias=bias.data_ptr() if name == "adam" else 0,
                 mode=MODES[name][0], neg_lr=-lr, eps=eps, d1=d1, c1=c1,
                 d2=d2, c2=c2)


def _pointers(ts):
    return tuple(0 if t is None else t.data_ptr() for t in ts)


def cached_args(cache, name, params, grads, states, lr, bias, l2s=None):
    """:func:`kernel_args` from ``cache`` (a :class:`~._args.DeviceArgs`),
    rebuilt only when their key (the optimizer, its rate and every pointer
    and size they hold) changes: an eager step whose gradients are new
    tensors rebuilds them; a captured graph holds its launches and builds
    nothing on a replay."""
    l2s = _l2_list(l2s, params)
    key = (name, lr, 0 if bias is None else bias.data_ptr(),
           tuple((p.data_ptr(), p.numel(), 0 if g is None else g.data_ptr(),
                  tuple(s.data_ptr() for s in st))
                 for p, g, st in zip(params, grads, states)),
           _pointers(l2s))
    return cache.get(key, lambda: kernel_args(name, params, grads, states,
                                              lr, bias, l2s))


def launch(args, device):
    """Launches the kernel once for each struct of ``args``
    (:func:`kernel_args`) on ``device``'s current stream."""
    _KERNEL.launch_all(device, args, "dense_update")


def penalty_args(params, l2s):
    """The penalty's launches for the parameters of ``params`` that carry
    an L2 vector: ``(structs, partials, done, out)``, the structs one a
    launch of their :func:`launch_plan` (the optimizer's fields unset), a
    float32 buffer of one float a block of the largest launch, the
    launches' count (int32 [1], 0 between launches) and the float32 [1]
    the sum goes to, on the parameters' device."""
    tensors = [_Tensor(p=p.data_ptr(), l2=l2.data_ptr(), numel=p.numel(),
                       period=l2.numel())
               for p, l2 in zip(params, l2s) if l2 is not None]
    structs = _pack(tensors)
    device = params[0].device
    blocks = max((a.n_blocks for a in structs), default=1)
    return (structs, torch.zeros(blocks, device=device),
            torch.zeros(1, dtype=torch.int32, device=device),
            torch.zeros(1, device=device))


def dense_penalty(params, l2s, cache=None):
    """``sum_p sum_i l2_p[i % period] * p_i^2`` over the parameters of
    ``params`` whose entry of ``l2s`` (an L2 vector as
    :func:`dense_update` takes, or None) is given, as a float32 0-d tensor
    on their device; None where no parameter has one.

    On CUDA tensors one launch of ``csrc/dense_update.cu``'s penalty
    kernel a plan launch (one for up to CAPACITY parameters), counted as
    ``dense_penalty``: the tensor returned is the workspace's and the
    next call overwrites it.  ``cache``, a :class:`~._args.DeviceArgs`
    the caller keeps, holds the structs and workspace between calls (a
    captured graph replays the launches with them); without one they are
    built a call.  On CPU tensors it runs :func:`dense_penalty_ref`."""
    if all(l2 is None for l2 in l2s):
        return None
    _check_l2(params, l2s)
    for p, l2 in zip(params, l2s):
        if l2 is not None and (p.dtype != torch.float32
                               or not p.is_contiguous()):
            raise ValueError("dense_penalty needs contiguous float32 "
                             "parameters, got %s strides %s"
                             % (p.dtype, p.stride()))
    device = params[0].device
    if device.type == "cpu":
        return dense_penalty_ref(params, l2s)
    if device.type != "cuda":
        raise ValueError("no dense-penalty kernel for device %s" % device)
    key = tuple((p.data_ptr(), p.numel()) for p in params) + (
        _pointers(l2s),)
    return launch_penalty(
        penalty_args(params, l2s) if cache is None else
        cache.get(key, lambda: penalty_args(params, l2s)), device)


def launch_penalty(work, device):
    """Launches the penalty's kernel once for each struct of ``work``
    (:func:`penalty_args`) on ``device``'s current stream, the first
    setting the sum and the others adding to it; returns the sum, a
    float32 0-d view of the workspace."""
    structs, partials, done, out = work
    for i, a in enumerate(structs):
        _PENALTY.launch(device, ctypes.addressof(a), partials.data_ptr(),
                        done.data_ptr(), out.data_ptr(), int(i > 0),
                        count="dense_penalty")
    return out.view(())


def dense_update(name, params, grads, states, lr, bias=None, cache=None,
                 l2s=None):
    """One ``name`` optimizer step of every parameter of ``params``, in the
    launches of :func:`launch_plan` (one for up to CAPACITY parameters).

    ``params`` are float32 tensors, updated in place; ``grads`` one a
    parameter, of its shape, or None for a zero gradient; ``states`` a
    tuple a parameter (none for sgd, ``(acc,)`` for adagrad and rmsprop,
    ``(m, v)`` for adam), each tensor shaped like its parameter and updated
    in place; ``lr`` a Python float; ``bias`` adam's float32 [2]
    ``(1-b1^t, 1-b2^t)``, on the parameters' device; ``l2s`` one L2
    vector (float32 [1], or [width] along a parameter's last dimension)
    or None a parameter, or None for none at all.  Every tensor is
    contiguous.  ``cache``, a :class:`~._args.DeviceArgs` the caller
    keeps, holds the argument structs between calls
    (:func:`cached_args`).

    On CUDA tensors this launches the kernel (building it at first use) or
    raises; on CPU tensors it runs ``dense_update_ref``."""
    _check(name, params, grads, states, bias, l2s)
    if not params:
        return
    device = params[0].device
    if device.type == "cpu":
        dense_update_ref(name, params, grads, states, lr, bias, l2s)
        return
    if device.type != "cuda":
        raise ValueError("no dense-update kernel for device %s" % device)
    launch(kernel_args(name, params, grads, states, lr, bias, l2s)
           if cache is None else
           cached_args(cache, name, params, grads, states, lr, bias, l2s),
           device)
    # the kernel writes behind PyTorch's back: advance the version counters
    # as the in-place operations of the plain version do, so that a copy
    # kept against them (ops._args.ParamCache) is rebuilt
    torch.autograd.graph.increment_version(
        list(params) + [s for st in states for s in st])
