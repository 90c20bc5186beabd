"""Small argument arrays that the host builds for the kernels, and the
kernels' copies of weights.

A CUDA graph replays the device work of a captured step and none of its
host code: an array uploaded during the capture would be read from host
memory that PyTorch may have freed or reused by the time the graph
replays, and a cached copy of weights would be checked on the host only
once.  So an argument array is built before any capture, kept on the
device and rebuilt only when its key changes (:class:`DeviceArgs`); an
upload during a capture raises; and a weight copy is rebuilt inside the
graph (:class:`ParamCache`)."""

import torch


def capturing():
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def device_array(values, dtype, device):
    """``values`` as a 1-D tensor on ``device``.

    For a CUDA device the copy goes from pinned memory without blocking
    the host (PyTorch keeps the pinned block until the copy has run), so
    that building a kernel's arguments never waits for the work queued
    before it.  Raises while a CUDA graph is being captured."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.tensor(values, dtype=dtype, device=device)
    if capturing():
        raise RuntimeError("a kernel's argument array was uploaded during "
                           "a CUDA graph capture: build it before capturing")
    host = torch.as_tensor(values, dtype=dtype).pin_memory()
    return host.to(device, non_blocking=True)


class DeviceArgs:
    """A kernel's argument array on the device, kept between calls and
    rebuilt only when its key (the pointers and shapes it is made of)
    changes: a call copies nothing to the device but its data."""

    def __init__(self):
        self._key = None
        self._array = None

    def get(self, key, values, dtype, device):
        """The array of ``values()`` for ``key`` on ``device``."""
        key = (torch.device(device), key)
        if key != self._key:
            self._array = device_array(values(), dtype, device)
            self._key = key
        return self._array


class ParamCache:
    """A kernel's copy of some parameters (cast, transposed or packed),
    kept between calls and rebuilt when a parameter changed in place (its
    version counter), was replaced (``.to()``, a new ``.data``) or the key
    changed.

    The entry holds a detached alias of each parameter, so that memory a
    replaced parameter freed is not reused at the address the entry checks.
    While autograd records through a parameter the copy is built afresh
    and not kept: it must then carry the graph.  While a CUDA graph is
    captured it is built afresh too, so that every replay rebuilds it from
    the parameters as they are then (a replay runs no host check)."""

    def __init__(self):
        self._entry = None

    def get(self, params, key, build):
        if (torch.is_grad_enabled() and any(p.requires_grad for p in params)
                or capturing() or torch.compiler.is_compiling()):
            return build()
        entry = self._entry
        if (entry is None or entry[0] != key or len(entry[1]) != len(params)
                or any(a.data_ptr() != p.data_ptr() or v != p._version
                       for a, v, p in zip(entry[1], entry[2], params))):
            entry = (key, [p.detach() for p in params],
                     [p._version for p in params], build())
            self._entry = entry
        return entry[3]
