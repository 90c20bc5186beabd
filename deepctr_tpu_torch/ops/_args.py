"""Small argument arrays that the host builds for the kernels, and the
kernels' copies of weights.

A CUDA graph replays the device work of a captured step and none of its
host code: an array uploaded during the capture would be read from host
memory that PyTorch may have freed or reused by the time the graph
replays, and a cached copy of weights would be checked on the host only
once.  So a kernel's arguments are built before any capture and kept,
rebuilt only when their key changes (:class:`DeviceArgs`); an upload
during a capture raises; and a weight copy is rebuilt inside the graph
(:class:`ParamCache`)."""

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
    """A kernel's arguments built on the host (an array on the device, or
    argument structs in host memory), kept between calls and rebuilt only
    when their key (the pointers and shapes they are made of) changes: a
    call then builds and copies nothing.

    It holds the arguments of the last key, which a new key replaces; with
    ``every_key`` it keeps the arguments of each key it was asked for, so
    that a captured graph that read an array keeps reading it whatever
    other keys come later.  A copy (a deep-copied model, pickling) starts
    empty: the arguments hold pointers, which are not the copy's."""

    def __init__(self, every_key=False):
        self.every_key = every_key
        self._built = {}

    def get(self, key, build):
        """The arguments ``build()`` made for ``key``."""
        args = self._built.get(key)
        if args is None:
            if not self.every_key:
                self._built.clear()
            args = self._built[key] = build()
        return args

    def __reduce__(self):
        return (DeviceArgs, (self.every_key,))


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
