"""Small argument arrays that the host builds for the kernels, and the
kernels' copies of weights."""

import torch


def device_array(values, dtype, device):
    """``values`` as a 1-D tensor on ``device``.

    For a CUDA device the copy goes from pinned memory without blocking
    the host (PyTorch keeps the pinned block until the copy has run), so
    that building a kernel's arguments never waits for the work queued
    before it."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.tensor(values, dtype=dtype, device=device)
    host = torch.tensor(values, dtype=dtype, pin_memory=True)
    return host.to(device, non_blocking=True)


class ParamCache:
    """A kernel's copy of some parameters (cast, transposed or packed),
    kept between calls and rebuilt when a parameter changed in place (its
    version counter), was replaced (``.to()``, a new ``.data``) or the key
    changed.

    The entry holds a detached alias of each parameter, so that memory a
    replaced parameter freed is not reused at the address the entry checks.
    While autograd records through a parameter the copy is built afresh
    and not kept: it must then carry the graph."""

    def __init__(self):
        self._entry = None

    def get(self, params, key, build):
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return build()
        entry = self._entry
        if (entry is None or entry[0] != key or len(entry[1]) != len(params)
                or any(a.data_ptr() != p.data_ptr() or v != p._version
                       for a, v, p in zip(entry[1], entry[2], params))):
            entry = (key, [p.detach() for p in params],
                     [p._version for p in params], build())
            self._entry = entry
        return entry[3]
