"""Small argument arrays that the host builds for the kernels."""

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
