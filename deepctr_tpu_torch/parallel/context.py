"""What the layers read inside a train step on a mesh.

A train step on a mesh runs its forward inside :func:`data_shard`, which
names the ``data`` axis's process group, its size and this rank's index on
it.  Three things follow it, so that the ranks together compute what one
program over the global batch computes (as GSPMD does for the JAX
package):

- ``layers.activation.BatchNorm`` (and so ``Dice``) takes its training
  moments over the global batch: :func:`data_sum` of the sums, the sums
  of squares and the count;
- ``layers.core.Dropout`` draws the mask of the global batch and keeps
  this rank's rows (:func:`global_rows`);
- DIEN's auxiliary loss divides by the global count of its pairs.

Outside :func:`data_shard` (one process, inference, or a data axis of one
rank) every function here is the identity.
"""

import contextlib

import torch
import torch.distributed as dist

# (process group, ranks on the data axis, this rank's index) inside a
# train step on a mesh whose data axis has more than one rank; else None
_DATA = None


@contextlib.contextmanager
def data_shard(group, size, index):
    """Run the body as rank ``index`` of ``size`` on the data axis
    ``group``; a data axis of one rank changes nothing."""
    global _DATA
    saved, _DATA = _DATA, ((group, size, index) if size > 1 else None)
    try:
        yield
    finally:
        _DATA = saved


def active():
    """Whether a train step on a mesh with more than one data rank is
    running."""
    return _DATA is not None


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group, whose gradient is the sum of the
    ranks' gradients: every rank's loss reads the sum, and the train step
    sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def data_sum(t):
    """``t`` summed over the data axis inside :func:`data_shard` (with a
    gradient), ``t`` itself outside."""
    if _DATA is None:
        return t
    return _AllReduceSum.apply(t, _DATA[0])


def global_rows(n):
    """``(rows of the global batch, this rank's first row)`` for a local
    batch of ``n`` rows: ``(n, 0)`` outside :func:`data_shard`."""
    if _DATA is None:
        return n, 0
    _, size, index = _DATA
    return n * size, n * index
