"""Multi-process set-up: the process group, the global mesh and each
rank's rows of a global batch.

Counterpart of ``deepctr_tpu/parallel/distributed.py``.  The JAX runtime
is multi-controller with one process a host; here every rank is a process
with one device.  A run on one host:

    torchrun --nproc-per-node 4 train.py

and in ``train.py``, the same on every rank:

    from deepctr_tpu_torch.parallel import distributed as dist
    rank, world = dist.initialize()          # torchrun's environment
    mesh = dist.global_mesh(model_axis=2)    # (2, 2): data x model
    torch.cuda.set_device(rank % torch.cuda.device_count())
    model = DeepFM(cols, cols, mesh=mesh, shard_embeddings=True)
    model.compile("adagrad", "binary_crossentropy")
    model.fit(x, y, batch_size=4096)         # the same arrays on every rank

``tools/multiprocess_sim.py`` spawns such ranks on one machine.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .sharding import batch_sharding, make_mesh


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               timeout=None, device=None):
    """Join the process group; returns ``(rank, world size)``.

    With ``init_method`` (``"file://..."``, ``"tcp://host:port"``),
    ``world_size`` and ``rank`` it joins that group; without them it reads
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/
    ``MASTER_PORT``).  With neither there is nothing to join: a single
    process passes through as ``(0, 1)``, as ``jax.distributed`` does.  An
    initialised group passes through too.  ``backend`` defaults to NCCL
    for a CUDA ``device`` (the default, which raises without CUDA) and
    gloo for ``device="cpu"``; ``timeout`` (seconds) bounds every
    collective.  A failure to join raises."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and world_size is None and not env:
        return 0, 1
    if backend is None:
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' "
                               "(gloo) or a backend")
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if init_method is None and not env:
        raise ValueError("initialize needs init_method beside world_size "
                         "and rank, or torchrun's environment")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def global_mesh(model_axis=1, devices=None):
    """A ``("data", "model")`` mesh over every rank, ``model_axis`` of
    them on the table-sharding axis."""
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError("%d ranks not divisible by model_axis=%d"
                         % (n, model_axis))
    return make_mesh((n // model_axis, model_axis), devices=devices)


def host_local_rows(global_batch_size, mesh=None):
    """``(start, stop)`` rows of a global batch that this rank feeds: its
    data coordinate's rows on ``mesh``, else its rank's share of the
    process group (one process: every row)."""
    if mesh is not None:
        rows = batch_sharding(mesh, global_batch_size)
        return rows.start, rows.stop
    if dist.is_initialized():
        size, index = dist.get_world_size(), dist.get_rank()
    else:
        size, index = 1, 0
    if global_batch_size % size:
        raise ValueError("global batch %d not divisible by %d ranks"
                         % (global_batch_size, size))
    per = global_batch_size // size
    return index * per, (index + 1) * per


def global_batch_from_host_local(mesh, *host_arrays, device=None):
    """This rank's rows of a global batch, as tensors (on ``device``):
    what a rank holds of the batch that the JAX package assembles with
    ``jax.make_array_from_process_local_data``.  Every array must have the
    same rows, and every rank of the mesh as many (checked with one
    all-reduce), so that the global batch divides the data axis."""
    rows = {np.shape(a)[0] for a in host_arrays}
    if len(rows) != 1:
        raise ValueError("host arrays have different row counts: %s"
                         % sorted(rows))
    n = rows.pop()
    if dist.is_initialized() and dist.get_world_size() > 1:
        # the largest and the smallest count in one all-reduce
        on = "cuda" if dist.get_backend() == "nccl" else "cpu"
        probe = torch.tensor([n, -n], dtype=torch.int64, device=on)
        dist.all_reduce(probe, op=dist.ReduceOp.MAX)
        if int(probe[0]) != n or -int(probe[1]) != n:
            raise ValueError("ranks hold different row counts (%d here, "
                             "%d to %d over the ranks): the global batch "
                             "does not divide the processes"
                             % (n, -int(probe[1]), int(probe[0])))
    out = [torch.as_tensor(np.asarray(a)) for a in host_arrays]
    if device is not None:
        out = [t.to(device) for t in out]
    return out[0] if len(out) == 1 else tuple(out)
