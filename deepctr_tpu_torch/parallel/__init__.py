"""Data-parallel and row-sharded runs over a device mesh of ranks.

Counterpart of ``deepctr_tpu/parallel/``.  The JAX package runs one
program over the global batch and lets GSPMD place it on a ``("data",
"model")`` mesh.  Here every rank is a process of its own
(``torch.distributed``, one device each) and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with those two dimensions:

  * the batch is split over ``data``: every rank calls ``fit``, ``evaluate``
    and ``predict`` with the same arguments and takes its rows of each
    global batch; the gradients are summed over ``data`` with
    ``all_reduce``;
  * embedding tables can be row-sharded over ``model``
    (``shard_embeddings=True``): each rank keeps its block of rows and of
    their optimizer state, looks rows up through an exchange
    (``embedding.py``) and updates only the rows it owns (``update.py``).

``distributed.py`` brings the process group up; ``sharding.py`` builds the
mesh and holds the placement rules; ``context.py`` is what the layers read
inside a train step on a mesh (batch statistics and dropout masks over the
global batch).
"""

from .sharding import (make_mesh, batch_sharding, replicated,
                       embedding_sharding, shard_variables)
