"""The shard-local update of row-sharded tables.

Counterpart of ``deepctr_tpu/parallel/update.py``
(``sharded_combined_update`` and ``sharded_combined3_update``, which run
``scatter_rows`` inside ``shard_map`` at ``:96`` and ``:162``).  The JAX
package stores big tables packed with their optimizer state interleaved,
and needs one function for adagrad's pairs and one for adam's triples.  The
port stores logical rows (``ROADMAP.md`` section 3), so the four optimizers
share one update: the row update K2 (``ops/row_update.py``,
``csrc/row_update.cu``) over each rank's own block, its touched rows
given by :func:`shard_local_rows` (``BaseModel._update_touched_rows``).

Every rank holds the same global touched rows of a step, and the same
summed gradient for them (the train step sums it over the mesh's ``data``
axis).  On each rank, a touched row it owns becomes a row of its block
(shifted by the block's first row); any other, and the padding past the
table, is mapped past its block, where K2 drops it.  No collective runs:
each touched row's gradient is there, and its weights and state live only
on its owner.  Under rowwise adam (``config.set_adam_t``) the state holds
the block's per-row step counts ``t`` [rows of the block] too, made at the
block's size by ``BaseModel._init_optimizer_state``: the local rows index
them as they index the block, and K2 advances only the owned ones.  The
JAX package runs rowwise sharded tables as separate leaves
(``deepctr_tpu/models/basemodel.py:544-556``), with the same arithmetic.
"""

import torch


def shard_local_rows(rows, block):
    """Touched rows (global ids, distinct; padding at ids past the table)
    as rows of this rank's block ``(first row, stop, vocab, ...)``: a row it
    owns shifted by its first row, any other mapped to ``row + vocab``,
    past the block and still distinct.  ``block`` None (a replicated
    table) keeps ``rows``."""
    if block is None:
        return rows
    base, stop, vocab = block[:3]
    owned = (rows >= base) & (rows < stop)
    return torch.where(owned, rows - base, rows + vocab)

