"""The port on a ``(2, 2)`` mesh (data x model: gradients summed over two
data ranks, tables row-sharded over two model ranks) against the JAX
package on the same mesh and the port's one rank, with the explicit
exchanges, the a2a's overflow, the L2 penalty, batch statistics and
MMOE's loss list (the legs and tolerances of
``tests/test_torch_parallel.py``)."""

import pytest

from tests.test_torch_parallel import (  # noqa: F401 (the fixture)
    MESH_LEGS, check_a2a_overflow, check_blocks, check_l2_once, check_leg,
    ranks)

SHAPE = (2, 2)


@pytest.mark.parametrize("name", [n for n in MESH_LEGS[SHAPE]
                                  if not n.startswith("a2a_")])
def test_mesh_matches_jax_and_one_rank(ranks, name):
    check_leg(ranks, SHAPE, name)


def test_a2a_overflow_on_the_mesh(ranks):
    check_a2a_overflow(ranks, SHAPE)


def test_mesh_ranks_hold_only_their_blocks(ranks):
    check_blocks(ranks, SHAPE)


def test_l2_counts_once_over_the_mesh(ranks):
    check_l2_once(ranks, SHAPE)
