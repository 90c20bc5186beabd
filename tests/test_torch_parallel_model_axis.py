"""The port on a ``(1, 2)`` mesh, its tables row-sharded over two model
ranks, against the JAX package on the same mesh and the port's one rank
(the legs and tolerances of ``tests/test_torch_parallel.py``)."""

import pytest

from tests.test_torch_parallel import (  # noqa: F401 (the fixture)
    MESH_LEGS, check_a2a_overflow, check_blocks, check_leg, ranks)

SHAPE = (1, 2)


@pytest.mark.parametrize("name", [n for n in MESH_LEGS[SHAPE]
                                  if not n.startswith("a2a_")])
def test_model_axis_matches_jax_and_one_rank(ranks, name):
    check_leg(ranks, SHAPE, name)


def test_a2a_overflow_on_the_model_axis(ranks):
    check_a2a_overflow(ranks, SHAPE)


def test_model_ranks_hold_only_their_blocks(ranks):
    check_blocks(ranks, SHAPE)
