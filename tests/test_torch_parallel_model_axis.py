"""The port on a ``(1, 2)`` mesh, its tables row-sharded over two model
ranks, against the JAX package on the same mesh and the port's one rank
(the legs and tolerances of ``tests/test_torch_parallel.py``), and the
per-row adam counts of each rank's blocks."""

import pytest
import torch

from tests.test_torch_parallel import (  # noqa: F401 (the fixture)
    MESH_LEGS, check_a2a_overflow, check_blocks, check_leg, one_rank, ranks)

SHAPE = (1, 2)


@pytest.mark.parametrize("name", [n for n in MESH_LEGS[SHAPE]
                                  if not n.startswith("a2a_")])
def test_model_axis_matches_jax_and_one_rank(ranks, name):
    check_leg(ranks, SHAPE, name)


def test_a2a_overflow_on_the_model_axis(ranks):
    check_a2a_overflow(ranks, SHAPE)


def test_model_ranks_hold_only_their_blocks(ranks):
    check_blocks(ranks, SHAPE)


def test_rowwise_adam_counts_are_cut_with_the_blocks(ranks):
    """Each model rank keeps the per-row counts of its block of the
    packed-size table (2051 and 2045 rows), and the blocks laid end to
    end are the one rank's counts, exactly."""
    runs = ranks(SHAPE)["sparse_adam_rowwise"]
    one = one_rank("sparse_adam_rowwise")["counts"]
    for path, full in one.items():
        parts = []
        for r in runs:
            a, b = r["blocks"].get(path, (0, full.shape[0]))
            assert r["state"][path][2] == (b - a,)
            parts.append(r["counts"][path])
        got = torch.cat(parts) if path in runs[0]["blocks"] else parts[0]
        assert torch.equal(got, full), path
    # the sharded table holds rows that no step touched
    big = one["embedding_dict/big"]
    assert 0 < int((big > 0).sum()) < big.shape[0]
