"""DIEN and PLE on a mesh (``tests/test_parallel.py:111-171``'s models and
data) against the JAX package on the same mesh and the port's one rank,
at world size one, on the data-parallel ``(2, 1)`` mesh and on ``(2,
2)`` with row-sharded tables: DIEN's AUGRU with negative
sampling runs the GRU's forward and backward and the auxiliary loss over
a split batch, PLE its stacked expert groups and a loss list.  And the
witness that DIEN's auxiliary loss divides by the global batch's count
of pairs.  The legs and tolerances of ``tests/test_torch_parallel.py``."""

import numpy as np
import pytest

from tests.test_torch_parallel import (  # noqa: F401 (the fixture)
    DATA, check_leg, check_world_size_one, one_rank, ranks)

SEQ = ["dien", "ple", "dien_count", "dien_count_local"]
MESH_LEGS = {(1, 1): SEQ, (2, 1): SEQ, (2, 2): ["dien", "ple"]}


@pytest.mark.parametrize("name", SEQ)
def test_world_size_one_is_bit_equal(ranks, name):
    check_world_size_one(ranks, name)


@pytest.mark.parametrize("name", ["dien", "ple", "dien_count"])
def test_data_parallel_mesh_matches_jax_and_one_rank(ranks, name):
    check_leg(ranks, (2, 1), name)


@pytest.mark.parametrize("name", ["dien", "ple"])
def test_mesh_matches_jax_and_one_rank(ranks, name):
    check_leg(ranks, (2, 2), name)


def _aux(run):
    """Each step's auxiliary term: total less data loss (no penalty)."""
    return np.array([total - data for data, total in run["steps"]])


def test_dien_aux_loss_divides_by_the_global_pair_count(ranks):
    """DIEN's auxiliary loss is the global batch's mean over its pairs,
    though rank 0 holds 2 pairs a step and rank 1 many: each step's
    auxiliary term and the epoch losses within 1e-5 of one process under sgd,
    while the same ranks dividing by their own counts miss that bound."""
    x, _ = DATA["dien_count"]
    pairs = np.maximum(x["seq_length"] - 1, 0).reshape(-1, 2, 8).sum(-1)
    assert np.all(pairs[:, 0] == 2) and np.all(pairs[:, 1] >= 16)
    one = one_rank("dien_count")
    runs = ranks((2, 1))
    for r in runs["dien_count"]:
        np.testing.assert_allclose(_aux(r), _aux(one), rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
    assert np.all(_aux(one) > 0.1)
    local = runs["dien_count_local"][0]
    assert np.abs(_aux(local) - _aux(one)).max() > 1e-5
    assert not np.allclose(local["loss"], one["loss"], rtol=1e-5, atol=0)
