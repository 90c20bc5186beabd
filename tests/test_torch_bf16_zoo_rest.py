"""bfloat16 parity of the port's zoo against the JAX package: the last
eight single-task models of ``tests/test_bf16_zoo.py`` (the check and its
bound: ``tests/torch_bf16_parity.py``)."""

import pytest

from tests import torch_bf16_parity as B


@pytest.mark.parametrize("name", B.SINGLE_TASK[8:])
def test_bf16_single_task_matches_jax_within_its_own_gap(name):
    B.check(name)
