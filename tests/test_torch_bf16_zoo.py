"""bfloat16 parity of the port's zoo against the JAX package, the first
eight single-task models of ``tests/test_bf16_zoo.py`` (the check and its
bound: ``tests/torch_bf16_parity.py``); the rest in
``tests/test_torch_bf16_zoo_rest.py``, the multi-task models in
``tests/test_torch_bf16_zoo_mtl.py``, DIN, DIEN and the small-table
lookups in ``tests/test_torch_bf16_zoo_seq.py``."""

import pytest

from tests import torch_bf16_parity as B


@pytest.mark.parametrize("name", B.SINGLE_TASK[:8])
def test_bf16_single_task_matches_jax_within_its_own_gap(name):
    B.check(name)
