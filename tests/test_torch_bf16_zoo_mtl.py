"""bfloat16 parity of the port's multi-task models against the JAX
package, on ``tests/test_bf16_zoo.py``'s inputs (the check and its bound:
``tests/torch_bf16_parity.py``)."""

import pytest

from tests import torch_bf16_parity as B


@pytest.mark.parametrize("name", B.MULTI_TASK)
def test_bf16_multi_task_matches_jax_within_its_own_gap(name):
    B.check(name)
