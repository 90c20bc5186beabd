"""The port's AutoInt, AFM, FiBiNET and PNN against the JAX package's:
``predict`` for every dropout-free constructor case of their
``tests/models/<Model>_test.py``, with the helpers and the tolerance of
``tests/test_torch_zoo.py``."""

import pytest

from tests.test_torch_zoo import CASES, case_ids, check_predict
from tests.test_torch_zoo import _restore_port_config  # noqa: F401

LATER = [c for c in CASES if c[0] in ("AutoInt", "AFM", "FiBiNET", "PNN")]


@pytest.mark.parametrize("case", LATER, ids=case_ids(LATER))
def test_zoo_predict_matches_jax(case):
    check_predict(case)
