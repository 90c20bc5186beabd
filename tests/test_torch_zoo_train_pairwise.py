"""The port's AutoInt, AFM, FiBiNET and PNN training on host arrays against
the JAX package: the ``fit`` trajectories, ``predict`` and ``evaluate`` of
``tests/test_torch_zoo_train.py``, with its tolerances."""

import pytest

from tests.test_torch_zoo import _restore_port_config  # noqa: F401
from tests.test_torch_zoo_train import OPTS, check_fit


@pytest.mark.parametrize("opt, rtol", OPTS)
@pytest.mark.parametrize("name", ["AutoInt", "AFM", "FiBiNET", "PNN"])
def test_zoo_fit_trajectory_matches_jax(name, opt, rtol):
    check_fit(name, opt, rtol)
