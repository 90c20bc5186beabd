"""The benchmark's tests.  Run them from the repository's root:

    python -m pytest portbench/tests -q

The tests marked ``card`` need an NVIDIA GPU; each decides inside the
``card`` fixture whether one is there, and skips where it is not."""

import pytest

from portbench.tests import tiny


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (the H100 the benchmark "
        "measures); skipped where CUDA is not available")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available here")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """The benchmark's cells cut to a size the CPU runs in seconds."""
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))
