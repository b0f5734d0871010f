"""CPU tests of the benchmark harness: ``python -m pytest vdb_bench/tests``
from the root of the checkout. Tests marked ``card`` need a CUDA card and
skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips on a host without one)")


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda")
