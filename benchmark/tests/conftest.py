"""The benchmark's own tests: ``python3 -m pytest benchmark/tests`` from the
root of a checkout. Tests marked ``cuda`` need the card and skip without
one (the ``card`` fixture decides, when the test runs)."""

import pytest


def pytest_configure(config):
    import torch

    # one thread a worker: the tiny runs' small operations on several
    # threads in each of several test workers crowd the cores
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped where CUDA is unavailable)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
