"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from the
repository's root. Tests that need the card are marked ``card`` and skip
without one, decided inside the ``card`` fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cell on the card")
    return torch.device("cuda")
