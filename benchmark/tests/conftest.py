"""Settings of the benchmark's own tests: the ``card`` marker for tests
that need a CUDA card, decided inside the ``card`` fixture (never while a
module is imported). Run them all with ``python3 -m pytest benchmark/tests``;
on a machine with a card the marked ones run too."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none here")
    return torch.device("cuda", 0)
