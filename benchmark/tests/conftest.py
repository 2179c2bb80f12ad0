"""The benchmark's own tests (``python3 -m pytest benchmark/tests``, from the
repository root). Tests that need an NVIDIA GPU take the ``card`` fixture,
which skips them here; the card is looked for inside the fixture, never
while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skipped without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
