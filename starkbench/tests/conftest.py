"""The benchmark's own tests.  Tests marked ``card`` need a CUDA card: they
take the ``card`` fixture, which skips them where there is none (decided
when the test runs, never when a module is imported)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one); run on the card with "
        "python3 -m pytest starkbench/tests -m card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
