"""Fixtures of the benchmark's tests.  Nothing here imports JAX: these
tests hold the benchmark's references and counts, not the JAX package."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided here,
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
