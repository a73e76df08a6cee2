"""Pytest settings of the benchmark's own tests (``weavebench/tests``).

Tests that need an NVIDIA card carry the ``card`` marker and take the
``card`` fixture, which decides whether a card is present when the
test runs and skips without one.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda:0")
