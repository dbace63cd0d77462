"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests that need the CUDA card carry the ``card`` marker and skip here;
whether a card is present is decided inside the ``card`` fixture, never
while a module is imported.  On the card: ``python -m pytest
benchmark/tests -m card -q``."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(scope="session")
def golden():
    return os.path.join(ROOT, "tests", "golden")
