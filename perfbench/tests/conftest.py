"""Test set-up: the harness's modules and the port on the path, and the
``card`` marker for tests that run only on a CUDA card.

Run here with ``python -m pytest -q perfbench/tests`` from the root of
the checkout; the card's tests with ``python -m pytest -q perfbench/tests
-m card`` on a machine with an H100.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (an H100); skipped without one")


@pytest.fixture
def card():
    """Skip the test where there is no CUDA card (decided here, while the
    test runs, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
