"""Shared pieces of the benchmark's own tests (CPU, and card-marked).

Run them from the root of the repository:
    python3 -m pytest rlbench/tests -q           # without a card the card tests skip
    python3 -m pytest rlbench/tests -q -m card   # on a machine with a card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
