"""The benchmark's own tests (CPU; those marked ``cuda`` need a card and skip here).

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
