"""Settings of the benchmark's own tests: ``python -m pytest portbench/tests -q`` from the root.

Tests marked ``card`` need a CUDA card; each decides so inside itself and
skips where there is none.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
