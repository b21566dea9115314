"""Settings of the benchmark's own tests: ``python -m pytest portbench/tests``
from the root of the repository.  They run on the CPU; a test that needs
the card is marked ``cuda`` and skips without one (decided in a
fixture)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
