"""The benchmark's own tests: python -m pytest portbench/tests (CPU), and
on the card python -m pytest portbench/tests -m cuda.  They import neither
JAX nor the JAX package."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
