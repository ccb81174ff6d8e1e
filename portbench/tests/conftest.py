"""The benchmark's CPU tests: the repository's root on the path, and the
card found (or not) inside a fixture, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(Path(__file__).resolve().parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")
