"""Test settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``card`` marker for tests that need a CUDA device,
which skip where there is none."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control runs on the card")
    return torch.device("cuda", 0)
