"""The benchmark's own tests (CPU; those marked `gpu` skip without a card).
Run from the repository root: `python -m pytest benchmark/tests -q`."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")
