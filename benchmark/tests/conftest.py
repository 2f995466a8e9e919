"""The benchmark's own pytest settings: the `gpu` marker, and the
benchmark's folder and the checkout's root on sys.path.

    python -m pytest benchmark/tests -q            # CPU
    python -m pytest benchmark/tests -q -m gpu     # on a card
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda")
