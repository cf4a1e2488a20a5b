"""The benchmark's own tests: run with ``python -m pytest -q bench/tests`` from
the root of the checkout. Tests marked ``needs_cuda`` run on a card and skip
without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "needs_cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def checkout(tmp_path):
    """A checkout with the tiny cells (``tiny.py``)."""
    import tiny

    return tiny.make(tmp_path)
