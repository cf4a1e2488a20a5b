import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: slow integration tests")
    config.addinivalue_line("markers", "needs_cuda: needs a CUDA device; skips without one")
