"""Shared fixtures.  NOTE: no XLA_FLAGS here — the main suite runs on the
single real CPU device; multi-device tests spawn subprocesses that set
--xla_force_host_platform_device_count themselves (tests/multidev.py)."""

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (the port's CUDA kernels); "
        "skips without one — run on the card with `pytest -m gpu`")
