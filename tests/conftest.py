import os
import sys

# Tests run on the single real CPU device (the 512-device override is ONLY
# for launch/dryrun.py, which sets XLA_FLAGS before any import).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")
