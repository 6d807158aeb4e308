import importlib.util

import numpy as np
import pytest

# Property-test modules need hypothesis (see requirements-dev.txt); skip
# them at collection time when it is absent so the rest of the suite runs.
collect_ignore = []
if importlib.util.find_spec("hypothesis") is None:
    collect_ignore = [
        "test_kernels_diameter.py",
        "test_kernels_mc.py",
        "test_mc_tables.py",
        "test_prune_properties.py",
        "test_families_properties.py",
    ]


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "tier1: fast correctness gate run by scripts/ci_smoke.sh",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's hand kernels); skips without one",
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def sphere_mask(n: int, r: float) -> np.ndarray:
    g = np.arange(n) - (n - 1) / 2
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (x * x + y * y + z * z <= r * r).astype(np.float32)


def box_mask(shape, lo, hi) -> np.ndarray:
    m = np.zeros(shape, np.float32)
    m[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1.0
    return m
