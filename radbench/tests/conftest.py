import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's hand kernels); skips without one",
    )


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The harness's tensors here are small: one intra-op thread runs them
    about as fast, and the suite's parallel workers share the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
