"""``python -m repro_torch.launch.tiled_smoke`` on the CPU.

The port of ``repro.launch.tiled_smoke``: the blobby case at the three
prune levels bitwise against ``extract_one``, then the 128^3 analytic
sphere under 1 MiB with its staged-bytes peak held under the budget.
The module is run as a user runs it (``--device cpu``), and its checks are
shown to fail loudly: a broken row, a budget breach and a degenerate row
each exit nonzero.  Its cases are held equal to the reference script's.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import tiled_smoke as jax_smoke  # noqa: E402
from repro_torch.core import tiled  # noqa: E402
from repro_torch.launch import tiled_smoke  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These cases' tensors are small: one intra-op thread runs them about
    as fast alone, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_module_exits_zero_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.tiled_smoke", "--device",
                        "cpu"], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("bitwise=True") == 3 and "tiled_smoke OK" in r.stdout


def test_cases_equal_the_reference_scripts():
    for ours, theirs in zip(tiled_smoke.blobby_case(), jax_smoke._blobby_case()):
        np.testing.assert_array_equal(ours, theirs)
    slab = tiled_smoke.sphere_slab(60, 68)
    assert slab.shape == (128, 128, 8) and slab.dtype == np.float32
    assert slab.sum() > 0 and not slab[:, :, 0].all()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiled_smoke.main([])


def _breaking(monkeypatch, mutate):
    """Patch the tiled engine so that ``mutate(result)`` runs on every
    tiled result the smoke sees."""
    real = tiled.TiledExtractor.extract

    def extract(self, case):
        res = real(self, case)
        mutate(self, res)
        return res

    monkeypatch.setattr(tiled.TiledExtractor, "extract", extract)


def test_a_broken_row_exits_nonzero(monkeypatch, capsys):
    def flip(tx, res):
        if tx.tile_prune == "bounds":
            res.row[2] = np.nextafter(res.row[2], np.float32(np.inf))

    _breaking(monkeypatch, flip)
    assert tiled_smoke.main(["--device", "cpu"]) == 1
    assert "bounds parity broke" in capsys.readouterr().err


def test_a_budget_breach_exits_nonzero(monkeypatch, capsys):
    def over(tx, res):
        if tx.budget_bytes == tiled_smoke.SPHERE_BUDGET:
            res.stats["staged_bytes_peak"] = tiled_smoke.SPHERE_BUDGET + 1

    _breaking(monkeypatch, over)
    assert tiled_smoke.main(["--device", "cpu", "--budget-kb", "256"]) == 1
    assert "over the" in capsys.readouterr().err


def test_a_degenerate_row_exits_nonzero(monkeypatch, capsys):
    def nan(tx, res):
        if tx.budget_bytes == tiled_smoke.SPHERE_BUDGET:
            res.row[0] = np.nan

    _breaking(monkeypatch, nan)
    assert tiled_smoke.main(["--device", "cpu"]) == 1
    assert "degenerate" in capsys.readouterr().err
