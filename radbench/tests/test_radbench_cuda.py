"""The command's refusals on the CPU, and each cell at a small size on the
card (``cuda``: skips without one)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from radbench import cases as caselib
from radbench import harness
from radbench.control import control_numbers

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
DIMS = [[40, 36, 30], [24, 20, 16]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "radbench/run.py"), "--workload", CELLS[0],
                          "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_at_a_small_size_on_the_card(card, cell):
    spec = harness.Spec.load(cell, ROOT)
    out = harness.run_cell(spec, 2**31 + 17, 0.5, True, card, per_dim=1, dims=DIMS,
                           log=lambda m: None)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["kits19-shape", "kits19-radiomics"])
def test_the_control_fails_on_the_card(card, config):
    cfg = json.loads((ROOT / "radbench/configs" / f"{config}.json").read_text())
    pool = caselib.build_pool(2**31 + 18, DIMS, 2, device=card)
    numbers = control_numbers(pool, tuple(cfg["families"]), cfg["n_bins"], card)
    assert any(v > cfg["limits"][k] for k, v in numbers.items())
