"""The check fails what it must: the bfloat16 control, and a run whose
timed path alters an answer where it is produced; and passes the program."""
import json
from pathlib import Path

import numpy as np
import pytest

from radbench import cases as caselib
from radbench import harness
from radbench.control import control_numbers

ROOT = Path(__file__).resolve().parents[2]
DIMS = [[22, 18, 14], [16, 14, 10], [12, 10, 8]]
SEED = 2**31 + 99


def limits(config):
    return json.loads((ROOT / "radbench/configs" / f"{config}.json").read_text())["limits"]


@pytest.mark.parametrize("config", ["kits19-shape", "kits19-radiomics"])
def test_the_bfloat16_control_fails_every_number(config):
    cfg = json.loads((ROOT / "radbench/configs" / f"{config}.json").read_text())
    pool = caselib.build_pool(SEED, DIMS, 2, device="cpu")
    numbers = control_numbers(pool, tuple(cfg["families"]), cfg["n_bins"], "cpu")
    assert set(numbers) == set(cfg["limits"])
    for name, value in numbers.items():
        assert value > cfg["limits"][name], (name, value)


def run(cell, seed=SEED):
    spec = harness.Spec.load(cell, ROOT)
    return harness.run_cell(spec, seed, 0.2, False, "cpu", per_dim=1, dims=DIMS,
                            log=lambda m: None)


@pytest.mark.parametrize("cell", ["kits19-shape.cohort", "kits19-radiomics.serve",
                                  "kits19-radiomics.cohort", "kits19-shape.single"])
def test_the_program_passes_at_a_small_size(cell):
    out = run(cell)
    assert out["correct"] and out["failed"] == 0
    assert all(v["value"] <= v["limit"] for v in out["check"].values())


def scaled(fn, factor, column=None):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        if isinstance(out, tuple):  # the single case's (volume, area)
            return tuple(x * factor for x in out)
        if column is None:
            return out * factor
        out = np.array(out, copy=True)
        out[..., column] *= factor
        return out
    return wrapped


# (cell, module, function, column): an answer altered by 1% where the
# program produces it -- the batched and single meshes and diameters, and
# the first-order and GLCM rows derived on the host
FAULTS = [
    ("kits19-shape.cohort", "repro_torch.kernels.ops", "mc_volume_area_batch", None),
    ("kits19-shape.cohort", "repro_torch.kernels.ops", "max_diameters_batch", None),
    ("kits19-radiomics.serve", "repro_torch.kernels.ops", "max_diameters_batch", None),
    ("kits19-radiomics.cohort", "repro_torch.kernels.firstorder", "features_from_packed_np", 0),
    ("kits19-radiomics.cohort", "repro_torch.kernels.glcm", "glcm_features_from_matrix_np", 3),
    ("kits19-shape.single", "repro_torch.kernels.ops", "mc_volume_area", None),
    ("kits19-shape.single", "repro_torch.kernels.ops", "max_diameters", None),
]


@pytest.mark.parametrize("cell,module,name,column", FAULTS,
                         ids=[f"{c}-{n}" for c, _, n, _ in FAULTS])
def test_an_altered_answer_is_not_correct(monkeypatch, cell, module, name, column):
    mod = pytest.importorskip(module)
    monkeypatch.setattr(mod, name, scaled(getattr(mod, name), 1.01, column))
    out = run(cell)
    assert not out["correct"]
