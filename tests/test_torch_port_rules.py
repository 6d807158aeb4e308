"""Rules of the PyTorch port: no JAX, no reference import, no CPU fallback.

Also holds the state carried across from the reference (the marching-cubes
tables and the synthetic case data) equal to the JAX package's.
"""
import gzip
import os
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mc_tables as jax_mct  # noqa: E402
from repro.data import nifti as jax_nifti  # noqa: E402
from repro.data import synthetic as jax_synth  # noqa: E402
from repro_torch.core import ShapeFeatureExtractor, mc_tables  # noqa: E402
from repro_torch.data import nifti, synthetic  # noqa: E402
from repro_torch.kernels import marching_cubes, ops  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
_FORBIDDEN_IMPORT = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)\b", re.M)


def test_import_loads_no_jax_or_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.shape_features, repro_torch.kernels.ops\n"
        "import repro_torch.core.pipeline, repro_torch.core.executor, repro_torch.core.plan\n"
        "import repro_torch.kernels.compact, repro_torch.kernels.firstorder\n"
        "import repro_torch.kernels.glcm, repro_torch.core.tiled, repro_torch.data.tiles\n"
        "import repro_torch.runtime.autotune, repro_torch.runtime.costmodel\n"
        "import repro_torch.runtime.roofline, repro_torch.serve.service\n"
        "import repro_torch.launch.serve, repro_torch.runtime.resilience\n"
        "import repro_torch.runtime.fault_tolerance, repro_torch.parallel.sharding\n"
        "import repro_torch.launch.mesh, repro_torch.launch.tiled_smoke\n"
        "import repro_torch.configs.base, repro_torch.configs.shapes\n"
        "import repro_torch.models.params, repro_torch.models.layers, repro_torch.models.moe\n"
        "import repro_torch.models.ssm, repro_torch.models.transformer\n"
        "import repro_torch.models.rwkv6, repro_torch.models.encdec\n"
        "import repro_torch.models.registry, repro_torch.models.convert\n"
        "import repro_torch.serve.serve_step\n"
        "import repro_torch.train, repro_torch.train.optimizer, repro_torch.train.train_step\n"
        "import repro_torch.train.trainer, repro_torch.runtime.checkpoint\n"
        "import repro_torch.launch.train, repro_torch.launch.dryrun\n"
        "import repro_torch.parallel.compression, repro_torch.parallel.pipeline\n"
        "import repro_torch.utils, repro_torch.utils.roofline\n"
        "from repro_torch.models.registry import ARCHS, get_config\n"
        "for name in ARCHS: get_config(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_import_no_jax_or_reference():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert {p.name for p in examples} >= {
        "quickstart_torch.py", "cluster_pipeline_torch.py", "train_lm_torch.py",
        "serve_lm_torch.py", "serve_clients_torch.py"}
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 10
    offenders = [str(p) for p in files if _FORBIDDEN_IMPORT.search(p.read_text())]
    assert not offenders


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShapeFeatureExtractor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.mc_volume_area(np.zeros((3, 3, 3), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.max_diameters(np.zeros((2, 3), np.float32), np.ones(2, bool))
    vols = np.zeros((1, 3, 3, 3), np.float32)
    for entry in (ops.firstorder_packed_batch, ops.glcm_matrix_batch):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(vols, vols)


def test_model_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.models import params, registry
    from repro_torch.models.transformer import Decoder
    cfg = registry.get_config("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.get_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Decoder(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params.init_params(registry.model_spec(cfg), torch.Generator())


def test_unknown_device_and_variant_raise():
    with pytest.raises(ValueError):
        ShapeFeatureExtractor(device="meta")
    with pytest.raises(ValueError):
        ShapeFeatureExtractor(device="cpu", diameter_variant="bogus")


@pytest.mark.parametrize("name", ["CORNERS", "EDGES", "TRI_TABLE", "N_TRIS",
                                  "EDGE_CELL_AXIS", "EDGE_CELL_OFFSET", "MAX_TRIS"])
def test_mc_tables_equal_reference(name):
    ours, theirs = getattr(mc_tables, name), getattr(jax_mct, name)
    np.testing.assert_array_equal(ours, theirs)
    assert np.asarray(ours).dtype == np.asarray(theirs).dtype


def test_cuda_table_header_is_generated_from_tables():
    assert marching_cubes.TABLE_HEADER.read_text() == marching_cubes.tri_table_source()


@pytest.mark.parametrize("shape,seed,spacing", [
    ((48, 40, 36), 11, (1.0, 1.0, 1.0)),
    ((28, 30, 59), 1, (2.0, 1.0, 0.5)),
    ((39, 33, 11), 19, (0.8, 0.8, 3.0)),
])
def test_make_case_equals_reference(shape, seed, spacing):
    ours = synthetic.make_case(shape, seed=seed, spacing=spacing)
    theirs = jax_synth.make_case(shape, seed=seed, spacing=spacing)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_table2_cases_equal_reference():
    assert synthetic.TABLE2_CASES == jax_synth.TABLE2_CASES


@pytest.mark.parametrize("suffix,dtype,slope,inter", [
    (".nii", np.uint8, 0.0, 0.0),
    (".nii.gz", np.float32, 0.0, 0.0),
    (".nii", np.int16, 2.0, -1024.0),
])
def test_read_nifti_equals_reference(tmp_path, suffix, dtype, slope, inter):
    rng = np.random.default_rng(0)
    data = (rng.random((7, 5, 4)) * 100).astype(dtype)
    path = jax_nifti.write_nifti(tmp_path / f"case{suffix}", data, (0.8, 0.8, 2.5),
                                 scl_slope=slope, scl_inter=inter)
    ours, theirs = nifti.read_nifti(path), jax_nifti.read_nifti(path)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("suffix,dtype,slope,inter", [
    (".nii", np.uint8, 0.0, 0.0),
    (".nii.gz", np.float32, 0.0, 0.0),
    (".nii", np.int16, 2.0, -1024.0),
])
def test_write_nifti_equals_reference(tmp_path, monkeypatch, suffix, dtype, slope, inter):
    """The port's writer writes the JAX writer's bytes (a gzip member
    stamps the clock, pinned here for both), and both readers read its
    file back as the reference's."""
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1_700_000_000.0))
    rng = np.random.default_rng(0)
    data = (rng.random((7, 5, 4)) * 100).astype(dtype)
    ours = nifti.write_nifti(tmp_path / f"ours{suffix}", data, (0.8, 0.8, 2.5),
                             scl_slope=slope, scl_inter=inter)
    theirs = jax_nifti.write_nifti(tmp_path / f"theirs{suffix}", data, (0.8, 0.8, 2.5),
                                   scl_slope=slope, scl_inter=inter)
    assert ours == tmp_path / f"ours{suffix}"
    assert ours.read_bytes() == theirs.read_bytes()
    want = jax_nifti.read_nifti(theirs)
    for got in (nifti.read_nifti(ours), jax_nifti.read_nifti(ours)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_write_nifti_stores_other_dtypes_as_float32(tmp_path):
    data = np.arange(24, dtype=np.int64).reshape(2, 3, 4)
    path = nifti.write_nifti(tmp_path / "wide.nii", data)
    back, spacing = nifti.read_nifti(path)
    assert back.dtype == np.float32 and np.array_equal(back, data.astype(np.float32))
    np.testing.assert_array_equal(spacing, np.ones(3, np.float32))
    assert path.read_bytes() == jax_nifti.write_nifti(tmp_path / "ref.nii", data).read_bytes()


def test_mesh_entry_points_raise_without_cuda_but_the_dry_run(tmp_path):
    """Training over a mesh defaults to the card as every entry point
    does; the dry run is the one exception: it lays cells out on ``meta``
    and touches no device, as the reference's runs on forced host
    devices."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.parallel.sharding import NamedSharding
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.fault_tolerance import elastic_remesh, surviving_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        surviving_mesh()
    m = CheckpointManager(tmp_path)
    m.save(1, {"x": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic_remesh(m, {"x": torch.zeros(2)}, lambda mesh: {"x": NamedSharding(mesh)})
    report, cell = dryrun.lower_cell("qwen3-1.7b", "train_4k", make_production_mesh())
    assert report["n_chips"] == 256 and cell["params"][0]["embed"]["embedding"].is_meta
