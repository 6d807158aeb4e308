"""The hand-written CUDA kernels against their plain versions, on the card.

Skipped without a CUDA device (a CUDA kernel has no CPU mode).  Run on an
H100 with ``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py``.
Tolerances are those of ``chip_smoke.py``: the marching-cubes kernel and
its plain version share every per-triangle operation and differ only in
the order of the final sums (rtol 1e-5); the diameter kernel repeats the
plain version's per-pair arithmetic and its maxima must be bitwise equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ShapeFeatureExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import diameter, marching_cubes, ref  # noqa: E402

from conftest import sphere_mask  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """This module's 'auto' sweeps on the card go to a cache file of its own."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path_factory.mktemp("autotune") / "cache.json"))
    yield
    mp.undo()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _volumes():
    rng = np.random.default_rng(0)
    return {
        "sphere": (np.pad(sphere_mask(26, 10.0), 1), (1.0, 1.0, 1.0)),
        "random": (np.pad(rng.random((20, 18, 16)).astype(np.float32), 1), (1.0, 1.0, 1.0)),
        "make_case_aniso": (
            np.pad(synthetic.make_case((40, 30, 20), seed=5)[1].astype(np.float32), 1),
            (2.0, 1.0, 0.5),
        ),
    }


@pytest.mark.parametrize("name", sorted(_volumes()))
@pytest.mark.parametrize("block", [128, 256])
def test_mc_kernel_matches_plain(dev, name, block):
    vol, sp = _volumes()[name]
    t = torch.from_numpy(vol).to(dev)
    before = marching_cubes.LAUNCHES
    kv, ka = marching_cubes.mc_volume_area(t, 0.5, sp, block=block)
    torch.cuda.synchronize()
    assert marching_cubes.LAUNCHES == before + 1
    pv, pa = ref.mc_volume_area(t, 0.5, sp)
    np.testing.assert_allclose(float(kv), float(pv), rtol=1e-5)
    np.testing.assert_allclose(float(ka), float(pa), rtol=1e-5)
    kv2, ka2 = marching_cubes.mc_volume_area(t, 0.5, sp, block=block)
    assert (float(kv2), float(ka2)) == (float(kv), float(ka))


@pytest.mark.parametrize("m", [1, 2, 513, 4096])
@pytest.mark.parametrize("block", [128, 256])
def test_diameter_kernel_bitwise_equals_plain(dev, m, block):
    rng = np.random.default_rng(m)
    verts = torch.from_numpy((rng.normal(size=(m, 3)) * 50 + 200).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(m) < 0.7).to(dev)
    mask[m // 2] = True
    before = diameter.LAUNCHES["seqacc"]
    k = diameter.max_diameters_sq(verts, mask, block=block)
    torch.cuda.synchronize()
    assert diameter.LAUNCHES["seqacc"] == before + 1
    assert torch.equal(k, ref.max_diameters_sq(verts, mask, block))


def test_wrappers_refuse_bad_inputs(dev):
    with pytest.raises(ValueError):
        marching_cubes.mc_volume_area(torch.zeros((4, 4, 4), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        marching_cubes.mc_volume_area(torch.zeros((4, 4, 8), device=dev)[:, :, ::2])
    with pytest.raises(ValueError):
        diameter.max_diameters_sq(torch.zeros((4, 3), device=dev),
                                  torch.ones(4, dtype=torch.bool), block=256)
    with pytest.raises(ValueError):
        diameter.max_diameters_sq(torch.zeros((4, 3), device=dev),
                                  torch.ones(4, dtype=torch.bool, device=dev), block=100)


def test_extractor_on_card_matches_cpu(dev):
    img, m, sp = synthetic.make_case((48, 40, 36), seed=11)
    before = (marching_cubes.LAUNCHES, sum(diameter.LAUNCHES.values()))
    gpu = ShapeFeatureExtractor().execute(img, m, sp)
    assert marching_cubes.LAUNCHES > before[0] and sum(diameter.LAUNCHES.values()) > before[1]
    cpu = ShapeFeatureExtractor(device="cpu").execute(img, m, sp)
    for k, v in cpu.items():
        np.testing.assert_allclose(gpu[k], v, rtol=1e-4, err_msg=k)
    assert gpu["_n_mesh_vertices"] == cpu["_n_mesh_vertices"]


def _checkerboard(shape):
    i, j, k = np.indices(shape)
    return ((i + j + k) % 2).astype(np.float32)


def _ragged_volumes():
    """Shapes at the edges of the kernel's items (8 x 8 x 8 cells): x-y
    extents off the tile, two planes, a short last granule, no surface,
    and a checkerboard whose every cell is active (the fullest work list)."""
    rng = np.random.default_rng(3)
    return {
        "xy_off_tile": rng.random((20, 13, 30)).astype(np.float32),
        "nz_2": rng.random((17, 19, 2)).astype(np.float32),
        "short_last_granule": np.pad(sphere_mask(26, 11.0), 1)[:, :, :28],
        "one_cell_column": rng.random((2, 2, 40)).astype(np.float32),
        "empty": np.zeros((16, 16, 16), np.float32),
        "full": np.ones((16, 16, 16), np.float32),
        "checkerboard": _checkerboard((18, 17, 19)),
    }


@pytest.mark.parametrize("name", sorted(_ragged_volumes()))
def test_mc_kernel_matches_plain_on_ragged_shapes(dev, name):
    vol = _ragged_volumes()[name]
    t = torch.from_numpy(vol).to(dev)
    kv, ka = marching_cubes.mc_volume_area(t, 0.5, (1.0, 0.8, 1.3))
    pv, pa = ref.mc_volume_area(t, 0.5, (1.0, 0.8, 1.3))
    if name in ("empty", "full"):
        assert (float(kv), float(ka)) == (0.0, 0.0) == (float(pv), float(pa))
    else:
        assert float(ka) > 0
        np.testing.assert_allclose(float(kv), float(pv), rtol=1e-5)
        np.testing.assert_allclose(float(ka), float(pa), rtol=1e-5)


@pytest.mark.parametrize("name", ["checkerboard", "xy_off_tile", "short_last_granule"])
def test_mc_results_do_not_depend_on_block(dev, name):
    """The partial order is fixed by the item's cells: every thread count
    gives the same partials, and the same stack rows, bitwise."""
    vol = torch.from_numpy(_ragged_volumes()[name]).to(dev)
    stack = torch.stack([vol, 1.0 - vol])
    rows = [marching_cubes.mc_volume_area_batch(stack, 0.5, block=b)
            for b in (32, 96, 128, 256, 512, 1024)]
    assert all(torch.equal(r, rows[0]) for r in rows[1:])
    nz = vol.shape[2]
    win = torch.nn.functional.pad(vol, (0, (-(nz - 1)) % 8))
    parts = [marching_cubes.mc_slab_partials(win, 0.5, full_shape=vol.shape, block=b)
             for b in (32, 128, 1024)]
    assert all(torch.equal(p[0], parts[0][0]) and torch.equal(p[1], parts[0][1])
               for p in parts[1:])
