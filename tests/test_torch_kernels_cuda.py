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
