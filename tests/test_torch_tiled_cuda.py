"""The tiled path's kernels on the card: the marching-cubes window partials
(row 2) and the touched-chunk first-order fold, and tiled == in-core end to
end.

Skipped without a CUDA device (a CUDA kernel has no CPU mode).  Run on an
H100 with ``PYTHONPATH=src python -m pytest -q tests/test_torch_tiled_cuda.py``.
The window kernel computes the whole volume's partials of its granules, so
an assembled grid finalizes to the in-core kernel's bits; against the
plain version each granule agrees within rtol 1e-5 (the order of the sums
inside a granule differs).  The first-order fold runs the first-order
kernel and equals its plain version bitwise.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.executor import PlanExecutor  # noqa: E402
from repro_torch.core.tiled import TiledExtractor  # noqa: E402
from repro_torch.data.tiles import TiledCase  # noqa: E402
from repro_torch.kernels import firstorder, marching_cubes, ref  # noqa: E402

pytestmark = pytest.mark.cuda

SP = np.asarray([1.0, 1.25, 0.75], np.float32)
FAMS = ["shape", "firstorder"]


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
    return torch.device("cuda")


def _ellipsoid(shape=(40, 44, 57), radii=(12, 15, 20), seed=0):
    X, Y, Z = shape
    xs, ys, zs = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij")
    c = (X / 2, Y / 2, Z / 2)
    r2 = (((xs - c[0]) / radii[0]) ** 2 + ((ys - c[1]) / radii[1]) ** 2
          + ((zs - c[2]) / radii[2]) ** 2)
    mask = (r2 < 1.0).astype(np.float32)
    image = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return image, mask


def _volume(seed=0, shape=(33, 29, 58)):
    """A random-valued volume padded by a zero plane; 57 cells along z."""
    return np.pad(np.random.default_rng(seed).random(shape).astype(np.float32), 1)


def _windows(vol, chunk_z, bounds):
    """Zero-pad the volume to whole granules and cut it at granule bounds."""
    ngran, _ = marching_cubes.layout(vol.shape, chunk_z)
    padded = np.pad(vol, ((0, 0), (0, 0), (0, ngran * chunk_z + 1 - vol.shape[2])))
    return ngran, [(k0, padded[:, :, k0 * chunk_z:k1 * chunk_z + 1])
                   for k0, k1 in zip(bounds[:-1], bounds[1:])]


@pytest.mark.parametrize("chunk_z", [8, 5])
def test_window_kernel_equals_plain_per_granule(dev, chunk_z):
    vol = np.pad(_ellipsoid(shape=(33, 29, 58), radii=(13, 11, 25))[1], 1)
    ngran, wins = _windows(vol, chunk_z, [0, 2, 5])
    for k0, win in wins:
        t = torch.from_numpy(win).to(dev)
        before = marching_cubes.SLAB_LAUNCHES
        kv, ka = marching_cubes.mc_slab_partials(t, 0.5, SP, full_shape=vol.shape, k0=k0,
                                                 chunk_z=chunk_z)
        torch.cuda.synchronize()
        assert marching_cubes.SLAB_LAUNCHES == before + 1
        pv, pa = ref.mc_slab_partials(t, 0.5, SP, full_shape=vol.shape, k0=k0,
                                      chunk_z=chunk_z)
        # a granule's signed volume can sit near zero: atol 1e-3 there
        np.testing.assert_allclose(kv.sum(1).cpu().numpy(), pv.cpu().numpy(), rtol=1e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(ka.sum(1).cpu().numpy(), pa.cpu().numpy(), rtol=1e-5)
        kv2, ka2 = marching_cubes.mc_slab_partials(t, 0.5, SP, full_shape=vol.shape, k0=k0,
                                                   chunk_z=chunk_z)
        assert torch.equal(kv, kv2) and torch.equal(ka, ka2)


@pytest.mark.parametrize("chunk_z", [8, 3, 1, 4, 11])
def test_in_core_equals_finalize_of_assembled_windows(dev, chunk_z):
    vol = _volume(1)
    ngran, _ = marching_cubes.layout(vol.shape, chunk_z)
    bounds = [0, 1, ngran // 2, ngran - 1, ngran]
    _, wins = _windows(vol, chunk_z, bounds)
    assert len(wins) >= 3
    parts = [marching_cubes.mc_slab_partials(torch.from_numpy(w).to(dev), 0.5, SP,
                                             full_shape=vol.shape, k0=k0, chunk_z=chunk_z)
             for k0, w in wins]
    full = [torch.cat([p[i] for p in parts]) for i in range(2)]
    before = marching_cubes.FINALIZE_LAUNCHES
    tv, ta = marching_cubes.mc_partials_finalize(*full)
    v, a = marching_cubes.mc_volume_area(torch.from_numpy(vol).to(dev), 0.5, SP,
                                         chunk_z=chunk_z)
    torch.cuda.synchronize()
    assert marching_cubes.FINALIZE_LAUNCHES == before + 1
    assert torch.equal(torch.stack([tv, ta]), torch.stack([v, a]))
    pv, pa = ref.mc_volume_area(torch.from_numpy(vol).to(dev), 0.5, SP, chunk_z=chunk_z)
    np.testing.assert_allclose([float(v), float(a)], [float(pv), float(pa)], rtol=1e-5)


def test_fold_kernel_equals_plain_bitwise(dev):
    image, mask = _ellipsoid(shape=(30, 34, 41), radii=(10, 12, 15))
    C = firstorder.CANON_CHUNK
    x = np.where(mask > 0, image, 0).reshape(-1)
    m = (mask > 0).astype(np.float32).reshape(-1)
    pad = -len(x) % C
    x, m = np.pad(x, (0, pad)).reshape(-1, C), np.pad(m, (0, pad)).reshape(-1, C)
    touched = m.any(1)
    xt = torch.from_numpy(np.ascontiguousarray(x[touched])).to(dev)
    mt = torch.from_numpy(np.ascontiguousarray(m[touched])).to(dev)
    rng = torch.tensor([image[mask > 0].min(), image[mask > 0].max()], dtype=torch.float32,
                       device=dev)
    before = firstorder.FOLD_LAUNCHES
    got = firstorder.fold_packed_chunks(xt, mt, rng[0], rng[1])
    torch.cuda.synchronize()
    assert firstorder.FOLD_LAUNCHES == before + 1
    assert torch.equal(got, firstorder.fold_packed_chunks(xt.cpu(), mt.cpu(), rng[0].cpu(),
                                                          rng[1].cpu()).to(dev))
    whole = firstorder.firstorder_packed_batch(torch.from_numpy(image[None]).to(dev),
                                               torch.from_numpy(mask[None]).to(dev))[0]
    assert torch.equal(got, whole)


@pytest.mark.parametrize("budget", [1 << 30, 200_000, 60_000])
@pytest.mark.parametrize("prune", ["none", "occupancy"])
def test_tiled_equals_extract_one_on_card(dev, budget, prune):
    image, mask = _ellipsoid()
    ex = PlanExecutor(families=FAMS)
    oracle = ex.extract_one(image, mask, SP)
    tx = TiledExtractor(ex, budget_bytes=budget, tile_prune=prune)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = tx.extract(TiledCase(mask, image=image, spacing=SP))
    np.testing.assert_array_equal(oracle, res.row)
    cpu = PlanExecutor(device="cpu", families=FAMS).extract_one(image, mask, SP)
    np.testing.assert_allclose(res.row, cpu, rtol=1e-4)
    assert res.row[6] == cpu[6]


def test_tiled_extract_syncs_only_in_fetch(dev):
    image, mask = _ellipsoid()
    ex = PlanExecutor(families=FAMS)
    tx = TiledExtractor(ex, budget_bytes=200_000, tile_prune="bounds")
    case = TiledCase(mask, image=image, spacing=SP)
    first = tx.extract(case)  # first use: library loads, allocator warm-up
    with ex.strict_syncs():
        res = tx.extract(case)
    np.testing.assert_array_equal(first.row, res.row)
    assert set(res.stats["host_fetches"]) <= {"tiled_census", "tiled_prune", "tiled_shape",
                                               "tiled_firstorder"}


def test_cuda_tensors_never_reach_a_plain_version(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("mc_slab_partials", "mc_partials_fold", "mc_volume_area_batch"):
        monkeypatch.setattr(ref, name, refuse)
    monkeypatch.setattr(firstorder, "firstorder_packed_batch_ref", refuse)
    image, mask = _ellipsoid(shape=(30, 32, 48), radii=(9, 10, 16))
    counts = [marching_cubes.SLAB_LAUNCHES, marching_cubes.FINALIZE_LAUNCHES,
              firstorder.FOLD_LAUNCHES]
    tx = TiledExtractor(PlanExecutor(families=FAMS), budget_bytes=200_000,
                        tile_prune="occupancy")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = tx.extract(TiledCase(mask, image=image, spacing=SP))
    torch.cuda.synchronize()
    moved = [marching_cubes.SLAB_LAUNCHES - counts[0],
             marching_cubes.FINALIZE_LAUNCHES - counts[1], firstorder.FOLD_LAUNCHES - counts[2]]
    assert moved[0] == res.stats["tiles"] - res.stats["tiles_skipped"] and moved[1:] == [1, 1]


@pytest.mark.parametrize("chunk_z", [33, 40])
def test_deep_granules_tile_bitwise(dev, chunk_z):
    """Granules deeper than an item's 32 planes: partials per sub-slab,
    windows == in-core bitwise, == plain at rtol 1e-5."""
    vol = _volume(2, shape=(21, 19, 128))
    ngran, _ = marching_cubes.layout(vol.shape, chunk_z)
    _, wins = _windows(vol, chunk_z, [0, 1, ngran])
    parts = [marching_cubes.mc_slab_partials(torch.from_numpy(w).to(dev), 0.5, SP,
                                             full_shape=vol.shape, k0=k0, chunk_z=chunk_z)
             for k0, w in wins]
    full = [torch.cat([p[i] for p in parts]) for i in range(2)]
    tv, ta = marching_cubes.mc_partials_finalize(*full)
    t = torch.from_numpy(vol).to(dev)
    v, a = marching_cubes.mc_volume_area(t, 0.5, SP, chunk_z=chunk_z)
    assert torch.equal(torch.stack([tv, ta]), torch.stack([v, a]))
    pv, pa = ref.mc_volume_area(t, 0.5, SP, chunk_z=chunk_z)
    np.testing.assert_allclose([float(v), float(a)], [float(pv), float(pa)], rtol=1e-5)
