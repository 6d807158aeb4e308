"""The port's out-of-core tiled extraction on the CPU, against the JAX package
and against its own in-core path.

Against the reference, on the same numpy inputs:

* the plain marching-cubes window partials (``ref.mc_slab_partials``)
  against the Pallas window kernel in interpret mode
  (``mc_brick_partials_pallas``, one granule = one brick row at
  ``chunk_z`` = the brick depth 8) and against ``repro.kernels.ref.
  mc_slab_partials``, at the reference's MC tolerance (rtol 1e-4, atol
  1e-3, ``tests/test_kernels_mc.py:25``);
* ``fold_packed_chunks``: count, histogram and range exactly, the two sums
  at rtol 1e-5 (XLA sums a chunk in an order of its own);
* tiled rows against the JAX tiled rows (``backend='ref'``): ``n_vertices``
  and the first-order min, max, percentiles and entropy exactly, the rest
  at rtol 1e-4, the tile counts equal at the same granule;
* the slab sources and ``read_nifti_slab``: array-equal slabs, the same
  refusals.

Within the port, case for case as ``tests/test_tiled_pipeline.py`` pins it
for the reference: a tiled row equals the in-core ``extract_one`` row
bitwise for every budget and every ``tile_prune`` level, ``'bounds'``
too: the diameter sweep's input is not shifted by anything a candidate
set could move (``ref.diameter_input_batch``), so a bounds-pruned tile
that held a bounding-box extreme of the candidates changes no bit.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.executor import PlanExecutor as JaxPlanExecutor  # noqa: E402
from repro.core.pipeline import BatchedExtractor as JaxBatchedExtractor  # noqa: E402
from repro.core.tiled import TiledExtractor as JaxTiledExtractor  # noqa: E402
from repro.data import nifti as jax_nifti  # noqa: E402
from repro.data import tiles as jax_tiles  # noqa: E402
from repro.kernels import firstorder as jax_fo  # noqa: E402
from repro.kernels import marching_cubes as jax_mc  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core import crop_to_roi  # noqa: E402
from repro_torch.core.executor import PlanExecutor  # noqa: E402
from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.core.tiled import TiledExtractor, tile_budget_bytes  # noqa: E402
from repro_torch.data import nifti, tiles  # noqa: E402
from repro_torch.data.tiles import (  # noqa: E402
    ArraySlabSource,
    FnSlabSource,
    NiftiSlabSource,
    TiledCase,
)
from repro_torch.kernels import firstorder, marching_cubes, ops, ref  # noqa: E402

SP = np.asarray([1.0, 1.25, 0.75], np.float32)
FAMS = ["shape", "firstorder"]
FO_EXACT = [9, 10, 11, 12, 13, 15]  # first-order min, max, P10, median, P90, entropy


@pytest.fixture(autouse=True)
def _isolated_autotune(tmp_path, monkeypatch):
    # the reference's parity must not depend on (or pollute) an autotune cache
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These cases' tensors are small: one intra-op thread runs them about
    as fast alone, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ellipsoid(shape=(40, 44, 57), radii=(12, 15, 20), seed=0):
    X, Y, Z = shape
    xs, ys, zs = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij")
    c = (X / 2, Y / 2, Z / 2)
    r2 = (((xs - c[0]) / radii[0]) ** 2 + ((ys - c[1]) / radii[1]) ** 2
          + ((zs - c[2]) / radii[2]) ** 2)
    mask = (r2 < 1.0).astype(np.float32)
    image = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return image, mask


def _two_blob(shape=(36, 40, 180)):
    """Sparse mask: blobs at the z extremes, a long empty middle."""
    X, Y, Z = shape
    mask = np.zeros(shape, np.float32)
    xs, ys, zs = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij")
    for cx, cy, cz, rx, ry, rz in ((18, 20, 15, 8, 9, 10), (16, 18, 165, 7, 8, 9)):
        r2 = (((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 + ((zs - cz) / rz) ** 2)
        mask[r2 < 1.0] = 1.0
    image = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    return image, mask


def _cpu_executor(**kw):
    return PlanExecutor(device="cpu", **kw)


def _tiled_row(ex, image, mask, budget, prune="occupancy", spacing=SP):
    tx = TiledExtractor(ex, budget_bytes=budget, tile_prune=prune)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return tx.extract(TiledCase(mask, image=image, spacing=spacing))


def _window(seed=0, shape=(17, 17, 41)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


# -- against the reference ------------------------------------------------


def test_slab_partials_match_pallas_interpret():
    win = _window()
    full = (17, 17, 120)
    k0 = 3  # granules 3..7 of the whole volume
    vp, ap = ref.mc_slab_partials(torch.from_numpy(win), 0.5, SP, full_shape=full, k0=k0,
                                  chunk_z=8)
    jv, ja = jax_mc.mc_brick_partials_pallas(win, 0.5, SP, full_shape=full,
                                             z_cell_offset=np.float32(k0 * 8),
                                             block=(8, 8, 8), chunk=512, interpret=True)
    jv, ja = np.asarray(jv), np.asarray(ja)
    assert jv.shape == (2, 2, 5) and vp.shape == (5,)
    np.testing.assert_allclose(vp.numpy(), jv.sum((0, 1)), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ap.numpy(), ja.sum((0, 1)), rtol=1e-4, atol=1e-3)
    fv, fa = jax_mc.mc_partials_finalize(jnp.asarray(jv), jnp.asarray(ja))
    ov, oa = ref.mc_partials_fold(vp, ap)
    np.testing.assert_allclose([float(ov), float(oa)], [float(fv), float(fa)], rtol=1e-4)


@pytest.mark.parametrize("chunk_z", [8, 4])
def test_slab_partials_match_jax_ref(chunk_z):
    win = _window(1)
    full = (17, 17, 96)
    k0 = 2
    sp = (0.8, 1.1, 2.0)
    vp, ap = ref.mc_slab_partials(torch.from_numpy(win), 0.5, sp, full_shape=full, k0=k0,
                                  chunk_z=chunk_z)
    org = ref.centred_origin(full, sp)
    jv, ja = jax_ref.mc_slab_partials(win, 0.5, sp, origin=org, chunk_z=chunk_z, k0=k0)
    assert vp.shape == (40 // chunk_z,) == np.shape(jv)
    ov, oa = ref.mc_partials_fold(vp, ap)
    np.testing.assert_allclose([float(ov), float(oa)],
                               [abs(float(np.sum(jv))), float(np.sum(ja))], rtol=1e-4)


def _touched_chunks(image, mask):
    """The frame's flattened masked values and lanes, and its touched chunks."""
    C = firstorder.CANON_CHUNK
    x = np.where(mask > 0, image, 0).astype(np.float32).reshape(-1)
    m = (mask > 0).astype(np.float32).reshape(-1)
    pad = -len(x) % C
    x, m = np.pad(x, (0, pad)).reshape(-1, C), np.pad(m, (0, pad)).reshape(-1, C)
    touched = m.any(1)
    return x[touched], m[touched]


def test_fold_packed_chunks_matches_reference_and_in_core():
    image, mask = _ellipsoid(shape=(24, 26, 30), radii=(8, 9, 11))
    lo, hi = (float(image[mask > 0].min()), float(image[mask > 0].max()))
    xt, mt = _touched_chunks(image, mask)
    ours = firstorder.fold_packed_chunks(torch.from_numpy(xt), torch.from_numpy(mt),
                                         lo, hi, n_bins=32).numpy()
    theirs = np.asarray(jax_fo.fold_packed_chunks(jnp.asarray(xt), jnp.asarray(mt),
                                                  jnp.float32(lo), jnp.float32(hi),
                                                  n_bins=32))
    exact = [0] + list(range(3, 3 + 32 + 3))  # count, histogram, lo, hi, bin width
    np.testing.assert_array_equal(ours[exact], theirs[exact])
    np.testing.assert_allclose(ours[1:3], theirs[1:3], rtol=1e-5)
    whole = firstorder.firstorder_packed_batch_ref(torch.from_numpy(image[None]),
                                                   torch.from_numpy(mask[None]), 32)[0]
    assert np.array_equal(ours, whole.numpy())


@pytest.mark.parametrize("kind,budget", [("ellipsoid", 200_000), ("two_blob", 400_000)])
def test_tiled_rows_match_jax_tiled(kind, budget):
    image, mask = _ellipsoid() if kind == "ellipsoid" else _two_blob()
    jex = JaxPlanExecutor(backend="ref", mc_chunk=8, families=FAMS)
    jtx = JaxTiledExtractor(jex, budget_bytes=budget, tile_prune="occupancy")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        theirs = jtx.extract(jax_tiles.TiledCase(mask, image=image, spacing=SP))
    ours = _tiled_row(_cpu_executor(mc_chunk=8, families=FAMS), image, mask, budget)
    assert ours.row[6] == theirs.row[6]  # n_vertices
    np.testing.assert_array_equal(ours.row[FO_EXACT], theirs.row[FO_EXACT])
    np.testing.assert_allclose(ours.row, theirs.row, rtol=1e-4)
    for k in ("tiles", "tiles_skipped", "granule_cz", "n_vertices", "emitted_vertices"):
        assert ours.stats[k] == theirs.stats[k], k


def _plates_and_dot():
    mask = np.zeros((36, 36, 170), np.float32)
    mask[4:32, 4:32, 4:8] = 1.0
    mask[4:32, 4:32, 162:166] = 1.0
    mask[16:19, 16:19, 80:83] = 1.0
    return None, mask


@pytest.mark.parametrize("kind", ["ellipsoid", "two_blob", "plates", "uint8", "float64"])
@pytest.mark.parametrize("budget", [1 << 30, 200_000])
def test_census_equals_reference(kind, budget):
    # the port's census runs in torch on the executor's device, in pieces
    # its staged bytes fit; the reference's in numpy on the host, in chunks
    # of a float32 mask: every field, witnesses (and their tie-breaks)
    # included
    image, mask = {"ellipsoid": _ellipsoid, "two_blob": _two_blob,
                   "plates": _plates_and_dot, "uint8": _ellipsoid,
                   "float64": _ellipsoid}[kind]()
    if kind == "uint8":
        mask = (mask * 2).astype(np.uint8)
    if kind == "float64":
        mask = mask.astype(np.float64)
    fams = FAMS if image is not None else ["shape"]
    ours = TiledExtractor(_cpu_executor(families=fams), budget, "bounds")._census(
        TiledCase(mask, image=image, spacing=SP))
    theirs = JaxTiledExtractor(JaxPlanExecutor(backend="ref", families=fams), budget,
                               "bounds")._census(jax_tiles.TiledCase(mask, image=image,
                                                                     spacing=SP))
    for field in ("empty", "lo", "hi", "plane_any", "plane_box", "int_lo", "int_hi",
                  "witnesses"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field), field)


@pytest.mark.parametrize("source", ["array", "fn", "nifti"])
def test_slab_sources_equal_reference(tmp_path, source):
    rng = np.random.default_rng(5)
    vol = (rng.random((9, 7, 13)) * 100).astype(np.float32)
    if source == "array":
        ours, theirs = ArraySlabSource(vol, SP), jax_tiles.ArraySlabSource(vol, SP)
    elif source == "fn":
        ours = FnSlabSource(lambda z0, z1: vol[:, :, z0:z1], vol.shape)
        theirs = jax_tiles.FnSlabSource(lambda z0, z1: vol[:, :, z0:z1], vol.shape)
    else:
        path = nifti.write_nifti(tmp_path / "v.nii", vol.astype(np.int16), SP,
                                     scl_slope=2.0, scl_inter=-5.0)
        ours, theirs = NiftiSlabSource(path), jax_tiles.NiftiSlabSource(path)
        np.testing.assert_array_equal(ours.spacing, theirs.spacing)
    assert ours.shape == theirs.shape
    for z0, z1 in ((0, 13), (3, 7), (12, 13), (5, 5)):
        a, b = ours.read(z0, z1), theirs.read(z0, z1)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    oc = TiledCase(ours, spacing=None if source == "nifti" else SP)
    tc = jax_tiles.TiledCase(theirs, spacing=None if source == "nifti" else SP)
    np.testing.assert_array_equal(oc.spacing, tc.spacing)
    np.testing.assert_array_equal(oc.materialize()[1], tc.materialize()[1])


def test_read_nifti_slab_equals_reference(tmp_path):
    data = (np.random.default_rng(2).random((6, 5, 9)) * 50).astype(np.uint8)
    path = nifti.write_nifti(tmp_path / "c.nii", data, (0.7, 0.7, 2.0))
    for z0, z1 in ((0, 9), (2, 4), (8, 9)):
        for a, b in zip(nifti.read_nifti_slab(path, z0, z1),
                        jax_nifti.read_nifti_slab(path, z0, z1)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert (nifti.read_nifti_header(path).data_bytes
            == jax_nifti.read_nifti_header(path).data_bytes == data.size)
    gz = nifti.write_nifti(tmp_path / "c.nii.gz", data, (0.7, 0.7, 2.0))
    for reader in (nifti.read_nifti_slab, jax_nifti.read_nifti_slab):
        with pytest.raises(ValueError, match="gunzip"):
            reader(gz, 0, 1)
    for source in (NiftiSlabSource, jax_tiles.NiftiSlabSource):
        with pytest.raises(ValueError, match="gunzip"):
            source(gz)


def test_mixed_run_in_core_fetches_equal_reference():
    image, mask = _ellipsoid(shape=(26, 28, 44), radii=(8, 9, 15))
    big_img, big_mask = _two_blob()
    cases = [(image, mask, SP), (big_img, big_mask, SP), (image, mask, SP)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _, ours = BatchedExtractor(device="cpu", families=FAMS, tiled=True,
                                   tile_mem_mb=0.4, mc_chunk=8).run(cases)
        _, theirs = JaxBatchedExtractor(backend="ref", families=FAMS, tiled=True,
                                        tile_mem_mb=0.4, mc_chunk=8).run(cases)
    assert ours["host_fetches"] == theirs["host_fetches"]
    for k in ("cases", "tiles", "tiles_skipped", "tiles_bounds_pruned"):
        assert ours["tiled"][k] == theirs["tiled"][k], k


# -- tiled == in-core, within the port --------------------------------------


@pytest.mark.parametrize("budget", [1 << 30, 200_000, 60_000])
@pytest.mark.parametrize("prune", ["none", "occupancy"])
def test_bitwise_across_tile_sizes(budget, prune):
    image, mask = _ellipsoid()
    ex = _cpu_executor(families=FAMS)
    oracle = ex.extract_one(image, mask, SP)
    res = _tiled_row(ex, image, mask, budget, prune)
    np.testing.assert_array_equal(oracle, res.row)


def test_bounds_allclose_and_exact_nonshape_columns():
    # 'bounds' drops the vertex work of endpoint-free tiles; the sweep's
    # input does not depend on which candidates survive, so every column,
    # the diameters included, is the in-core row's
    image, mask = _two_blob()
    ex = _cpu_executor(families=FAMS)
    oracle = ex.extract_one(image, mask, SP)
    res = _tiled_row(ex, image, mask, 400_000, "bounds")
    np.testing.assert_array_equal(oracle, res.row)


def test_bounds_prunes_interior_tile_keeps_count_exact():
    # two wide plates at the z extremes (the farthest-pair endpoints for
    # every combo) and a small centred dot between them: the dot's tile is
    # occupied but provably endpoint-free
    _, mask = _plates_and_dot()
    ex = _cpu_executor()
    oracle = ex.extract_one(None, mask, SP)
    res = _tiled_row(ex, None, mask, 300_000, "bounds")
    assert res.stats["tiles_bounds_pruned"] >= 1
    assert res.stats["emitted_vertices"] < res.meta.n_vertices
    assert res.row[6] == oracle[6]
    np.testing.assert_array_equal(oracle, res.row)


def _plates_and_side_dot():
    """Two wide plates at the z ends, every combo's farthest-pair endpoints,
    and a dot alone in a middle z-tile, past the plates in x: its tile is
    provably endpoint-free, yet it holds the candidates' largest x."""
    mask = np.zeros((84, 72, 170), np.float32)
    mask[2:70, 2:70, 2:6] = 1.0
    mask[2:70, 2:70, 160:164] = 1.0
    mask[74:78, 34:37, 80:83] = 1.0
    return mask


def test_bounds_pruned_tile_holding_a_box_extreme_is_bitwise():
    # at this spacing a sweep centred on the candidates' bounding box (the
    # reference's plain version) rounds the 3D diameter of the pruned set
    # (x max from the plates) apart from the in-core set's (x max from the
    # dot); the port's sweep input takes no such shift
    sp = np.asarray([0.858, 1.072, 0.822], np.float32)
    mask = _plates_and_side_dot()
    ex = _cpu_executor()
    oracle = ex.extract_one(None, mask, sp)
    res = _tiled_row(ex, None, mask, 400_000, "bounds", spacing=sp)
    assert res.stats["tiles_bounds_pruned"] >= 1
    assert res.stats["emitted_vertices"] < res.meta.n_vertices
    _, roi, _ = crop_to_roi(mask, mask)
    f = ref.vertex_fields(torch.from_numpy(roi), 0.5, sp)
    pos = torch.cat([f.vx[f.ax], f.vy[f.ay], f.vz[f.az]])
    in_plates = (pos[:, 2] < 40 * sp[2]) | (pos[:, 2] > 120 * sp[2])
    assert float(pos[:, 0].max()) > float(pos[in_plates, 0].max())  # the dot's x
    np.testing.assert_array_equal(oracle, res.row)


def test_halo_straddling_mask_bitwise():
    # a rod spanning z: every internal tile boundary cuts the surface
    mask = np.zeros((24, 24, 130), np.float32)
    mask[8:14, 9:15, 10:120] = 1.0
    image = np.random.default_rng(3).normal(size=mask.shape).astype(np.float32)
    ex = _cpu_executor(families=FAMS)
    oracle = ex.extract_one(image, mask, SP)
    for budget in (300_000, 150_000):
        res = _tiled_row(ex, image, mask, budget, "occupancy")
        assert res.stats["tiles"] > 1
        np.testing.assert_array_equal(oracle, res.row)


def test_occupancy_skips_without_dropping_vertices():
    image, mask = _two_blob()
    ex = _cpu_executor()
    oracle = ex.extract_one(None, mask, SP)
    res = _tiled_row(ex, image, mask, 400_000, "occupancy")
    assert res.stats["tiles_skipped"] > 0
    assert res.stats["emitted_vertices"] == res.meta.n_vertices
    assert res.row[6] == oracle[6]
    np.testing.assert_array_equal(oracle, res.row)


@pytest.mark.parametrize("prune", ["none", "occupancy", "bounds"])
def test_degenerate_one_voxel_and_empty(prune):
    ex = _cpu_executor(families=FAMS)
    one = np.zeros((20, 20, 40), np.float32)
    one[10, 11, 21] = 1.0
    img = np.random.default_rng(4).normal(size=one.shape).astype(np.float32)
    res = _tiled_row(ex, img, one, 1 << 30, prune)
    np.testing.assert_array_equal(ex.extract_one(img, one, SP), res.row)
    empty = np.zeros((16, 16, 40), np.float32)
    res_e = _tiled_row(ex, img[:16, :16, :], empty, 1 << 30, prune)
    np.testing.assert_array_equal(ex.extract_one(img[:16, :16, :], empty, SP), res_e.row)
    assert res_e.meta.empty


def test_mc_chunk_lever_bitwise():
    image, mask = _ellipsoid(shape=(30, 30, 66), radii=(10, 10, 25))
    ex = _cpu_executor(mc_chunk=4, families=FAMS)
    oracle = ex.extract_one(image, mask, SP)
    res = _tiled_row(ex, image, mask, 120_000, "occupancy")
    assert res.stats["granule_cz"] == 4
    assert res.stats["tiles"] > 2
    np.testing.assert_array_equal(oracle, res.row)


def test_tiled_fetches_are_counted_stages():
    image, mask = _ellipsoid()
    res = _tiled_row(_cpu_executor(families=FAMS), image, mask, 200_000)
    assert set(res.stats["host_fetches"]) == {"tiled_census", "tiled_prune", "tiled_shape",
                                               "tiled_firstorder"}
    assert res.stats["host_fetches"]["tiled_census"] == 1
    assert res.stats["host_fetches"]["tiled_shape"] == 1


# -- engine guards -----------------------------------------------------------


def test_glcm_missing_image_and_bogus_prune_rejected():
    with pytest.raises(ValueError, match="glcm"):
        TiledExtractor(_cpu_executor(families=["shape", "glcm"]))
    tx = TiledExtractor(_cpu_executor(families=["firstorder"]), budget_bytes=1 << 30)
    mask = np.zeros((8, 8, 8), np.float32)
    mask[3:5, 3:5, 3:5] = 1.0
    with pytest.raises(ValueError, match="image source"):
        tx.extract(TiledCase(mask, spacing=SP))
    with pytest.raises(ValueError, match="tile_prune"):
        TiledExtractor(_cpu_executor(), tile_prune="bogus")


def test_budget_accounting_and_env_default(monkeypatch):
    _, mask = _ellipsoid()
    ex = _cpu_executor()
    res = _tiled_row(ex, None, mask, 200_000, "occupancy")
    assert res.stats["staged_bytes_peak"] == max(
        res.stats["census_bytes_peak"], 2 * res.stats["tile_bytes"]) <= 200_000
    monkeypatch.setenv("REPRO_TILE_MEM_MB", "64")
    assert tile_budget_bytes() == 64 * 2**20
    assert TiledExtractor(ex).budget_bytes == 64 * 2**20
    monkeypatch.delenv("REPRO_TILE_MEM_MB")
    assert tile_budget_bytes() == 256 * 2**20


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.uint8])
def test_census_stages_within_budget(dtype):
    # the census stages the mask at its own dtype beside the float32 image:
    # a wide mask with first-order is staged in smaller pieces, and the
    # peak it reports is the bytes it staged
    image, mask = _ellipsoid()
    budget = 200_000
    ex = _cpu_executor(families=FAMS)
    res = _tiled_row(ex, image, mask.astype(dtype), budget, "occupancy")
    plane = mask.shape[0] * mask.shape[1] * (np.dtype(dtype).itemsize + 4)
    assert res.stats["census_bytes_peak"] == plane * (budget // plane)
    assert res.stats["staged_bytes_peak"] <= budget
    np.testing.assert_array_equal(res.row, _tiled_row(ex, image, mask, budget,
                                                      "occupancy").row)


def test_over_budget_minimum_tile_warns():
    mask = np.zeros((40, 44, 57), np.float32)
    mask[4:36, 4:40, 4:53] = 1.0
    tx = TiledExtractor(_cpu_executor(), budget_bytes=10_000, tile_prune="occupancy")
    with pytest.warns(RuntimeWarning, match="cannot hold two minimal"):
        tx.extract(TiledCase(mask, spacing=SP))


def test_array_fn_and_nifti_sources_agree(tmp_path):
    image, mask = _ellipsoid(shape=(26, 28, 44), radii=(8, 9, 15))
    ex = _cpu_executor(families=FAMS)
    oracle = ex.extract_one(image, mask, SP)
    tx = TiledExtractor(ex, budget_bytes=150_000, tile_prune="occupancy")
    fn_case = TiledCase(
        FnSlabSource(lambda z0, z1: mask[:, :, z0:z1], mask.shape),
        image=FnSlabSource(lambda z0, z1: image[:, :, z0:z1], image.shape),
        spacing=SP,
    )
    mp, ip = tmp_path / "mask.nii", tmp_path / "img.nii"
    nifti.write_nifti(mp, mask, SP)
    nifti.write_nifti(ip, image, SP)
    nifti_case = TiledCase(NiftiSlabSource(mp), image=NiftiSlabSource(ip))
    np.testing.assert_allclose(nifti_case.spacing, SP, rtol=1e-6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for case in (TiledCase(mask, image=image, spacing=SP), fn_case, nifti_case):
            np.testing.assert_array_equal(oracle, tx.extract(case).row)
    img2, msk2, _ = nifti_case.materialize()
    np.testing.assert_array_equal(msk2, mask)
    np.testing.assert_array_equal(img2, image)


def test_fn_source_shape_validated_and_gz_refused(tmp_path):
    src = FnSlabSource(lambda z0, z1: np.zeros((4, 4, z1 - z0 + 1)), (4, 4, 8))
    with pytest.raises(ValueError, match="slab fn returned shape"):
        src.read(0, 2)
    with pytest.raises(ValueError, match="3D"):
        ArraySlabSource(np.zeros((4, 4)))
    mask = np.zeros((6, 6, 6), np.float32)
    mask[2:4, 2:4, 2:4] = 1.0
    p = nifti.write_nifti(tmp_path / "m.nii.gz", mask, SP)
    with pytest.raises(ValueError, match="gunzip"):
        tiles.as_slab_source(p)


# -- the routing facade ------------------------------------------------------


def test_run_merges_tiled_rows_in_order():
    image, mask = _ellipsoid(shape=(26, 28, 44), radii=(8, 9, 15))
    big_img, big_mask = _two_blob()
    bx = BatchedExtractor(device="cpu", families=FAMS, tiled=True, tile_mem_mb=0.4)
    cases = [(image, mask, SP), (big_img, big_mask, SP), (image, mask, SP),
             TiledCase(big_mask, image=big_img, spacing=SP)]
    oracle = [bx.extract_one(*c) for c in cases[:3]] + [bx.extract_one(big_img, big_mask, SP)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rows, stats = bx.run(cases)
        one = bx.extract_tiled(cases[1])
    assert stats["tiled"]["cases"] == 2
    assert stats["tiled"]["census"].cases == 2
    assert stats["tiled"]["tiles_skipped"] > 0
    assert stats["cases"] == 2  # the in-core window
    for a, b in zip(oracle, rows):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(one.row, oracle[1])


def test_default_extractor_keeps_tuples_in_core():
    image, mask = _ellipsoid(shape=(26, 28, 44), radii=(8, 9, 15))
    bx = BatchedExtractor(device="cpu")
    assert not bx._route_tiled((image, mask, SP))
    assert bx._route_tiled(TiledCase(mask, spacing=SP))
    assert BatchedExtractor(device="cpu", tiled=True, tile_mem_mb=0.01)._route_tiled(
        (image, mask, SP))
    # the cost model's windows keep an in-core tuple in core too
    (row,) = bx.extract_stream(iter([(image, mask, SP)]), window="auto")
    np.testing.assert_array_equal(row, bx.run([(image, mask, SP)])[0][0])


def test_only_tiled_cases_run():
    _, mask = _ellipsoid(shape=(26, 28, 44), radii=(8, 9, 15))
    bx = BatchedExtractor(device="cpu")
    rows, stats = bx.run([TiledCase(mask, spacing=SP)])
    np.testing.assert_array_equal(rows[0], bx.extract_one(None, mask, SP))
    assert stats["cases"] == 0 and stats["tiled"]["cases"] == 1


# -- the out-of-core acceptance case, at a CPU size --------------------------


def test_out_of_core_sphere_under_budget():
    # 160^3 analytic sphere: 16 MiB materialised (mask alone), under a 1 MiB
    # staged budget with mc_chunk=4; the reference's analytic tolerances
    N = 160

    def sphere(z0, z1):
        ax = ((np.arange(N) - N / 2) / (N * 0.42)) ** 2
        az = ((np.arange(z0, z1) - N / 2) / (N * 0.42)) ** 2
        return (ax[:, None, None] + ax[None, :, None]
                + az[None, None, :] < 1.0).astype(np.float32)

    tx = TiledExtractor(_cpu_executor(mc_chunk=4), budget_bytes=1 << 20, tile_prune="bounds")
    res = tx.extract(TiledCase(FnSlabSource(sphere, (N, N, N))))
    assert res.stats["staged_bytes_peak"] <= 1 << 20
    assert 4 * N ** 3 / res.stats["staged_bytes_peak"] >= 16
    r = N * 0.42
    assert res.row[0] == pytest.approx(4 / 3 * np.pi * r**3, rel=0.01)
    assert res.row[1] == pytest.approx(4 * np.pi * r**2, rel=0.12)
    assert res.row[2] == pytest.approx(2 * r, rel=0.02)


# -- the in-core MC after the re-layout --------------------------------------


def test_mc_batched_equals_batch_of_one_bitwise():
    rng = np.random.default_rng(7)
    vols = np.stack([np.pad((rng.random((22, 18, 29)) < 0.5).astype(np.float32), 1)
                     for _ in range(3)])
    sps = np.asarray([[1.0, 1.0, 1.0], [2.0, 1.0, 0.5], [0.8, 0.8, 3.0]], np.float32)
    got = ops.mc_volume_area_batch(vols, 0.5, sps, device="cpu")
    for b in range(3):
        v, a = ops.mc_volume_area(vols[b], 0.5, sps[b], device="cpu")
        assert torch.equal(got[b], torch.stack([v, a]))


@pytest.mark.parametrize("chunk_z", [8, 3])
def test_mc_partials_do_not_depend_on_granules_per_launch(chunk_z):
    vol = np.pad(_ellipsoid(shape=(20, 18, 37), radii=(7, 6, 15))[1], 1)
    whole = ref.mc_slab_partials(torch.from_numpy(vol), 0.5, SP, full_shape=vol.shape,
                                 chunk_z=chunk_z)
    ngran, _ = marching_cubes.layout(vol.shape, chunk_z)
    assert whole[0].shape == (ngran,)
    padded = np.pad(vol, ((0, 0), (0, 0), (0, ngran * chunk_z + 1 - vol.shape[2])))
    for width in (1, 2, 3):
        parts = [ref.mc_slab_partials(torch.from_numpy(padded[:, :, k * chunk_z:
                                                              (k + width) * chunk_z + 1]),
                                      0.5, SP, full_shape=vol.shape, k0=k, chunk_z=chunk_z)
                 for k in range(0, ngran - width + 1, width)]
        got = [torch.cat([p[i] for p in parts]) for i in range(2)]
        n = len(got[0])
        assert torch.equal(got[0], whole[0][:n]) and torch.equal(got[1], whole[1][:n])
    folded = ref.mc_partials_fold(*whole)
    v, a = ops.mc_volume_area(vol, 0.5, SP, device="cpu", chunk_z=chunk_z)
    assert float(v) == float(folded[0]) and float(a) == float(folded[1])


def test_mc_single_case_still_matches_jax_ref():
    vol = np.pad(_ellipsoid(shape=(21, 17, 26), radii=(8, 6, 10))[1], 1)
    v, a = ref.mc_volume_area(torch.from_numpy(vol), 0.5, SP)
    wv, wa = jax_ref.mc_volume_area(jnp.asarray(vol), 0.5, SP,
                                    origin=ref.centred_origin(vol.shape, SP))
    np.testing.assert_allclose([float(v), float(a)], [float(wv), float(wa)], rtol=1e-4)


def test_window_wrapper_checks_its_window():
    win = torch.zeros((5, 5, 10))
    with pytest.raises(ValueError, match="granules"):
        marching_cubes.mc_slab_partials(win, full_shape=(5, 5, 20), chunk_z=4)
    with pytest.raises(ValueError, match="x and y"):
        marching_cubes.mc_slab_partials(torch.zeros((5, 5, 9)), full_shape=(6, 5, 20),
                                        chunk_z=4)
