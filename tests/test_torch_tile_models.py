"""The tile decompositions of the compaction and GLCM kernels, on the CPU.

A CUDA kernel has no CPU mode, so these tests hold numpy models of how
``csrc/compact.cu`` and ``csrc/glcm.cu`` split their work over blocks to
the JAX package's reference functions, exactly:

* compaction: per tile a count (pass 1); per block the sum of its case's
  earlier tiles and of all of them, a thread's 16 flags ranked by a warp
  scan of the per-thread counts and a scan of the warp counts, survivors
  below cap to their slots, and one even share of the pad slots (pass 2).
  Every output slot is written by exactly one block.
* GLCM: per tile of ``glcm.tiling`` (x-planes by y-rows by z-columns, with
  a one-voxel halo past its end), one CUDA block each, the bins of the
  tile, the +X, +Y and +Z pairs of the voxels it owns, and its symmetrised
  counts as one partial row; the rows summed.
  Every pair of neighbouring voxels is owned by exactly one tile.

Cheap: a few seconds.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import compact as jax_compact  # noqa: E402
from repro.kernels import glcm as jax_glcm  # noqa: E402
from repro_torch.kernels import compact, glcm  # noqa: E402

# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

PATTERNS = ["random", "zero-survivor", "all-survivor", "cap-boundary", "overflow"]
F = compact.FLAGS_PER_THREAD


def _keep_for(pattern: str, m: int, rng) -> np.ndarray:
    """The five keep patterns of ``tests/test_torch_batched.py``, at a pattern
    cap of half the list (the overflow one 57 past it, as far as the list
    goes)."""
    if pattern == "random":
        return rng.random(m) < 0.3
    if pattern == "zero-survivor":
        return np.zeros(m, bool)
    if pattern == "all-survivor":
        return np.ones(m, bool)
    pcap = max(1, m // 2)
    keep = np.zeros(m, bool)
    keep[rng.choice(m, size=pcap if pattern == "cap-boundary" else min(m, pcap + 57),
                    replace=False)] = True
    return keep


def compact_model(verts, keep, cap: int, tile: int):
    """``(out, mask, n, writes)`` as the two passes of ``csrc/compact.cu``
    make them; ``writes`` counts the stores each output slot received."""
    batch, m = keep.shape
    tiles, threads = compact.tiles(m, tile), tile // F
    flags = np.zeros((batch, tiles * tile), bool)
    flags[:, :m] = keep
    counts = flags.reshape(batch, tiles, tile).sum(2)  # pass 1
    out = np.full((batch, cap, 3), np.nan, np.float32)
    mask = np.zeros((batch, cap), np.int8)
    writes = np.zeros((batch, cap), np.int64)
    n_out = np.full(batch, -1, np.int64)
    for b, t in itertools.product(range(batch), range(tiles)):  # pass 2, a block each
        below, n = counts[b, :t].sum(), counts[b].sum()
        f = flags[b, t * tile:(t + 1) * tile].reshape(threads, F)
        mine = f.sum(1).reshape(threads // 32, 32)
        incl = np.cumsum(mine, axis=1)  # the warp's inclusive scan
        warp_base = np.concatenate([[0], np.cumsum(incl[:, -1])[:-1]])  # the shared scan
        first = (below + warp_base[:, None] + incl - mine).reshape(threads)
        slot = first[:, None] + np.cumsum(f, axis=1) - 1
        th, j = np.nonzero(f & (slot < cap))
        s = slot[th, j]
        out[b, s] = verts[b, t * tile + th * F + j]
        mask[b, s] = 1
        np.add.at(writes[b], s, 1)
        filled = min(n, cap)
        share = -(-(cap - filled) // tiles)
        s0 = filled + t * share
        s1 = min(s0 + share, cap)
        out[b, s0:s1] = 0.0
        mask[b, s0:s1] = 0
        writes[b, s0:s1] += 1
        if t == 0:
            n_out[b] = n
    return out, mask.astype(bool), n_out.astype(np.int32), writes


TILES = (compact.TILE_GRAIN, compact.DEFAULT_BLOCK)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_compaction_model_equals_the_reference(pattern):
    """Every M around the tile borders of both tiles, caps 1, n - 1, n,
    n + 1 and M, three cases a launch: the model's output at each tile
    equals the reference's bits, and each slot is written once."""
    rng = np.random.default_rng(PATTERNS.index(pattern))
    lengths = sorted({m for t in TILES for m in (1, 15, 16, 17, t - 1, t, t + 1, 3 * t + 5)})
    checked = 0
    for m in lengths:
        verts = (rng.normal(size=(3, m, 3)) * 20.0).astype(np.float32)
        keep = np.stack([_keep_for(pattern, m, rng) for _ in range(3)])
        n = int(keep.sum(1).max())
        for cap in sorted({c for c in (1, n - 1, n, n + 1, m) if c >= 1}):
            want = [np.asarray(w) for w in jax_compact.compact_batch_ref(verts, keep, cap)]
            for tile in TILES:
                out, mask, cnt, writes = compact_model(verts, keep, cap, tile)
                np.testing.assert_array_equal(out.view(np.int32), want[0].view(np.int32))
                np.testing.assert_array_equal(mask, want[1])
                np.testing.assert_array_equal(cnt, want[2])
                assert (writes == 1).all(), (m, cap, tile)
                checked += 1
    assert checked >= len(lengths) * len(TILES)


def test_compaction_splits_a_case_over_blocks():
    for tile in (compact.TILE_GRAIN, compact.DEFAULT_BLOCK, compact.MAX_TILE):
        assert compact.valid_block(tile)
        assert compact.tiles(0, tile) == compact.tiles(1, tile) == compact.tiles(tile, tile) == 1
        assert compact.tiles(2 * tile, tile) == 2 and compact.tiles(2 * tile + 1, tile) == 3
    assert compact.tiles(65536, compact.DEFAULT_BLOCK) == 16  # the cohort's largest launch
    for bad in (0, 256, 4000, compact.MAX_TILE + compact.TILE_GRAIN):
        assert not compact.valid_block(bad)


# ---------------------------------------------------------------------------
# GLCM
# ---------------------------------------------------------------------------


def glcm_model(bins: np.ndarray, n_bins: int, d: int, ry: int, rz: int):
    """``(counts, owners, rows)`` of one case as ``glcm_tile_kernel`` and
    ``glcm_sum_kernel`` make them under the tiling ``(d, ry, rz)``, one
    CUDA block a tile: ``bins`` the case's bins, -1 outside the mask;
    ``rows`` each tile's partial row (its symmetrised counts; tiles in the
    kernel's order, z fastest, then y, then x); ``counts`` their sum;
    ``owners`` per axis, the tiles that counted each pair of neighbours
    (the lower voxel's index)."""
    nx, ny, nz = bins.shape
    tz, ty = -(-nz // rz), -(-ny // ry)
    owners = [np.zeros((nx - 1, ny, nz), np.int64), np.zeros((nx, ny - 1, nz), np.int64),
              np.zeros((nx, ny, nz - 1), np.int64)]
    tiles = glcm.tile_count(bins.shape, d, ry, rz)
    rows_out = np.zeros((tiles, n_bins * n_bins), np.int64)
    for tile in range(tiles):
        gz, gy, gx = tile % tz, (tile // tz) % ty, tile // (tz * ty)
        x0, y0, z0 = gx * d, gy * ry, gz * rz
        pd, rd, cd = min(d, nx - x0), min(ry, ny - y0), min(rz, nz - z0)
        planes, rows = pd + (x0 + pd < nx), rd + (y0 + rd < ny)
        cols = cd + (z0 + cd < nz)
        t = bins[x0:x0 + planes, y0:y0 + rows, z0:z0 + cols]  # the halo included
        hist = np.zeros(n_bins * n_bins, np.int64)
        cx, cy, cz = min(pd, planes - 1), min(rd, rows - 1), min(cd, cols - 1)
        for axis, (lower, upper) in enumerate([
                (t[:cx, :rd, :cd], t[1:cx + 1, :rd, :cd]),  # +X
                (t[:pd, :cy, :cd], t[:pd, 1:cy + 1, :cd]),  # +Y
                (t[:pd, :rd, :cz], t[:pd, :rd, 1:cz + 1])]):  # +Z
            ok = (lower >= 0) & (upper >= 0)
            np.add.at(hist, lower[ok] * n_bins + upper[ok], 1)
            owners[axis][x0:x0 + lower.shape[0], y0:y0 + lower.shape[1],
                         z0:z0 + lower.shape[2]] += 1
        h = hist.reshape(n_bins, n_bins)
        rows_out[tile] = (h + h.T).reshape(-1)  # the tile's partial row
    total = rows_out.sum(0)
    return total.reshape(n_bins, n_bins).astype(np.float32), owners, rows_out


def _case(kind: str, shape, seed: int = 0):
    rng = np.random.default_rng(seed)
    img = rng.normal(40.0, 15.0, shape).astype(np.float32)
    msk = (rng.random(shape) < 0.7).astype(np.float32)
    if kind == "one-level":  # every masked voxel in one bin: the worst collisions
        img[:] = 7.0
    elif kind == "empty":
        msk[:] = 0.0
    elif kind == "full":
        msk[:] = 1.0
    return img, msk


def _bins(img, msk, n_bins):
    q, m = glcm._quantize_batch(torch.from_numpy(img[None]), torch.from_numpy(msk[None]),
                                n_bins)
    return np.where(m[0].numpy() > 0, q[0].numpy().astype(np.int64), -1)


SHAPES = [(1, 7, 19), (5, 1, 23), (6, 9, 1), (9, 12, 37), (4, 5, 50)]


@pytest.mark.parametrize("n_bins", [1, 32, 64])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_glcm_tile_model_equals_the_reference(shape, n_bins):
    """Tiles with borders at every plane and row, a z-split, two-voxel
    tiles, the wrapper's own tilings and one tile for the volume: each
    in-bounds pair is owned once, and the counts equal the reference's."""
    nx, ny, nz = shape
    tilings = {(1, 1, nz), (1, 1, 1), (2, 3, max(1, nz // 3)), (nx, ny, nz), (3, 2, 4)}
    tilings |= {glcm.tiling(shape, batch, block, sms)
                for batch in (1, 5) for block in (1, 4, 64) for sms in (1, 132)}
    for kind in ("random", "one-level", "full", "empty"):
        img, msk = _case(kind, shape, seed=nx * 7 + n_bins)
        bins = _bins(img, msk, n_bins)
        want = np.asarray(jax_glcm.glcm_matrix_batch_ref(img[None], msk[None], n_bins))[0]
        for d, ry, rz in sorted(tilings):
            got, owners, rows = glcm_model(bins, n_bins, d, ry, rz)
            assert all((o == 1).all() for o in owners), (kind, d, ry, rz)
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} tiling {(d, ry, rz)}")
            assert (rows == rows.reshape(-1, n_bins, n_bins).transpose(0, 2, 1)
                    .reshape(len(rows), -1)).all()  # every partial row is symmetric
        if kind == "empty":
            assert not want.any()
        elif kind == "one-level":
            assert np.count_nonzero(want) == 1


def test_glcm_tiling_fits_the_kernel():
    """Every tiling the wrapper picks fits a tile with its halo in the
    kernel's shared bins, and splits big cases over many blocks."""
    shapes = [(160, 96, 160), (228, 84, 141), (32, 32, 32), (3, 700, 700), (2, 3, 5000),
              (1, 1, 1), (1, 1, 40000), (64, 64, 64), (17, 1, 1)]
    for shape, batch, block, sms in itertools.product(shapes, (1, 2, 64), (1, 4, 64),
                                                      (1, 132)):
        d, ry, rz = glcm.tiling(shape, batch, block, sms)
        nx, ny, nz = shape
        assert 1 <= d <= nx and 1 <= ry <= ny and 1 <= rz <= nz
        assert min(d + 1, nx) * min(ry + 1, ny) * min(rz + 1, nz) <= glcm.TILE_BYTES
        assert glcm.tile_count(shape, d, ry, rz) >= 1
    # the cohort's largest GLCM launch: ~4 blocks an SM over 132 SMs, tiles
    # of whole z-rows (one contiguous span a plane)
    d, ry, rz = glcm.tiling((160, 96, 160), 2, glcm.DEFAULT_BLOCK, 132)
    assert 2 * glcm.tile_count((160, 96, 160), d, ry, rz) >= 2 * 132 and rz == 160
    assert glcm.tiling((3, 700, 700), 1, 4, 132)[1] < 700  # a y-split
    assert glcm.tiling((2, 3, 5000), 1, 4, 132)[2] < 5000  # a z-split
    for bad in (0, 2.5, glcm.MAX_BLOCK + 1, 256):
        assert not glcm.valid_block(bad)
