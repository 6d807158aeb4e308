"""The main path's diameter sweep over each list's valid extent, on the CPU.

``seqacc`` and ``nomask`` sweep only the tiles of a list's extent
(1 + the index of its last valid slot, ``ref.list_extent``), in the colex
tile order that makes the extent a prefix (``ref.colex_tiles``, the plain
mirror of the kernel's decode).  What makes that exact: every slot past
the extent holds a copy of a valid vertex (``ref.diameter_input_batch``),
so the plain sweep over the truncated list equals the whole list's
bitwise.  The kernels themselves are held against the plain version on
the card (``tests/test_torch_variants_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import diameter as jax_diameter  # noqa: E402
from repro_torch.kernels import diameter, ref  # noqa: E402


def _masks(kind, m, rng):
    if kind == "valid-first":
        return np.arange(m) < max(1, int(0.6 * m))
    if kind == "scattered":
        mask = rng.random(m) < 0.4
        mask[rng.integers(m)] = True
        return mask
    if kind == "single-valid":
        mask = np.zeros(m, bool)
        mask[rng.integers(m)] = True
        return mask
    return np.ones(m, bool)  # all-valid


def _numpy_extent(mask):
    idx = np.nonzero(mask)[0]
    return int(idx[-1]) + 1 if len(idx) else 0


@pytest.mark.parametrize("kind", ["valid-first", "scattered", "single-valid", "all-valid"])
@pytest.mark.parametrize("m", [1, 37, 512, 1000])
def test_extent_matches_numpy(kind, m):
    rng = np.random.default_rng(m)
    mask = _masks(kind, m, rng)
    got = ref.list_extent(torch.from_numpy(mask)[None])
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got[0]) == _numpy_extent(mask)


def test_extent_of_stack_rows_with_different_counts():
    rng = np.random.default_rng(1)
    masks = np.zeros((5, 700), bool)
    for b, n in enumerate((1, 90, 350, 699, 700)):
        masks[b, :n] = True  # valid-first, as the compacted lists are
    masks[2, 500] = True  # one scattered slot past the count
    masks[3] = rng.random(700) < 0.3
    got = ref.list_extent(torch.from_numpy(masks)).tolist()
    assert got == [_numpy_extent(mk) for mk in masks]
    assert int(ref.list_extent(torch.zeros((1, 9), dtype=torch.bool))[0]) == 0


def test_colex_order_covers_the_triangle_once_and_prefixes_are_corners():
    for nb in (1, 2, 3, 7, 64, 333, 1024):
        n = nb * (nb + 1) // 2
        i, j = (x.numpy() for x in ref.colex_tiles(torch.arange(n)))
        # every upper-triangle tile exactly once
        assert np.all((0 <= i) & (i <= j) & (j < nb))
        assert len(np.unique(j.astype(np.int64) * nb + i)) == n
        # the column never decreases and column k starts at k(k+1)/2, so the
        # first k(k+1)/2 tiles are the k x k corner for every k
        assert np.all(np.diff(j) >= 0)
        k = np.arange(nb)
        np.testing.assert_array_equal(j[k * (k + 1) // 2], k)
        np.testing.assert_array_equal(i[k * (k + 1) // 2], 0)
        # the kernel's step from tile t to t + 1 (row + 1, or the next column)
        step_i = np.where(i[:-1] < j[:-1], i[:-1] + 1, 0)
        step_j = np.where(i[:-1] < j[:-1], j[:-1], j[:-1] + 1)
        np.testing.assert_array_equal(step_i, i[1:])
        np.testing.assert_array_equal(step_j, j[1:])


def test_colex_decode_at_large_tile_indices():
    # the decode's float square root needs its integer correction up here
    t = torch.tensor([0, 1, 2, 2 ** 20 - 1, 2 ** 26 + 5, 2 ** 30 + 12345, 2 ** 31 - 1])
    i, j = ref.colex_tiles(t)
    assert torch.all((0 <= i) & (i <= j))
    assert torch.equal(j * (j + 1) // 2 + i, t)


def test_extent_tiles_and_schedule_prefix():
    for nb, block in ((1, 64), (9, 64), (40, 32)):
        ij = ref.tile_schedule(nb)
        for e in {min(x, nb * block) for x in (1, block - 1, block, block + 1, nb * block)}:
            n = ref.extent_tiles(e, block)
            k = -(-e // block)
            assert n == k * (k + 1) // 2
            assert int(ij[:, :n].max()) == k - 1  # the prefix is the k x k corner


@pytest.mark.parametrize("m,block,seed", [(300, 64, 0), (513, 128, 1), (700, 256, 2)])
def test_extent_sweep_equals_full_sweep_and_reference(m, block, seed):
    rng = np.random.default_rng(seed)
    verts = (rng.normal(size=(m, 3)) * [30.0, 50.0, 20.0] + 200.0).astype(np.float32)
    mask = rng.random(m) < 0.5
    mask[int(0.7 * m):] = False  # an extent well inside the list
    mask[int(0.7 * m) - 1] = True
    vt, mt = torch.from_numpy(verts), torch.from_numpy(mask)
    v = ref.diameter_input(vt, mt, block)
    e = int(ref.list_extent(mt[None])[0])
    assert e == int(0.7 * m)
    full = ref.pair_sweep(v)
    assert torch.equal(ref.pair_sweep(v[:, :e].contiguous()), full)
    # the extent's tiles, not just its slots: the colex prefix of whole tiles
    k = -(-e // block)
    assert torch.equal(ref.pair_sweep(v[:, :k * block].contiguous()), full)
    assert torch.equal(diameter.max_diameters_sq(vt, mt, block=block), full)
    want = np.asarray(jax_diameter.max_diameters_sq_pallas(verts, mask, block=block,
                                                           variant="seqacc", interpret=True))
    np.testing.assert_allclose(full.numpy(), want, rtol=1e-4)
