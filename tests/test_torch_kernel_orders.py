"""The orders the first-order and marching-cubes kernels are built on, on the CPU.

A CUDA kernel has no CPU mode, so these tests hold the arithmetic and the
layouts the kernels rely on: the first-order warp mapping of
``csrc/firstorder.cu`` (lane l holds voxels 4l..4l+3 + 128r; levels 512,
256, 128 in-lane, 64 ... 4 by shuffles, 2 and 1 in-lane) is the canonical
chunk tree bit for bit; the marching-cubes edge table the kernel reads is
``core/mc_tables.py``'s; and the marching-cubes items cover every cell of a
volume once, with the same partial layout for a frame and its z-windows at
every block.  Cheap: well under 10 s.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import mc_tables  # noqa: E402
from repro_torch.kernels import firstorder, marching_cubes  # noqa: E402


def warp_tree(y: np.ndarray) -> np.ndarray:
    """A numpy model of ``fo_partials_kernel``'s sum of each (N, 1024) row:
    regs[lane, r, j] = y[128 r + 4 lane + j]; in-lane r + h for h = 4, 2, 1
    (voxel levels 512, 256, 128); lane l + off for off = 16 ... 1
    (__shfl_down_sync, levels 64 ... 4); then lane 0's (0 + 2) + (1 + 3)."""
    n = len(y)
    regs = y.reshape(n, 8, 32, 4).transpose(0, 2, 1, 3).copy()  # (n, lane, r, j)
    h = 4
    while h:
        regs[:, :, :h] = regs[:, :, :h] + regs[:, :, h:2 * h]
        h //= 2
    x = regs[:, :, 0, :]  # (n, lane, j)
    for off in (16, 8, 4, 2, 1):
        shifted = x.copy()
        shifted[:, :32 - off] = x[:, off:]  # lanes past the warp keep their own
        x = x + shifted
    y0 = x[:, 0]
    return (y0[:, 0] + y0[:, 2]) + (y0[:, 1] + y0[:, 3])


def _chunks(kind, n=64, seed=0):
    rng = np.random.default_rng(seed)
    C = firstorder.CANON_CHUNK
    if kind == "signed":
        y = rng.normal(0.0, 1000.0, (n, C))
    elif kind == "zeros":
        y = np.where(rng.random((n, C)) < 0.7, 0.0, rng.normal(0.0, 5.0, (n, C)))
        y[0] = 0.0
        y[1] = -0.0
    else:  # large magnitudes that cancel, beside small ones
        y = rng.normal(0.0, 1.0, (n, C)) * 10.0 ** rng.integers(-6, 17, (n, C))
    return y.astype(np.float32)


@pytest.mark.parametrize("kind", ["signed", "zeros", "large"])
def test_warp_mapping_is_the_canonical_chunk_tree(kind):
    y = _chunks(kind)
    for vals in (y, y * y):  # sum x and sum x^2, each square rounded once
        want = firstorder._chunk_tree(torch.from_numpy(vals)).numpy()
        got = warp_tree(vals)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_warp_mapping_differs_from_a_sequential_sum():
    """The model is not vacuous: another order gives other bits."""
    y = _chunks("large")
    seq = np.zeros(len(y), np.float32)
    for i in range(y.shape[1]):
        seq = seq + y[:, i]
    assert not np.array_equal(seq, warp_tree(y))


def test_edge_table_header_is_generated_from_tables():
    assert marching_cubes.EDGE_HEADER.read_text() == marching_cubes.edge_table_source()


def test_edge_code_decodes_to_the_tables():
    text = marching_cubes.EDGE_HEADER.read_text()
    code = int(re.search(r"kEdgeCode = 0x([0-9a-f]+)ULL", text).group(1), 16)
    corners = mc_tables.CORNERS
    for e in range(12):
        bits = code >> (5 * e) & 31
        axis, off = bits & 3, np.array([bits >> 2 & 1, bits >> 3 & 1, bits >> 4 & 1])
        assert axis == mc_tables.EDGE_CELL_AXIS[e]
        np.testing.assert_array_equal(off, mc_tables.EDGE_CELL_OFFSET[e])
        # the edge joins its anchor and the point one step along its axis:
        # the two corners of mc_tables.EDGES[e]
        ends = {tuple(off), tuple(off + np.eye(3, dtype=int)[axis])}
        assert ends == {tuple(corners[c]) for c in mc_tables.EDGES[e]}
    assert code >> 60 == 0


def _items(shape, chunk_z):
    """A model of the kernel's items (csrc/marching_cubes.cu decode): for
    each partial an item makes, its column in the (granules, parts per
    granule) layout and the set of cells it owns."""
    TX, TY, PZ = marching_cubes.TILE
    cx, cy, cz = (max(n - 1, 0) for n in shape)
    ngran, ppg = marching_cubes.layout(shape, chunk_z)
    tiles_x, tiles_y = max(1, -(-cx // TX)), max(1, -(-cy // TY))
    tiles = tiles_x * tiles_y
    nsub = -(-chunk_z // PZ)
    assert ppg == nsub * tiles
    group = PZ // chunk_z if nsub == 1 else 1
    zgroups = -(-ngran // group) if nsub == 1 else ngran * nsub
    for r in range(tiles * zgroups):
        tile, q = divmod(r, zgroups)
        x0, y0 = tile // tiles_y * TX, tile % tiles_y * TY
        if nsub == 1:
            g0, s, pp = q * group, 0, chunk_z
            parts = min(group, ngran - g0)
            kz, planes = g0 * chunk_z, parts * chunk_z
        else:
            (g0, s), pp, parts = divmod(q, nsub), PZ, 1
            kz, planes = g0 * chunk_z + s * PZ, min(PZ, chunk_z - s * PZ)
        assert planes <= PZ
        for j in range(parts):
            lo = kz + j * pp
            gran = g0 + (j if nsub == 1 else 0)
            cells = {(x, y, k) for x in range(x0, min(x0 + TX, cx))
                     for y in range(y0, min(y0 + TY, cy))
                     for k in range(lo, min(lo + min(pp, planes - j * pp), cz))}
            yield (gran, s * tiles + tile), cells


@pytest.mark.parametrize("shape,chunk_z", [((20, 13, 30), 8), ((17, 19, 2), 8),
                                           ((9, 9, 26), 3), ((12, 26, 41), 20),
                                           ((10, 9, 90), 40), ((11, 3, 75), 33),
                                           ((2, 2, 9), 1), ((1, 5, 5), 4)])
def test_mc_items_cover_every_cell_once(shape, chunk_z):
    seen, cols = [], set()
    for col, cells in _items(shape, chunk_z):
        assert col not in cols
        cols.add(col)
        seen.extend(cells)
    want = {(x, y, k) for x in range(shape[0] - 1) for y in range(shape[1] - 1)
            for k in range(shape[2] - 1)}
    assert len(seen) == len(set(seen)) and set(seen) == want


@pytest.mark.parametrize("block", [32, 64, 96, 128, 256, 1024])
@pytest.mark.parametrize("chunk_z", [1, 4, 8, 11])
def test_layout_of_a_frame_and_its_windows_agree_at_every_block(block, chunk_z):
    frame = (96, 57, 83)
    ngran, ppg = marching_cubes.layout(frame, chunk_z, block)
    assert (ngran, ppg) == marching_cubes.layout(frame, chunk_z)  # block sets no count
    assert ngran == -(-(frame[2] - 1) // chunk_z)
    for w in (1, 2, ngran):
        window = (frame[0], frame[1], w * chunk_z + 1)
        assert marching_cubes.layout(window, chunk_z, block) == (w, ppg)


def test_layout_refuses_what_the_kernel_does_not_take():
    for block in (48, 0, 1056):
        with pytest.raises(ValueError):
            marching_cubes.layout((10, 10, 10), 8, block=block)
    with pytest.raises(ValueError):
        marching_cubes.layout((10, 10, 10), 0)
