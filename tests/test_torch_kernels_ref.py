"""Plain PyTorch ops and kernel versions vs the JAX package, on the CPU.

Integer results (active masks, counts, compaction order) and vertex
positions must match exactly.  The plain marching cubes and diameter sweep
are held against the Pallas kernels in interpret mode, as the JAX
package's own tests run them on the CPU, and against ``repro.kernels.ref``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import diameter as jax_diam  # noqa: E402
from repro.kernels import marching_cubes as jax_mc  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import diameter, marching_cubes, ref  # noqa: E402

from conftest import box_mask, sphere_mask  # noqa: E402


def _random_vol(shape, seed):
    rng = np.random.default_rng(seed)
    return np.pad(rng.random(shape).astype(np.float32), 1)


def _binary_case(seed):
    rng = np.random.default_rng(seed)
    return np.pad((rng.random((9, 11, 8)) > 0.55).astype(np.float32), 1)


@pytest.mark.parametrize("vol,spacing,offset", [
    (_random_vol((7, 9, 6), 0), (1.0, 1.0, 1.0), None),
    (_binary_case(1), (0.8, 1.0, 1.25), None),
    (_binary_case(2), (2.0, 1.0, 0.5), (5, 17, 3)),
])
def test_vertex_fields_exact(vol, spacing, offset):
    ours = ref.vertex_fields(torch.from_numpy(vol), 0.5, spacing, index_offset=offset)
    theirs = jax_ref.vertex_fields(jnp.asarray(vol), 0.5, spacing, index_offset=offset)
    for name, a, b in zip(ours._fields, ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("seed,cap", [(3, 4096), (4, 700), (5, 64)])
def test_count_and_compaction_exact(seed, cap):
    vol = _binary_case(seed)
    f = ref.vertex_fields(torch.from_numpy(vol), 0.5, (1.0, 0.9, 1.1))
    g = jax_ref.vertex_fields(jnp.asarray(vol), 0.5, (1.0, 0.9, 1.1))
    assert int(ref.count_vertices(f)) == int(jax_ref.count_vertices(g))
    verts, mask, n = ref.compact_vertices(f, cap)
    jverts, jmask, jn = jax_ref.compact_vertices(g, cap)
    assert int(n) == int(jn)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(verts.numpy(), np.asarray(jverts))


@pytest.mark.parametrize("vol,spacing", [
    (_random_vol((10, 11, 9), 10), (1.0, 1.0, 1.0)),
    (np.pad(sphere_mask(14, 5.0), 1), (1.0, 1.0, 1.0)),
    (np.pad(box_mask((12, 8, 7), (2, 1, 1), (10, 7, 6)), 1), (2.0, 1.0, 0.5)),
    (_binary_case(6), (0.7, 1.3, 1.0)),
])
def test_plain_mc_matches_pallas_and_ref(vol, spacing):
    v, a = ref.mc_volume_area(torch.from_numpy(vol), 0.5, spacing)
    pv, pa = jax_mc.mc_volume_area_pallas(vol, 0.5, spacing, block=(4, 4, 4), chunk=64,
                                          interpret=True)
    np.testing.assert_allclose(float(v), float(pv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(a), float(pa), rtol=1e-5, atol=1e-4)
    wv, wa = jax_ref.mc_volume_area(jnp.asarray(vol), 0.5, spacing)
    np.testing.assert_allclose(float(v), float(wv), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(a), float(wa), rtol=1e-4, atol=1e-3)


def test_plain_mc_sphere_is_analytic():
    v, a = ref.mc_volume_area(torch.from_numpy(np.pad(sphere_mask(28, 9.0), 1)))
    assert abs(float(v) / (4 / 3 * np.pi * 9.0 ** 3) - 1) < 0.02
    assert 1.0 < float(a) / (4 * np.pi * 9.0 ** 2) < 1.15


def _vertex_cloud(m, seed, scale=40.0):
    rng = np.random.default_rng(seed)
    verts = (rng.normal(size=(m, 3)) * scale + 300.0).astype(np.float32)
    mask = rng.random(m) < 0.7
    mask[rng.integers(m)] = True
    return verts, mask


@pytest.mark.parametrize("m,seed", [(1, 0), (2, 1), (300, 2), (517, 3)])
def test_plain_diameter_matches_pallas_and_ref(m, seed):
    verts, mask = _vertex_cloud(m, seed)
    ours = ref.max_diameters_sq(torch.from_numpy(verts), torch.from_numpy(mask)).numpy()
    pallas = jax_diam.max_diameters_sq_pallas(verts, mask, block=128, variant="seqacc",
                                              interpret=True)
    np.testing.assert_allclose(ours, np.asarray(pallas), rtol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(jax_ref.max_diameters_sq(verts, mask)),
                               rtol=1e-5)


def test_diameter_input_fills_centres_and_pads():
    # the sweep's input keeps the coordinates of the case's crop frame: no
    # shift that a candidate set could move (the reference centres on the
    # candidates' bounding box; tiled 'bounds' pruning can move that box)
    verts, mask = _vertex_cloud(300, 7)
    v = ref.diameter_input(torch.from_numpy(verts), torch.from_numpy(mask), 128)
    assert v.shape == (3, 384) and v.is_contiguous()
    first = verts[np.argmax(mask)]
    fill = np.where(mask[:, None], verts, first)
    np.testing.assert_array_equal(v[:, :300].numpy(), fill.T)
    np.testing.assert_array_equal(v[:, 300:].numpy(), np.repeat(v[:, 299:300].numpy(), 84, 1))


def test_diameter_plain_is_block_invariant():
    verts, mask = _vertex_cloud(700, 8)
    vt, mt = torch.from_numpy(verts), torch.from_numpy(mask)
    base = ref.max_diameters_sq(vt, mt, 256)
    for block in (32, 128, 1024):
        assert torch.equal(ref.max_diameters_sq(vt, mt, block), base)


def test_cpu_tensors_take_the_plain_versions():
    mc_before, diam_before = marching_cubes.LAUNCHES, diameter.LAUNCHES
    vol = torch.from_numpy(np.pad(sphere_mask(12, 4.0), 1))
    assert [float(x) for x in marching_cubes.mc_volume_area(vol)] == \
        [float(x) for x in ref.mc_volume_area(vol)]
    verts, mask = _vertex_cloud(100, 9)
    vt, mt = torch.from_numpy(verts), torch.from_numpy(mask)
    assert torch.equal(diameter.max_diameters(vt, mt), torch.sqrt(ref.max_diameters_sq(vt, mt)))
    assert (marching_cubes.LAUNCHES, diameter.LAUNCHES) == (mc_before, diam_before)


def test_empty_vertex_list_raises():
    with pytest.raises(ValueError):
        ref.max_diameters_sq(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.bool))
