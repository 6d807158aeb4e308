"""The port's diameter variants (the paper's Fig. 1 axis) against the JAX
package, on the CPU.

Each variant's plain version (``repro_torch.kernels.ref``, which a CPU
tensor takes through the kernel wrapper) is held against the reference's
Pallas variant in interpret mode on the same numpy inputs, at the
tolerance of ``tests/test_kernels_diameter.py`` (rtol 1e-5, atol 1e-5);
``gram`` at the 1e-3 that ``tests/test_gram_precision.py`` documents for
the Gram identity.  Within the port the direct variants agree bitwise on
the same prepared input.  The CUDA kernels themselves are held against
these plain versions on the card (``tests/test_torch_variants_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.shape_features import ShapeFeatureExtractor as JaxShapeFeatureExtractor  # noqa: E402
from repro.kernels import diameter as jax_diameter  # noqa: E402
from repro_torch.core import BatchedExtractor, ShapeFeatureExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import diameter, ops, ref  # noqa: E402

VARIANTS = diameter.VARIANTS
DIRECT = tuple(v for v in VARIANTS if v != "gram")
GRAM_RTOL = 1e-3  # tests/test_gram_precision.py's documented bound
SHAPE_KEYS = ["MeshVolume", "SurfaceArea", "Maximum3DDiameter", "Maximum2DDiameterSlice",
              "Maximum2DDiameterRow", "Maximum2DDiameterColumn", "MajorAxisLength"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These cases' tensors are small: one intra-op thread runs them about
    as fast alone, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, block):
    rng = np.random.default_rng(m + block)
    verts = (rng.normal(size=(m, 3)) * [3.0, 7.0, 1.5]).astype(np.float32)
    mask = rng.random(m) > 0.25
    return verts, mask


def test_variants_are_the_references():
    assert VARIANTS == jax_diameter.VARIANTS


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("m,block", [(64, 64), (100, 64), (300, 128), (513, 256)])
def test_plain_variant_matches_reference_interpret(variant, m, block):
    verts, mask = _inputs(m, block)
    want = np.asarray(jax_diameter.max_diameters_sq_pallas(
        verts, mask, block=block, variant=variant, interpret=True))
    got = diameter.max_diameters_sq(torch.from_numpy(verts), torch.from_numpy(mask),
                                    block=block, variant=variant).numpy()
    tol = GRAM_RTOL if variant == "gram" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("variant", DIRECT)
@pytest.mark.parametrize("block", [32, 128, 256])
def test_direct_variants_equal_seqacc_bitwise(variant, block):
    rng = np.random.default_rng(block)
    verts = torch.from_numpy((rng.normal(size=(3, 700, 3)) * 40 + 200).astype(np.float32))
    masks = torch.from_numpy(rng.random((3, 700)) < 0.6)
    masks[2] = False
    masks[2, 5] = True  # one valid vertex: all maxima 0
    got = diameter.max_diameters_sq_batch(verts, masks, block=block, variant=variant)
    assert torch.equal(got, ref.max_diameters_sq_batch(verts, masks, 256))
    assert torch.equal(got[2], torch.zeros(4))


@pytest.mark.parametrize("variant", VARIANTS)
def test_batch_row_equals_single_case(variant):
    rng = np.random.default_rng(3)
    verts = torch.from_numpy((rng.normal(size=(4, 300, 3)) * 25).astype(np.float32))
    masks = torch.from_numpy(rng.random((4, 300)) < 0.7)
    got = diameter.max_diameters_sq_batch(verts, masks, block=64, variant=variant)
    for b in range(4):
        assert torch.equal(got[b], diameter.max_diameters_sq(verts[b], masks[b], block=64,
                                                             variant=variant))


def test_gram_within_rounding_of_direct():
    """The Gram identity in float64 rounds each squared difference once;
    the direct sweep rounds the difference and its square: they differ in
    the last places only."""
    rng = np.random.default_rng(9)
    verts = torch.from_numpy((rng.normal(size=(2, 500, 3)) * 80).astype(np.float32))
    masks = torch.from_numpy(rng.random((2, 500)) < 0.8)
    g = diameter.max_diameters_sq_batch(verts, masks, block=128, variant="gram")
    d = diameter.max_diameters_sq_batch(verts, masks, block=128)
    np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=1e-6)


# -- gram precision at paper scale (a copy of tests/test_gram_precision.py) --

def _paper_scale_cloud(seed: int, m: int = 384, offset_mm: float = 0.0):
    """Vertices at KITS19-like physical scale: mm spacing x 512^3 extent."""
    rng = np.random.default_rng(seed)
    spacing = np.array([0.7, 0.7, 5.0])  # axial CT voxel spacing (mm)
    extent = np.array([512, 512, 512], np.float64)
    idx = rng.uniform(0.0, 1.0, size=(m, 3)) * extent
    return (idx * spacing + offset_mm).astype(np.float32)


def _diameters_f64(verts: np.ndarray) -> np.ndarray:
    v = verts.astype(np.float64)
    d = v[:, None, :] - v[None, :, :]
    q = d * d
    planes = (q.sum(-1), q[..., 0] + q[..., 1], q[..., 0] + q[..., 2], q[..., 1] + q[..., 2])
    return np.sqrt(np.asarray([p.max() for p in planes]))


def _port(verts, variant):
    t = torch.from_numpy(verts)
    return diameter.max_diameters(t, torch.ones(len(t), dtype=torch.bool), block=128,
                                  variant=variant).double().numpy()


@pytest.mark.parametrize("seed", range(6))
def test_gram_error_within_documented_bound(seed):
    verts = _paper_scale_cloud(seed)
    want = _diameters_f64(verts)
    rel = np.abs(_port(verts, "gram") - want) / want
    assert rel.max() < GRAM_RTOL, rel.max()


@pytest.mark.parametrize("offset_mm", [500.0, 1500.0])
def test_gram_bound_survives_scanner_frame_offsets(offset_mm):
    verts = _paper_scale_cloud(17, offset_mm=offset_mm)
    want = _diameters_f64(verts)
    rel = np.abs(_port(verts, "gram") - want) / want
    assert rel.max() < GRAM_RTOL, (offset_mm, rel.max())


# -- the variant axis on the port's entry points ----------------------------

@pytest.fixture(scope="module")
def case():
    return synthetic.make_case((40, 30, 26), seed=5, spacing=(1.0, 0.8, 2.0))


@pytest.fixture(scope="module")
def jax_features(case):
    return JaxShapeFeatureExtractor(backend="ref").execute(*case)


@pytest.mark.parametrize("variant", ("auto",) + VARIANTS)
def test_extractor_variant_matches_jax_ref(case, jax_features, variant):
    feats = ShapeFeatureExtractor(device="cpu", diameter_variant=variant).execute(*case)
    for k in SHAPE_KEYS:
        np.testing.assert_allclose(feats[k], jax_features[k], rtol=1e-4, err_msg=k)
    assert feats["_n_mesh_vertices"] == jax_features["_n_mesh_vertices"]


def test_batched_variants_equal_seqacc_rows():
    cases = [synthetic.make_case(s, seed=seed) for s, seed in
             [((24, 20, 16), 1), ((28, 22, 18), 2), ((50, 24, 20), 2)]]
    base = np.stack(BatchedExtractor(device="cpu", variant="seqacc").run(cases)[0])
    for variant in ("auto",) + VARIANTS:
        rows = np.stack(BatchedExtractor(device="cpu", variant=variant).run(cases)[0])
        if variant == "gram":
            np.testing.assert_allclose(rows, base, rtol=1e-6)
        else:
            np.testing.assert_array_equal(rows, base, err_msg=variant)


def test_unknown_variant_raises():
    v, m = torch.zeros((4, 3)), torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown diameter variant"):
        diameter.max_diameters_sq(v, m, variant="bogus")
    with pytest.raises(ValueError, match="unknown diameter variant"):
        ref.max_diameters_sq(v, m, 256, "bogus")
    with pytest.raises(ValueError, match="unknown diameter variant"):
        ops.max_diameters(v, m, device="cpu", variant="bogus")
    with pytest.raises(ValueError, match="unknown diameter variant"):
        ShapeFeatureExtractor(device="cpu", diameter_variant="bogus")
    with pytest.raises(ValueError, match="unknown diameter variant"):
        BatchedExtractor(device="cpu", variant="bogus")
    with pytest.raises(ValueError, match="unknown diameter variant"):
        diameter.flop_estimate(512, 128, "bogus")


def test_tile_schedule_is_triu_indices():
    # the upper-triangle tiles of np.triu_indices, each once, in the colex
    # order (column by column) that makes a list's extent a prefix
    for nb in (1, 2, 5, 16):
        ij = ref.tile_schedule(nb).numpy()
        assert ref.tile_schedule(nb).dtype == torch.int32
        i, j = np.triu_indices(nb)
        order = np.lexsort((i, j))  # by column, then row
        np.testing.assert_array_equal(ij, np.stack([i[order], j[order]]))


def test_mask_stream_pads_false():
    m = torch.tensor([[True, False, True]])
    assert torch.equal(ref.diameter_mask_batch(m, 4), torch.tensor([[True, False, True, False]]))
    assert ref.diameter_mask_batch(m, 3).shape == (1, 3)


def test_work_estimates_follow_the_grids():
    m, block = 1000, 128  # nb = 8: 64 tiles, 36 in the triangle
    pairs_tri = 36 * block * block
    assert diameter.flop_estimate(m, block, "seqacc") == 14 * pairs_tri
    assert diameter.flop_estimate(m, block, "nomask") == 14 * pairs_tri
    # 'seqacc' and 'nomask' compute the k(k+1)/2 tiles of a list's extent
    # (k = ceil(extent / block)); 'tri_prefetch' the triangle's tiles of its
    # mask, as 'tri', whatever the extent
    for extent, k in ((1, 1), (128, 1), (129, 2), (700, 6), (1000, 8)):
        for v in ("seqacc", "nomask"):
            assert diameter.flop_estimate(m, block, v, extent=extent) == \
                14 * k * (k + 1) // 2 * block * block
            tiles = k * (k + 1) // 2
            assert diameter.bytes_estimate(m, block, v, extent=extent) == \
                tiles * (2 * block * 12 + 8 * (v == "nomask")) + 2 * 16 * tiles + 16 + 4
        assert diameter.flop_estimate(m, block, "tri_prefetch", extent=extent) == \
            diameter.flop_estimate(m, block, "tri_prefetch")
    # the masked tile kernels stage a tile's valid columns padded to their
    # unit: the last tile's 104 valid slots (the 24 padding slots are not)
    # as 112 (16 at block 128) or, for 'gram', 104 (8)
    staged = [block] * 7 + [112]
    full = block * sum(staged) * 8
    tri = block * sum((j + 1) * c for j, c in enumerate(staged))
    gram = block * sum((j + 1) * c for j, c in enumerate(staged[:7] + [104]))
    assert diameter.computed_pairs(m, block, "fused") == full
    assert diameter.flop_estimate(m, block, "fused") == 14 * full
    assert diameter.flop_estimate(m, block, "tri") == 14 * tri
    assert diameter.flop_estimate(m, block, "tri_prefetch") == 14 * tri
    assert diameter.flop_estimate(m, block, "naive") == 27 * full
    assert diameter.flop_estimate(m, block, "gram") == 11 * gram
    assert diameter.tensor_flop_estimate(m, block, "gram") == 24 * gram
    assert all(diameter.tensor_flop_estimate(m, block, v) == 0 for v in DIRECT)
    # the schedule, the mask stream and the full grid move more bytes; 'tri'
    # launches the whole grid but reads only its triangle
    b = {v: diameter.bytes_estimate(m, block, v) for v in VARIANTS}
    assert b["seqacc"] < b["nomask"] < b["tri_prefetch"] < b["tri"] < b["fused"] < b["naive"]
    assert b["naive"] == 4 * b["fused"]
