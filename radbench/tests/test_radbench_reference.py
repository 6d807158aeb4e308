"""The plain reference against closed forms, brute force and hand counts,
and the case generator's determinism."""
import math

import numpy as np
import pytest
import torch

from radbench import cases as caselib
from radbench.reference import features as ref


def ellipsoid(shape, axes):
    """Voxel centres within the ellipsoid of semi-axes ``axes`` about the
    volume's centre."""
    g = [np.arange(n) - (n - 1) / 2 for n in shape]
    x, y, z = np.meshgrid(*g, indexing="ij")
    a, b, c = axes
    return (x / a) ** 2 + (y / b) ** 2 + (z / c) ** 2 <= 1.0


def shape_row(mask):
    _, mc = ref.roi_crop(None, torch.as_tensor(mask))
    vol, area = ref.mesh(mc, (1.0, 1.0, 1.0))
    d = ref.max_diameters(ref.vertices(mc, (1.0, 1.0, 1.0)))
    return float(vol), float(area), d.tolist()


def thomsen_area(a, b, c, p=1.6075):
    """Knud Thomsen's ellipsoid area (within 1.061% of the true one)."""
    return 4 * math.pi * (((a * b) ** p + (a * c) ** p + (b * c) ** p) / 3) ** (1 / p)


@pytest.mark.parametrize("axes", [(10.0, 10.0, 10.0), (14.0, 9.0, 6.0)])
def test_voxelised_ellipsoid_against_closed_forms(axes):
    # Tolerances: a binary mask's mesh cuts each voxel-face corner, so the
    # volume is within 1% of the solid's at these radii and the area
    # (a staircase surface) over it by at most 12%; each diameter spans the
    # extreme voxel centres plus the half voxel to each crossing, so it is
    # within one voxel of the solid's.
    a, b, c = axes
    mask = ellipsoid((32, 24, 20), axes)
    vol, area, (d3, dxy, dxz, dyz) = shape_row(mask)
    assert vol == pytest.approx(4 / 3 * math.pi * a * b * c, rel=0.01)
    true_area = thomsen_area(a, b, c)
    assert true_area * 0.98 <= area <= true_area * 1.12
    assert abs(d3 - 2 * a) <= 1.0
    assert abs(dxy - 2 * a) <= 1.0
    assert abs(dxz - 2 * a) <= 1.0
    assert abs(dyz - 2 * b) <= 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pruned_diameters_equal_brute_force(seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((14, 12, 10), bool)
    for _ in range(3):
        c = rng.uniform(3, 9, 3)
        r = rng.uniform(2, 5, 3)
        g = np.meshgrid(*(np.arange(n) for n in mask.shape), indexing="ij")
        mask |= sum(((g[k] - c[k]) / r[k]) ** 2 for k in range(3)) <= 1.0
    _, mc = ref.roi_crop(None, torch.as_tensor(mask))
    v = ref.vertices(mc, (1.0, 0.8, 1.5))
    assert torch.equal(ref.max_diameters(v), ref.max_diameters(v, prune=False))


def test_pruning_keeps_the_ends_of_a_sphere():
    # a sphere is the bound's worst case: every surface point is nearly an end
    _, mc = ref.roi_crop(None, torch.as_tensor(ellipsoid((16, 16, 16), (6.0, 6.0, 6.0))))
    v = ref.vertices(mc, (1.0, 1.0, 1.0))
    assert torch.equal(ref.max_diameters(v), ref.max_diameters(v, prune=False))


def test_direction_sets_cover_the_sphere():
    torch.manual_seed(0)
    for dim in (2, 3):
        dirs, cos_theta = ref.directions(dim, torch.float64, "cpu")
        w = torch.nn.functional.normalize(torch.randn(20000, dim, dtype=torch.float64), dim=1)
        assert float((w @ dirs.T).amax(1).min()) >= cos_theta


def test_firstorder_on_a_hand_checked_array():
    img = torch.zeros(4, 4, 4)
    m = torch.zeros(4, 4, 4, dtype=torch.bool)
    img[1:3, 1:3, 1:3] = torch.arange(1, 9, dtype=torch.float32).reshape(2, 2, 2)
    m[1:3, 1:3, 1:3] = True
    got = ref.firstorder(img, m, n_bins=4).tolist()
    # bins of width 1.75 from 1: [1, 2] [3, 4] [5, 6] [7, 8]; centres 1.875 + 1.75 k
    want = [4.5, math.sqrt(5.25), 1.0, 8.0, 1.875, 3.625, 7.125, 204.0, 2.0]
    assert got == pytest.approx(want, rel=1e-12)


def test_glcm_on_a_hand_checked_array():
    img = torch.tensor([0.0, 1.0, 1.0, 0.0]).reshape(4, 1, 1)
    m = torch.ones(4, 1, 1, dtype=torch.bool)
    g, pairs = ref.glcm_counts(img, m, n_bins=2)
    assert g.tolist() == [[0, 2], [2, 2]] and pairs == 3
    contrast, corr, idm, energy = ref.glcm(img, m, n_bins=2).tolist()
    assert contrast == pytest.approx(2 / 3)
    assert corr == pytest.approx(-0.5)
    assert idm == pytest.approx(2 / 3)
    assert energy == pytest.approx(1 / 3)


def test_case_features_rows():
    mask = ellipsoid((20, 16, 12), (7.0, 5.0, 4.0))
    image = np.where(mask, 100.0, 40.0).astype(np.float32)
    out = ref.case_features(image, mask, np.ones(3, np.float32),
                            ("shape", "firstorder", "glcm"))
    assert out["shape"].shape == (6,) and out["firstorder"].shape == (9,)
    assert out["glcm"].shape == (4,)
    assert out["firstorder"][0] == pytest.approx(100.0)  # a constant ROI
    assert out["glcm"][1] == 1.0  # one gray level: correlation 1


def test_generator_is_deterministic_per_seed():
    dims = ((20, 18, 12), (16, 14, 10))
    a = caselib.build_pool(2**31 + 7, dims, 2, device="cpu")
    b = caselib.build_pool(2**31 + 7, dims, 2, device="cpu")
    c = caselib.build_pool(2**31 + 8, dims, 2, device="cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x.image, y.image) and np.array_equal(x.mask, y.mask)
        assert x.bbox == y.bbox
    assert any(not np.array_equal(x.image, z.image) for x, z in zip(a, c))
    for case in a:
        assert case.mask.dtype == bool and case.image.dtype == np.float32
        assert case.mask.shape == case.dims and case.mask.any()


def test_every_seed_gets_the_same_sizes():
    # the size and extent scalars come from the fixed seed: only the wobble differs
    dims = ((24, 20, 16),)
    a = caselib.build_pool(3, dims, 3, device="cpu")
    b = caselib.build_pool(4, dims, 3, device="cpu")
    for x, y in zip(a, b):
        assert abs(int(x.mask.sum()) - int(y.mask.sum())) <= 0.2 * int(x.mask.sum())
