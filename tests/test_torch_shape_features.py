"""The port's single-case extractor on the CPU vs the JAX package's.

``ShapeFeatureExtractor(device='cpu')`` runs the plain PyTorch versions of
both kernels; every one of the 17 PyRadiomics features must agree with the
JAX extractor at the tolerance the reference holds between its own
backends (rtol 1e-4), and the mesh vertex count exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.shape_features import ShapeFeatureExtractor as JaxExtractor  # noqa: E402
from repro_torch.core import ShapeFeatureExtractor, StageTimes  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

from conftest import box_mask, sphere_mask  # noqa: E402

KEYS = [
    "MeshVolume", "VoxelVolume", "SurfaceArea", "SurfaceVolumeRatio",
    "Sphericity", "Compactness1", "Compactness2", "SphericalDisproportion",
    "Maximum3DDiameter", "Maximum2DDiameterSlice", "Maximum2DDiameterColumn",
    "Maximum2DDiameterRow", "MajorAxisLength", "MinorAxisLength",
    "LeastAxisLength", "Elongation", "Flatness",
]


def _case(name):
    if name == "make_case":
        return synthetic.make_case((48, 40, 36), seed=11)
    if name == "sphere":
        m = sphere_mask(26, 10.0).astype(bool)
        return m.astype(np.float32) * 100.0, m, (1.0, 1.0, 1.0)
    if name == "box":
        m = box_mask((40, 14, 8), (2, 2, 2), (38, 12, 6)).astype(bool)
        return m.astype(np.float32), m, (1.0, 1.0, 1.0)
    img, m, _ = synthetic.make_case((30, 28, 26), seed=4)
    return img, m, (2.0, 1.0, 0.5)


def _assert_features_match(ours, theirs):
    for k in KEYS:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, err_msg=k)
    assert ours["_n_mesh_vertices"] == theirs["_n_mesh_vertices"]


@pytest.mark.parametrize("name", ["make_case", "sphere", "box", "anisotropic"])
def test_cpu_matches_jax_ref(name):
    img, m, sp = _case(name)
    ours = ShapeFeatureExtractor(device="cpu").execute(img, m, sp)
    theirs = JaxExtractor(backend="ref").execute(img, m, sp)
    _assert_features_match(ours, theirs)


def test_cpu_matches_jax_interpret():
    img, m, sp = synthetic.make_case((24, 20, 16), seed=3)
    ours = ShapeFeatureExtractor(device="cpu").execute(img, m, sp)
    theirs = JaxExtractor(backend="interpret").execute(img, m, sp)
    _assert_features_match(ours, theirs)


def test_prune_off_gives_the_same_features():
    img, m, sp = _case("make_case")
    a = ShapeFeatureExtractor(device="cpu").execute(img, m, sp)
    b = ShapeFeatureExtractor(device="cpu", prune=False).execute(img, m, sp)
    for k in KEYS:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)


def test_stage_times_reported():
    img, m, sp = _case("make_case")
    feats, times = ShapeFeatureExtractor(device="cpu").execute(img, m, sp, with_times=True)
    assert isinstance(times, StageTimes)
    assert times.preprocess_ms > 0 and times.transfer_ms > 0
    assert times.mesh_ms > 0 and times.diameter_ms > 0
    assert times.total_ms == pytest.approx(
        times.preprocess_ms + times.transfer_ms + times.mesh_ms + times.diameter_ms)
    assert set(KEYS) <= set(feats)


def test_sphere_features_are_analytic():
    f = ShapeFeatureExtractor(device="cpu").execute(*_case("sphere"))
    assert abs(f["MeshVolume"] / (4 / 3 * np.pi * 10.0 ** 3) - 1) < 0.02
    assert abs(f["Maximum3DDiameter"] - 21.0) < 1.0
    assert abs(f["Elongation"] - 1.0) < 0.05


def test_empty_mask_raises():
    with pytest.raises(ValueError):
        ShapeFeatureExtractor(device="cpu").execute(np.zeros((5, 5, 5)), np.zeros((5, 5, 5), bool))
