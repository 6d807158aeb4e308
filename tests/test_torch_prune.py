"""Exact candidate pruning: the port's keep masks vs the JAX package's.

The keep mask decides which vertices reach the pair sweep, so it must be
the reference's exactly; the pruned diameters must equal the unpruned.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import prune as jax_prune  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ops, prune, ref  # noqa: E402
from repro_torch.core.shape_features import crop_to_roi  # noqa: E402

from conftest import sphere_mask  # noqa: E402


def _mesh_vertices(mask, spacing=(1.0, 1.0, 1.0)):
    """Unpruned (verts, mask) of a case, as the extractor builds them."""
    _, m, _ = crop_to_roi(mask.astype(np.float32), mask)
    f = ref.vertex_fields(torch.from_numpy(m), 0.5, spacing)
    n = int(ref.count_vertices(f))
    verts, vmask, _ = ref.compact_vertices(f, ops.vertex_bucket(n))
    return verts.numpy(), vmask.numpy()


def _cases():
    _, m1, sp1 = synthetic.make_case((48, 40, 36), seed=11)
    _, m2, _ = synthetic.make_case((39, 33, 11), seed=19)
    rng = np.random.default_rng(5)
    cloud = (rng.normal(size=(1500, 3)) * [30.0, 12.0, 5.0]).astype(np.float32)
    cloud_mask = rng.random(1500) < 0.9
    return {
        "make_case_48x40x36": _mesh_vertices(m1, sp1),
        "make_case_39x33x11_aniso": _mesh_vertices(m2, (2.0, 1.0, 0.5)),
        "sphere": _mesh_vertices(sphere_mask(22, 8.0).astype(bool)),
        "gaussian_cloud": (cloud, cloud_mask),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_keep_mask_equals_reference(name):
    verts, mask = CASES[name]
    keep, lower = prune.candidate_keep_mask(torch.from_numpy(verts), torch.from_numpy(mask))
    jkeep, jlower = jax_prune.candidate_keep_mask(verts, mask)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(lower.numpy(), np.asarray(jlower), rtol=1e-6)
    assert 2 <= int(keep.sum()) < int(mask.sum())


@pytest.mark.parametrize("name", sorted(CASES))
def test_prune_candidates_equals_reference(name):
    verts, mask = CASES[name]
    v2, m2, info = ops.prune_candidates(torch.from_numpy(verts), torch.from_numpy(mask))
    jv2, jm2, jinfo = jax_ops.prune_candidates(verts, mask)
    assert dataclasses.astuple(info) == dataclasses.astuple(jinfo)
    np.testing.assert_array_equal(v2, jv2)
    np.testing.assert_array_equal(m2, jm2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pruned_diameters_equal_unpruned(name):
    verts, mask = CASES[name]
    full = ref.max_diameters_sq(torch.from_numpy(verts), torch.from_numpy(mask))
    v2, m2, info = ops.prune_candidates(torch.from_numpy(verts), torch.from_numpy(mask))
    pruned = ref.max_diameters_sq(torch.from_numpy(v2), torch.from_numpy(m2))
    np.testing.assert_allclose(pruned.numpy(), full.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.sqrt(full.numpy()),
                               np.asarray(jax_ref.max_diameters(verts, mask)), rtol=1e-5)


def test_degenerate_inputs_keep_originals():
    verts = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0], [5.0, 5.0, 5.0]], np.float32)
    for mask in (np.array([True, False, False]), np.array([True, True, True])):
        v2, m2, info = ops.prune_candidates(torch.from_numpy(verts), torch.from_numpy(mask))
        assert not info.pruned and info.m_kept == info.m_valid == int(mask.sum())
        np.testing.assert_array_equal(v2, verts)
        np.testing.assert_array_equal(m2, mask)
