"""The port's plan layer (``repro_torch.core.plan``) against the JAX package's.

The plan is pure Python over case metadata, so every function must give
exactly the reference's result: buckets, hints, groups, censuses and the
row layout.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import plan as jax_plan
from repro_torch.core import plan

SHAPES = [(1, 1, 1), (10, 14, 12), (30, 31, 32), (33, 64, 65), (228, 84, 141), (5, 300, 7)]
SPACINGS = [None, (1.0, 1.0, 1.0), (2.0, 1.0, 0.5), (0.8, 0.8, 3.0), (0.7031, 0.7031, 2.5)]


def _metas(seed: int, n: int = 24):
    """Random per-case metadata (some empty) as (port, reference) CaseMetas."""
    rng = np.random.default_rng(seed)
    ours, theirs = [], []
    for _ in range(n):
        if rng.random() < 0.15:
            args = (None, None, 0, 0)
        else:
            roi = tuple(int(x) for x in rng.integers(3, 90, size=3))
            nv = int(rng.integers(8, 200_000))
            args = (plan.shape_bucket(tuple(s - 2 for s in roi)), roi,
                    plan.vertex_bucket(nv), nv)
        intensity = bool(rng.random() < 0.3)
        ours.append(plan.CaseMeta(*args, intensity=intensity))
        theirs.append(jax_plan.CaseMeta(*args, intensity=intensity))
    return ours, theirs


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 94_466, 225_496, 2 ** 20 + 1])
def test_vertex_and_static_buckets_equal_reference(n):
    assert plan.vertex_bucket(n) == jax_plan.vertex_bucket(n)
    assert plan.static_bucket(plan.vertex_bucket(n)) == jax_plan.static_bucket(
        jax_plan.vertex_bucket(n))
    assert plan.MIN_VERTEX_BUCKET == jax_plan.MIN_VERTEX_BUCKET


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("spacing", SPACINGS)
def test_shape_bucket_and_vertex_hint_equal_reference(shape, spacing):
    assert plan.shape_bucket(shape) == jax_plan.shape_bucket(shape)
    assert plan.shape_bucket(shape, step=16) == jax_plan.shape_bucket(shape, step=16)
    assert plan.vertex_hint(shape, spacing) == jax_plan.vertex_hint(shape, spacing)
    ours = plan.assign_bucket(shape, spacing=spacing)
    theirs = jax_plan.assign_bucket(shape, spacing=spacing)
    assert (ours.shape, ours.vertex_cap) == (theirs.shape, theirs.vertex_cap)


def test_group_indices_equal_reference():
    keys = [3, None, "a", 3, ("orig", 512), "a", None, 3, ("orig", 512)]
    assert plan.group_indices(keys) == jax_plan.group_indices(keys)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("schedule", ["counted", "static"])
def test_build_plan_equals_reference(seed, schedule):
    ours, theirs = _metas(seed)
    p, q = plan.build_plan(ours, schedule), jax_plan.build_plan(theirs, schedule)
    assert p.shape_groups == q.shape_groups
    assert p.cap_groups == q.cap_groups
    assert p.static_targets == q.static_targets
    assert p.families == q.families
    assert p.n_cases == q.n_cases
    assert ({(b.shape, b.vertex_cap): v for b, v in p.fused_groups.items()}
            == {(b.shape, b.vertex_cap): v for b, v in q.fused_groups.items()})
    assert p.stats() == q.stats()
    assert ([dataclasses.astuple(w) for w in p.work_census()]
            == [dataclasses.astuple(w) for w in q.work_census()])
    assert [plan.meta_bytes(m) for m in ours] == [jax_plan.meta_bytes(m) for m in theirs]


@pytest.mark.parametrize("seed", [0, 1])
def test_window_census_equals_reference(seed):
    ours, theirs = _metas(seed)
    c, d = plan.WindowCensus(), jax_plan.WindowCensus()
    for m, n in zip(ours, theirs):
        assert c.fragments(m) == d.fragments(n)
        c.add(m)
        d.add(n)
        assert (c.shape_depths, c.cap_depths, c.cases, c.bytes) == (
            d.shape_depths, d.cap_depths, d.cases, d.bytes)


def test_plan_from_metadata_equals_reference():
    spacings = [SPACINGS[i % len(SPACINGS)] for i in range(len(SHAPES))]
    p = plan.plan_from_metadata(SHAPES, spacings)
    q = jax_plan.plan_from_metadata(SHAPES, spacings)
    assert [dataclasses.astuple(m) for m in p.metas] == [dataclasses.astuple(m) for m in q.metas]
    assert p.stats() == q.stats()


@pytest.mark.parametrize("families", [None, "shape", ("glcm", "shape"),
                                      ("firstorder", "glcm", "shape"), "glcm"])
def test_family_layout_equals_reference(families):
    assert plan.resolve_families(families) == jax_plan.resolve_families(families)
    assert plan.row_width(families) == jax_plan.row_width(families)
    assert plan.family_slices(families) == jax_plan.family_slices(families)
    assert plan.feature_names(families) == jax_plan.feature_names(families)
    assert plan.needs_intensity(families) == jax_plan.needs_intensity(families)


def test_registry_and_constants_equal_reference():
    assert {k: dataclasses.astuple(v) for k, v in plan.FAMILIES.items()} == {
        k: dataclasses.astuple(v) for k, v in jax_plan.FAMILIES.items()}
    assert plan.DEFAULT_FAMILIES == jax_plan.DEFAULT_FAMILIES
    assert plan.WORK_KINDS == jax_plan.WORK_KINDS
    assert plan.SCHEDULES == jax_plan.SCHEDULES


@pytest.mark.parametrize("bad", [(), ("shape", "texture"), "nope"])
def test_bad_family_requests_raise_like_reference(bad):
    with pytest.raises(ValueError):
        jax_plan.resolve_families(bad)
    with pytest.raises(ValueError):
        plan.resolve_families(bad)


def test_bad_schedule_raises():
    with pytest.raises(ValueError):
        plan.build_plan([], "auto")
