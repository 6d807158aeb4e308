"""Plan layer: static extraction plans built from case metadata alone.

The port's own copy of ``repro.core.plan`` (pure Python, no device data).
The batched pipeline's planning decisions -- shape buckets, vertex-cap
groups, the pass-2b compaction targets -- are pure functions of per-case
*metadata* (ROI shape, spacing, vertex count).  An :class:`ExtractionPlan`
describes one window's launches without touching a tensor, and
``core/executor`` runs it.  ``tests/test_torch_plan.py`` holds every
function here equal to the reference's.

Two pass-2b bucket schedules are planned:

``schedule='counted'`` (default, the one the port's executor runs)
    Pass 1 fetches the per-case survivor counts ``(m_valid, m_kept)`` and
    re-buckets each case into ``vertex_bucket(m_kept)`` -- the tightest
    pad, at the cost of ONE host sync per cap group between pass 1 and
    pass 2b.

``schedule='static'``
    Every cap group's pass-2b target is fixed up front by
    :func:`static_bucket`, the next power of two below the cap.  For a
    power-of-two cap, ``vertex_bucket(m_kept) < cap`` iff
    ``m_kept <= cap // 2``, so the target is exactly the counted
    schedule's re-bucketing boundary and pass 1 needs no count fetch.

The metadata-only vertex-count hint (:func:`vertex_hint`) is spacing-aware
(anisotropic volumes cut more voxel planes per unit of physical surface),
memoised per ROI shape, and capped at the volume's total edge count.

The feature-family registry (:data:`FAMILIES`) fixes the feature-row
layout: :func:`row_width` and :func:`family_slices` are its single source,
so the quarantine NaN row and every collector concatenation derive from
it rather than from a hardcoded width.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

MIN_VERTEX_BUCKET = 512  # the vertex_bucket ladder floor


def vertex_bucket(n: int, minimum: int = MIN_VERTEX_BUCKET) -> int:
    """Power-of-two padding cap for a vertex count (floor ``minimum``).

    The single source of the M-bucket ladder; ``kernels.ops`` re-exports
    it for the kernel-side callers.
    """
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class Bucket:
    """Static launch key: padded shape + vertex cap."""

    shape: tuple[int, int, int]
    vertex_cap: int


def _bucket_dim(n: int, step: int = 32) -> int:
    return max(step, int(math.ceil(n / step)) * step)


def shape_bucket(mask_shape, step: int = 32) -> tuple[int, int, int]:
    """Padded shape bucket for an ROI shape (one batched launch per bucket)."""
    return tuple(_bucket_dim(s + 2, step) for s in mask_shape)


@functools.lru_cache(maxsize=4096)
def _vertex_hint(shape: tuple, spacing: tuple | None) -> int:
    n = 1
    edges = 3
    for s in shape:
        n *= int(s)
        edges *= int(s) + 2
    # ~12 active edges per surface cell; surface cells ~ N^(2/3) for a
    # compact ROI filling a constant fraction of its bounding box
    hint = float(n) ** (2.0 / 3.0) * 12.0
    if spacing is not None:
        # anisotropic spacing: a physical surface patch crosses more voxel
        # planes along the finely-sampled axes.  Scale by the mean
        # per-orientation cell-face density normalised to the isotropic
        # equivalent (AM-GM: >= 1, == 1 for isotropic spacing).
        sx, sy, sz = (float(s) for s in spacing)
        iso2 = (sx * sy * sz) ** (2.0 / 3.0)
        hint *= iso2 * (1.0 / (sy * sz) + 1.0 / (sx * sz) + 1.0 / (sx * sy)) / 3.0
    # a mesh cannot have more vertices than the volume has grid edges
    # (~3 per voxel of the +2-padded field)
    return int(min(hint, edges))


def vertex_hint(mask_shape, spacing=None) -> int:
    """Conservative, memoised active-edge estimate for an ROI shape.

    Sizes the caps of a plan built before the real vertex count exists
    (and of the one-pass ``prune=False`` path); spacing-aware and capped
    at the volume's total edge count.
    """
    sp = None if spacing is None else tuple(round(float(s), 6) for s in spacing)
    return _vertex_hint(tuple(int(s) for s in mask_shape), sp)


def assign_bucket(mask_shape, n_vertices_hint=None, step: int = 32,
                  spacing=None) -> Bucket:
    """(shape bucket, vertex cap) for an ROI shape; the hint defaults to
    :func:`vertex_hint`."""
    if n_vertices_hint is None:
        n_vertices_hint = vertex_hint(mask_shape, spacing)
    return Bucket(shape_bucket(mask_shape, step), vertex_bucket(n_vertices_hint))


def static_bucket(cap: int, minimum: int = MIN_VERTEX_BUCKET) -> int | None:
    """Static pass-2b target for a cap group: next power of two below it.

    ``None`` when no shrink is possible (the cap is at the bucket floor).
    """
    t = cap // 2
    return t if t >= minimum else None


def group_indices(keys: Sequence) -> dict:
    """Partition ``range(len(keys))`` by key, preserving input order.

    Every index lands in exactly one group; ``None`` keys (degenerate
    cases) join no group.
    """
    groups: dict = {}
    for i, k in enumerate(keys):
        if k is not None:
            groups.setdefault(k, []).append(i)
    return groups


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """Everything the planner and executor need to schedule one feature family.

    ``features`` fixes the family's feature-row columns (and width);
    ``needs_intensity`` says whether prep must stage the intensity volume;
    ``cache_ns`` names the family's kernel-configuration namespace.
    """

    name: str
    features: tuple
    needs_intensity: bool
    cache_ns: str

    @property
    def n_features(self) -> int:
        return len(self.features)


#: Registry order is canonical row order: shape columns precede
#: first-order columns precede GLCM columns in a multi-family row.
FAMILIES: dict = {
    "shape": FamilySpec(
        name="shape",
        features=(
            "MeshVolume", "SurfaceArea", "Maximum3DDiameter",
            "Maximum2DDiameterSlice", "Maximum2DDiameterRow",
            "Maximum2DDiameterColumn", "n_vertices",
        ),
        needs_intensity=False,
        cache_ns="diameter",
    ),
    "firstorder": FamilySpec(
        name="firstorder",
        features=(
            "Mean", "StdDev", "Minimum", "Maximum", "Percentile10",
            "Median", "Percentile90", "Energy", "Entropy",
        ),
        needs_intensity=True,
        cache_ns="firstorder",
    ),
    "glcm": FamilySpec(
        name="glcm",
        features=("Contrast", "Correlation", "Idm", "JointEnergy"),
        needs_intensity=True,
        cache_ns="glcm",
    ),
}

DEFAULT_FAMILIES = ("shape",)


def resolve_families(families=None) -> tuple:
    """Validate a family request and return it in canonical registry order."""
    if families is None:
        return DEFAULT_FAMILIES
    if isinstance(families, str):
        families = (families,)
    requested = set()
    for f in families:
        if f not in FAMILIES:
            raise ValueError(
                f"unknown feature family {f!r}; registered families: "
                f"{tuple(FAMILIES)}"
            )
        requested.add(f)
    if not requested:
        raise ValueError("at least one feature family is required")
    return tuple(f for f in FAMILIES if f in requested)


def row_width(families=DEFAULT_FAMILIES) -> int:
    """Total feature-row width for a family request."""
    return sum(FAMILIES[f].n_features for f in resolve_families(families))


def family_slices(families=DEFAULT_FAMILIES) -> dict:
    """``{family: slice}`` giving each family's columns in the row."""
    slices, offset = {}, 0
    for f in resolve_families(families):
        n = FAMILIES[f].n_features
        slices[f] = slice(offset, offset + n)
        offset += n
    return slices


def feature_names(families=DEFAULT_FAMILIES) -> tuple:
    """Feature-row column names, in row order, for a family request."""
    return tuple(
        name for f in resolve_families(families) for name in FAMILIES[f].features
    )


def needs_intensity(families=DEFAULT_FAMILIES) -> bool:
    """Does any requested family consume the intensity volume?"""
    return any(FAMILIES[f].needs_intensity for f in resolve_families(families))


@dataclasses.dataclass(frozen=True)
class CaseMeta:
    """Per-case planning metadata (no device data).

    ``shape`` is the padded shape bucket (``None`` marks an empty-mask
    case: it takes part in no pass and yields a zero feature row);
    ``roi_shape`` the cropped-ROI shape before bucket padding;
    ``vertex_cap`` the pass-1 compaction cap; ``n_vertices`` the dedup
    vertex count (measured, or a :func:`vertex_hint`); ``intensity``
    whether the case stages an intensity volume beside its mask.
    """

    shape: tuple | None
    roi_shape: tuple | None
    vertex_cap: int
    n_vertices: int
    intensity: bool = False

    @property
    def empty(self) -> bool:
        return self.shape is None


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One planned kernel launch, described structurally (no device data).

    ``m`` is the launch's vertex bucket (pass-1 input cap for prune and
    compaction, the sweep bucket for the diameter item); ``cap`` the
    compaction OUTPUT bucket (compaction items only); ``shape`` the
    padded volume bucket (MC and intensity-family items only).
    """

    kind: str
    depth: int
    m: int | None = None
    cap: int | None = None
    shape: tuple | None = None


#: WorkItem kinds, one per launch family the executor dispatches.
WORK_KINDS = ("prune", "compact", "diameter", "mc", "firstorder", "glcm")


@dataclasses.dataclass(frozen=True)
class ExtractionPlan:
    """Fully static execution plan for one window of cases.

    ``shape_groups`` keys pass 2a (one batched MC launch per padded
    shape), ``cap_groups`` keys pass 1 (one bound + compaction chain per
    vertex cap), ``static_targets`` maps each cap group to its pass-2b
    bucket under the static schedule (empty under the counted schedule,
    whose targets come from the fetched survivor counts).  ``families``
    is the resolved feature-family tuple.
    """

    schedule: str
    metas: tuple
    shape_groups: dict
    cap_groups: dict
    static_targets: dict
    families: tuple = DEFAULT_FAMILIES

    @property
    def n_cases(self) -> int:
        return len(self.metas)

    @property
    def fused_groups(self) -> dict:
        """(shape, cap) ``Bucket`` grouping for the one-pass path."""
        return group_indices(
            [None if m.empty else Bucket(m.shape, m.vertex_cap)
             for m in self.metas]
        )

    def work_census(self) -> tuple:
        """Every kernel launch this plan implies, as :class:`WorkItem` rows.

        One MC item per shape group (plus one per requested intensity
        family), a prune + compaction item per cap group, and one diameter
        item per cap group: at the static target under the static
        schedule, at the pre-compaction cap (an upper bound) under the
        counted one.
        """
        items = []
        for shape, idxs in self.shape_groups.items():
            if shape is None:
                continue
            depth = len(idxs)
            items.append(WorkItem(kind="mc", depth=depth, shape=shape))
            for fam in self.families:
                if FAMILIES[fam].needs_intensity:
                    items.append(WorkItem(kind=fam, depth=depth, shape=shape))
        for cap, idxs in self.cap_groups.items():
            depth = len(idxs)
            target = self.static_targets.get(cap) or cap
            items.append(WorkItem(kind="prune", depth=depth, m=cap))
            items.append(WorkItem(kind="compact", depth=depth, m=cap,
                                  cap=target))
            sweep = target if self.schedule == "static" else cap
            items.append(WorkItem(kind="diameter", depth=depth, m=sweep))
        return tuple(items)

    def stats(self) -> dict:
        """Plan-level stats: bucket counts + pad-waste fractions."""
        roi_vox = pad_vox = 0
        n_verts = cap_slots = 0
        for m in self.metas:
            if m.empty:
                continue
            roi_vox += math.prod(m.roi_shape)
            pad_vox += math.prod(m.shape)
            n_verts += m.n_vertices
            cap_slots += m.vertex_cap
        return {
            "schedule": self.schedule,
            "families": list(self.families),
            "cases": self.n_cases,
            "empty_cases": sum(1 for m in self.metas if m.empty),
            "shape_buckets": len(self.shape_groups),
            "cap_buckets": len(self.cap_groups),
            "mask_pad_waste": 1.0 - roi_vox / pad_vox if pad_vox else 0.0,
            "vertex_pad_waste": 1.0 - n_verts / cap_slots if cap_slots else 0.0,
        }


def meta_bytes(meta: CaseMeta) -> int:
    """Device footprint of one planned case: staged mask + vertex stacks.

    f32 mask at the padded shape bucket (doubled with an intensity
    volume), plus the (cap, 3) vertex coordinates and (cap,) mask.
    """
    if meta.empty:
        return 0
    vox = 4 * math.prod(meta.shape)
    if meta.intensity:
        vox *= 2
    return vox + 16 * meta.vertex_cap


@dataclasses.dataclass
class WindowCensus:
    """Incremental bucket census of an open streaming window.

    Updated case by case, so a close-early decision reads group depths
    and the memory footprint in O(1) per case.  Metadata only.
    """

    shape_depths: dict = dataclasses.field(default_factory=dict)
    cap_depths: dict = dataclasses.field(default_factory=dict)
    cases: int = 0
    bytes: int = 0

    def add(self, meta: CaseMeta) -> None:
        self.cases += 1
        self.bytes += meta_bytes(meta)
        if meta.empty:
            return  # empty cases join no pass group
        self.shape_depths[meta.shape] = self.shape_depths.get(meta.shape, 0) + 1
        self.cap_depths[meta.vertex_cap] = (
            self.cap_depths.get(meta.vertex_cap, 0) + 1
        )

    def fragments(self, meta: CaseMeta) -> bool:
        """Would admitting ``meta`` open a NEW shape or cap sub-batch?"""
        if meta.empty:
            return False
        return (meta.shape not in self.shape_depths
                or meta.vertex_cap not in self.cap_depths)


SCHEDULES = ("counted", "static")


def build_plan(metas: Sequence[CaseMeta], schedule: str = "counted",
               families=DEFAULT_FAMILIES) -> ExtractionPlan:
    """Build the static plan for one window from case metadata alone."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    metas = tuple(metas)
    cap_groups = group_indices([None if m.empty else m.vertex_cap for m in metas])
    return ExtractionPlan(
        schedule=schedule,
        metas=metas,
        shape_groups=group_indices([m.shape for m in metas]),
        cap_groups=cap_groups,
        static_targets=(
            {cap: static_bucket(cap) for cap in cap_groups}
            if schedule == "static" else {}
        ),
        families=resolve_families(families),
    )


def plan_from_metadata(case_shapes, spacings=None, schedule: str = "counted") -> ExtractionPlan:
    """Metadata-only plan: caps come from :func:`vertex_hint`, not counts."""
    metas = []
    for i, shp in enumerate(case_shapes):
        sp = None if spacings is None else spacings[i]
        shp = tuple(int(s) for s in shp)
        hint = vertex_hint(shp, sp)
        metas.append(
            CaseMeta(
                shape=shape_bucket(shp),
                roi_shape=tuple(s + 2 for s in shp),
                vertex_cap=vertex_bucket(hint),
                n_vertices=hint,
            )
        )
    return build_plan(metas, schedule)
