"""Roofline pricing: plan work items -> (FP32 operations, bytes) -> microseconds.

Counterpart of the model half of ``repro.runtime.roofline``.  The cost
model (``runtime/costmodel``) needs a price for a launch that no autotune
sweep has measured; this module gives one as the roofline bound

    time = max(operations / peak FP32 rate, bytes / memory bandwidth)

under a hardware profile (``runtime/autotune.get_hw_profile``: the card's
probe, or the H100 SXM data sheet's figures when probing is off).  It is a
lower bound on the wall time; the decisions read only ratios of it.

The work of each kind is counted from the port's own kernels, not fitted
to a compiler's cost analysis:

* **diameter**: ``kernels/diameter.flop_estimate`` and ``bytes_estimate``
  of the ``seqacc`` sweep at the default block, over the list's extent
  (the valid prefix the sweep visits) or, without one, its whole bucket;
* **MC, compaction, first-order, GLCM, the masked range**: the byte and
  operation counts behind the bounds ``chip_smoke.py`` prints for each
  kernel (the ``*_work`` functions below, which it calls on the measured
  inputs); from plan metadata alone the data-dependent terms (triangles,
  masked voxels, survivors) take the most the launch could need;
* **prune**: the plain-torch pruning bound (``kernels/prune.py``), one
  pass over each slot.

Each ``*_work`` and ``*_cost`` function returns ``(operations, bytes)``.
"""
from __future__ import annotations

import math

from repro_torch.core import plan as planlib
from repro_torch.kernels import diameter as _diam
from repro_torch.kernels import firstorder as _fo

# FP32 operations counted from the kernels' sources.
# csrc/marching_cubes.cu: 8 compares per cell; per triangle 3 vertices x 12
# (interpolation and position) + 23 (area) + 16 (signed volume)
MC_OPS_PER_CELL = 8
MC_OPS_PER_TRIANGLE = 75
# csrc/diameter.cu: per pair 3 sub, 3 mul, 4 add, 4 max
DIAM_OPS_PER_PAIR = 14
# csrc/quantize.cuh: quantising a masked voxel is 5 (sub, div, floor, max,
# min); first-order adds a square and two additions per masked voxel
# (firstorder.cu), GLCM per pair a neighbour compare and the neighbour's
# quantisation (glcm.cu); every function compares each voxel's mask once
QUANT_OPS = 5
FO_OPS_PER_MASKED = 3 + QUANT_OPS
GLCM_OPS_PER_PAIR = 1 + QUANT_OPS
# csrc/masked_range.cu: a min and a max per masked voxel
RANGE_OPS_PER_MASKED = 2
# kernels/prune.py, per slot and combo: the k projections (3 mul, 2 add
# each), the 8 corner distances (8 each) and their max (7), the centre
# distance and bound (14)
PRUNE_OPS_PER_SLOT_COMBO_FIXED = 85
PRUNE_COMBOS = 4


# ---------------------------------------------------------------------------
# work of one launch on its real inputs (chip_smoke.py's bounds)
# ---------------------------------------------------------------------------

def mc_work(voxels: int, cells: int, triangles: int, batch: int) -> tuple[float, float]:
    """Marching cubes over ``batch`` volumes of ``voxels`` float32 voxels in
    all: each voxel read once and a (volume, area) pair written per case;
    the compares of every cell and the arithmetic of every triangle."""
    return (float(MC_OPS_PER_CELL * cells + MC_OPS_PER_TRIANGLE * triangles),
            float(4 * voxels + 8 * batch))


def diameter_work(slots: int, lists: int, pairs: int) -> tuple[float, float]:
    """The four-combo pair sweep over ``lists`` lists of ``slots`` slots in
    all: 13 bytes a slot (float32 xyz and a mask byte) and 16 a result; 14
    FP32 operations a pair of valid vertices."""
    return float(DIAM_OPS_PER_PAIR * pairs), float(13 * slots + 16 * lists)


def compact_work(batch: int, m: int, cap: int, survivors: int) -> tuple[float, float]:
    """Stable compaction of ``batch`` lists of ``m`` slots into ``cap``:
    every keep flag, the ``survivors`` read below the cap (12 bytes each),
    every output slot and mask byte, the counts.  No arithmetic."""
    return 0.0, float(batch * m + 12 * survivors + 13 * batch * cap + 4 * batch)


def masked_range_work(voxels: int, masked: int, batch: int) -> tuple[float, float]:
    """The masked ``(lo, hi)`` of ``batch`` images: every mask value, the
    image at the masked voxels, the (2, B) output."""
    return (float(voxels + RANGE_OPS_PER_MASKED * masked),
            float(4 * voxels + 4 * masked + 8 * batch))


def intensity_work(family: str, batch: int, voxels: int, masked: int, pairs: int,
                   n_bins: int = _fo.N_BINS) -> tuple[float, float]:
    """First-order or GLCM over ``batch`` volumes (``voxels`` in all): the
    float32 mask at every voxel, the image at the masked voxels only, the
    (B,) range vectors and the output rows, each once; the operations the
    masked voxels and the ``pairs`` (half the symmetrised GLCM counts)
    need."""
    in_bytes = 4 * voxels + 4 * masked + 8 * batch
    if family == "firstorder":
        return (float(voxels + FO_OPS_PER_MASKED * masked),
                float(in_bytes + 4 * batch * _fo.packed_width(n_bins)))
    if family == "glcm":
        return (float(voxels + QUANT_OPS * masked + GLCM_OPS_PER_PAIR * pairs),
                float(in_bytes + 4 * batch * n_bins * n_bins))
    raise ValueError(f"unknown intensity family {family!r}")


# ---------------------------------------------------------------------------
# work of a planned launch, from plan metadata alone
# ---------------------------------------------------------------------------

def diameter_cost(m: int, depth: int = 1, extent: int | None = None) -> tuple[float, float]:
    """One pair-sweep launch of ``depth`` lists of ``m`` slots, each swept
    over ``extent`` valid slots (default: the whole list), as the ``seqacc``
    kernel at the default block counts it."""
    block = _diam.DEFAULT_BLOCK
    e = int(m if extent is None else min(int(extent), int(m)))
    d = float(depth)
    return (d * _diam.flop_estimate(int(m), block, "seqacc", extent=e),
            d * _diam.bytes_estimate(int(m), block, "seqacc", extent=e))


def prune_cost(m: int, depth: int = 1, k_dirs: int = 16) -> tuple[float, float]:
    """One pruning-bound pass over ``depth`` lists of ``m`` slots: 14 bytes
    a slot (read xyz and mask, write the keep flag)."""
    slots = float(depth) * float(m)
    per_slot = PRUNE_COMBOS * (5 * k_dirs + PRUNE_OPS_PER_SLOT_COMBO_FIXED)
    return slots * per_slot, 14.0 * slots


def compact_cost(m: int, cap: int, depth: int = 1) -> tuple[float, float]:
    """One compaction launch ``m`` -> ``cap``, every output slot filled."""
    return compact_work(int(depth), int(m), int(cap), int(depth) * int(cap))


def mc_cost(shape, depth: int = 1) -> tuple[float, float]:
    """One batched MC launch over ``depth`` volumes of the padded ``shape``;
    triangles are data, so the bound counts none."""
    nx, ny, nz = (int(s) for s in shape)
    cells = max(nx - 1, 0) * max(ny - 1, 0) * max(nz - 1, 0)
    return mc_work(depth * nx * ny * nz, depth * cells, 0, int(depth))


def family_cost(family: str, shape, depth: int = 1,
                n_bins: int = _fo.N_BINS) -> tuple[float, float]:
    """One intensity-family launch over ``depth`` volumes of ``shape``,
    every voxel masked and (GLCM) three pairs a voxel: the most it needs."""
    voxels = int(depth) * math.prod(int(s) for s in shape)
    pairs = 3 * voxels if family == "glcm" else 0
    return intensity_work(family, int(depth), voxels, voxels, pairs, n_bins)


def work_item_cost(item: planlib.WorkItem) -> tuple[float, float]:
    """Price one plan :class:`~repro_torch.core.plan.WorkItem`."""
    if item.kind == "diameter":
        return diameter_cost(item.m, item.depth)
    if item.kind == "prune":
        return prune_cost(item.m, item.depth)
    if item.kind == "compact":
        return compact_cost(item.m, item.cap, item.depth)
    if item.kind == "mc":
        return mc_cost(item.shape, item.depth)
    if item.kind in ("firstorder", "glcm"):
        return family_cost(item.kind, item.shape, item.depth)
    raise ValueError(f"unknown work item kind {item.kind!r}; known kinds: "
                     f"{planlib.WORK_KINDS}")


def plan_cost(plan: planlib.ExtractionPlan) -> dict:
    """Total (operations, bytes) of every launch a plan implies, and per kind."""
    per_kind: dict = {}
    total_f = total_b = 0.0
    for item in plan.work_census():
        f, b = work_item_cost(item)
        kf, kb = per_kind.get(item.kind, (0.0, 0.0))
        per_kind[item.kind] = (kf + f, kb + b)
        total_f += f
        total_b += b
    return {"flops": total_f, "bytes": total_b, "per_kind": per_kind}


# ---------------------------------------------------------------------------
# roofline pricing
# ---------------------------------------------------------------------------

def bound_ms(work: tuple[float, float], profile: dict) -> dict:
    """``{"bytes": ms, "operations": ms}`` of one launch's ``(operations,
    bytes)`` under ``profile``; the bound is the larger."""
    ops_, nbytes = work
    return {"bytes": nbytes / float(profile["mem_bw"]) * 1e3,
            "operations": ops_ / float(profile["peak_flops"]) * 1e3}


def roofline_us(flops: float, nbytes: float, profile: dict) -> float:
    """``max(compute, memory)`` bound in MICROSECONDS under a profile."""
    return max(flops / float(profile["peak_flops"]), nbytes / float(profile["mem_bw"])) * 1e6


def work_item_us(item: planlib.WorkItem, profile: dict) -> float:
    """Roofline bound of one planned launch, in microseconds."""
    f, b = work_item_cost(item)
    return roofline_us(f, b, profile)
