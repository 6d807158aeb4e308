"""The work a traced window handed each kernel, for the roofline shares.

What a launch is handed depends partly on the case alone (the ROI crop's
voxels and cells, the mesh's triangles, the masked voxels, the in-mask
neighbour pairs: :func:`case_census`, from the plain reference's own crop
and mesh) and partly on the program's pruning (the vertex lists the
diameter sweep and the compaction get).  The second part is read by
replaying the window's work once more after it closed, untraced, with the
program's diameter and compaction entries wrapped to count the valid
slots, survivors and lists they are handed (:func:`recording`); the
replay repeats the window's work exactly (the same job, or the same
cases), so its counts scale to the window.
"""
from __future__ import annotations

import collections
import contextlib
import math

import torch

from radbench import yardstick as ys
from radbench.reference import features as ref


def case_census(case, families, device) -> dict:
    """Counts of one case from its padded ROI crop."""
    _, mc = ref.roi_crop(None, torch.as_tensor(case.mask).to(device))
    out = {"voxels": mc.numel(), "cells": math.prod(s - 1 for s in mc.shape),
           "masked": int(mc.sum())}
    if "shape" in families:
        out["triangles"] = ref.triangle_count(mc)
    if "glcm" in families:
        pairs = 0
        for off in ref.OFFSETS:
            a = tuple(slice(None, -o) if o else slice(None) for o in off)
            b = tuple(slice(o, None) for o in off)
            pairs += int((mc[a] & mc[b]).sum())
        out["pairs"] = pairs
    return out


@contextlib.contextmanager
def recording():
    """Count what the program's diameter and compaction entries are handed:
    ``{"diameter": [valid slots of each list], "compact": [(keep flags,
    survivors, lists) of each launch]}``."""
    from repro_torch.kernels import ops

    rec = {"diameter": [], "compact": []}
    orig = {n: getattr(ops, n) for n in ("max_diameters_batch", "max_diameters",
                                         "compact_survivors_batch")}

    def diam_batch(verts, masks, *a, **k):
        out = orig["max_diameters_batch"](verts, masks, *a, **k)
        m = torch.as_tensor(masks).bool()
        rec["diameter"] += m.reshape(m.shape[0], -1).sum(1).tolist()
        return out

    def diam_one(verts, mask, *a, **k):
        out = orig["max_diameters"](verts, mask, *a, **k)
        rec["diameter"].append(int(torch.as_tensor(mask).bool().sum()))
        return out

    def compact(verts, keep, cap, *a, **k):
        out = orig["compact_survivors_batch"](verts, keep, cap, *a, **k)
        kp = torch.as_tensor(keep)
        rec["compact"].append((kp.numel(), int(out[2].clamp(max=cap).sum()), kp.shape[0]))
        return out

    ops.max_diameters_batch, ops.max_diameters, ops.compact_survivors_batch = (
        diam_batch, diam_one, compact)
    try:
        yield rec
    finally:
        for n, f in orig.items():
            setattr(ops, n, f)


def handed(rec: dict, weight: float) -> collections.Counter:
    """A :func:`recording`'s totals, ``weight`` times: diameter valid slots,
    lists and pairs of valid slots; compaction flags, survivors and lists."""
    out = collections.Counter()
    d = rec["diameter"]
    out["diam_valid"] = weight * sum(d)
    out["diam_lists"] = weight * len(d)
    out["diam_pairs"] = weight * sum(v * (v - 1) // 2 for v in d)
    for flags, surv, lists in rec["compact"]:
        out["compact_flags"] += weight * flags
        out["compact_survivors"] += weight * surv
        out["compact_lists"] += weight * lists
    return out


def window_work(case_counts, censuses, handed, families, n_bins) -> dict:
    """``{kernel: (operations, bytes)}`` of a window: ``case_counts`` maps a
    pool index to the times the window ran it, ``censuses`` a pool index to
    its :func:`case_census`, ``handed`` the weighted :func:`handed` totals."""
    tot = collections.Counter()
    for i, times in case_counts.items():
        for k, v in censuses[i].items():
            tot[k] += times * v
        tot["cases"] += times
    out = {}
    if "shape" in families:
        out["marching_cubes"] = ys.mc_work(tot["voxels"], tot["cells"], tot["triangles"],
                                           tot["cases"])
        if handed["diam_lists"]:
            out["diameter"] = ys.diameter_work(handed["diam_valid"], handed["diam_lists"],
                                               handed["diam_pairs"])
        if handed["compact_lists"]:
            out["compact"] = ys.compact_work(handed["compact_flags"],
                                             handed["compact_survivors"],
                                             handed["compact_lists"])
    if "firstorder" in families or "glcm" in families:
        out["masked_range"] = ys.masked_range_work(tot["voxels"], tot["masked"], tot["cases"])
    for fam in ("firstorder", "glcm"):
        if fam in families:
            out[fam] = ys.intensity_work(fam, tot["cases"], tot["voxels"], tot["masked"],
                                         tot["pairs"], n_bins)
    return out
