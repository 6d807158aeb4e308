"""How ``correct`` is decided: the timed path's rows against the plain
reference (``radbench/reference``), number by number, each under the
limit its configuration file states.

The numbers, each the worst over every compared case:

* ``mesh_rel``: relative error of the mesh volume and surface area;
* ``diam_rel``: relative error of the four maximum diameters;
* ``firstorder_gap``: the first-order features' error, the seven in
  intensity units over the case's masked range, energy relative, entropy
  over ``log2(n_bins)``;
* ``glcm_gap``: contrast and joint energy relative, correlation and the
  inverse difference moment absolute.

A row that is missing or not finite reads infinity, and every answer has
to come.  Each answer is held to the reference on its own, so two answers
of one case agree within twice a limit; they need not agree bitwise.  The control
(``radbench/control.py``) is the reference itself computed in bfloat16,
the precision below the configuration's float32, put in the program's
place.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from radbench.reference import features as ref

# columns of the program's rows: its documented layout, in family order
ROW_WIDTH = {"shape": 7, "firstorder": 9, "glcm": 4}
SINGLE_KEYS = ("MeshVolume", "SurfaceArea", "Maximum3DDiameter", "Maximum2DDiameterSlice",
               "Maximum2DDiameterRow", "Maximum2DDiameterColumn")
NUMBERS = {"shape": ("mesh_rel", "diam_rel"), "firstorder": ("firstorder_gap",),
           "glcm": ("glcm_gap",)}


def split_row(row, families) -> dict:
    """A program row as ``{family: float64 array}`` of the compared columns
    (the shape family drops its trailing vertex count)."""
    out, c = {}, 0
    row = np.asarray(row, np.float64)
    for fam in families:
        part = row[c:c + ROW_WIDTH[fam]]
        out[fam] = part[:6] if fam == "shape" else part
        c += ROW_WIDTH[fam]
    return out


def single_row(feats: dict) -> dict:
    """``ShapeFeatureExtractor.execute``'s features as a compared row."""
    return {"shape": np.asarray([feats[k] for k in SINGLE_KEYS], np.float64)}


def _rel(got, want, floor=1e-12):
    return np.abs(got - want) / np.maximum(np.abs(want), floor)


def gaps(got: dict, want: dict, n_bins: int) -> dict:
    """The compared numbers of one case (see the module docstring)."""
    out = {}
    for fam, names in NUMBERS.items():
        if fam not in want:
            continue
        g = got.get(fam) if got is not None else None
        if g is None or not np.all(np.isfinite(g)):
            out.update({n: math.inf for n in names})
            continue
        w = want[fam]
        if fam == "shape":
            out["mesh_rel"] = float(_rel(g[:2], w[:2]).max())
            out["diam_rel"] = float(_rel(g[2:6], w[2:6], 1e-6).max())
        elif fam == "firstorder":
            span = max(w[3] - w[2], 1e-6)
            out["firstorder_gap"] = float(max(np.abs(g[:7] - w[:7]).max() / span,
                                              _rel(g[7], w[7]),
                                              abs(g[8] - w[8]) / math.log2(n_bins)))
        else:
            out["glcm_gap"] = float(max(_rel(g[0], w[0]), abs(g[1] - w[1]), abs(g[2] - w[2]),
                                        _rel(g[3], w[3])))
    return out


def worst(per_case: list[dict]) -> dict:
    out: dict = {}
    for d in per_case:
        for k, v in d.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def reference_rows(cases, families, n_bins, device, dtype=torch.float64) -> list[dict]:
    """The reference's features of each case, computed case by case."""
    return [ref.case_features(c.image, c.mask, c.spacing, families, n_bins, dtype, device)
            for c in cases]


def verdict(numbers: dict, limits: dict, missing: int) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number within its
    limit and no answer missing."""
    shown = {k: {"value": numbers.get(k, math.inf), "limit": limits[k]} for k in limits}
    shown["missing_answers"] = {"value": missing, "limit": 0}
    ok = missing == 0 and all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
