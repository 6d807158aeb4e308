"""The plain reference: shape, first-order and GLCM features of one case.

Every float computation runs in ``dtype`` (float64 for the reference; the
control of ``radbench/check.py`` passes bfloat16).  What each feature means
is the program's stated semantics:

* **mesh** (``mesh``): marching cubes at iso 0.5 over the ROI crop, padded
  by one empty voxel, with the frozen copy of the port's table
  (``mc_tables``); the mesh volume is ``|sum a . (b x c)| / 6`` and the area
  ``sum |(b - a) x (c - a)| / 2`` over its triangles, positions
  ``index * spacing``.
* **diameters** (``max_diameters``): the largest distance between two mesh
  vertices (one vertex on every grid edge whose ends straddle the surface),
  in 3D and projected on the (x, y), (x, z) and (y, z) planes, over every
  vertex.  ``survivors`` removes only vertices that provably cannot be an
  end of a longest pair (a support-function bound, below), and the rest
  are swept pair by pair.
* **first order** (``firstorder``): over the masked voxels, mean, standard
  deviation, minimum, maximum, the 10th, 50th and 90th percentiles taken
  as the centre of the first bin whose cumulative count reaches
  ``float32(q) * float32(n)``, energy (sum of squares) and the entropy of
  the bin histogram.  Binning is a definition, so it runs in float32 (or a
  lower ``dtype``): ``n_bins`` bins of width ``(hi - lo) / n_bins`` between
  the masked minimum and maximum, ``floor((x - lo) / width)`` clipped to
  the last bin.
* **GLCM** (``glcm``): the symmetrised co-occurrence counts of those bins
  at the three distance-1 axial offsets, over pairs with both voxels in the
  mask; contrast, correlation (1 for a single gray level), inverse
  difference moment and joint energy.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from radbench.reference import mc_tables as mct

FIRSTORDER = ("Mean", "StdDev", "Minimum", "Maximum", "Percentile10", "Median",
              "Percentile90", "Energy", "Entropy")
GLCM = ("Contrast", "Correlation", "Idm", "JointEnergy")
COMBOS = ((0, 1, 2), (0, 1), (0, 2), (1, 2))  # 3D, (x, y), (x, z), (y, z)
OFFSETS = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
_BLOCK_ELEMS = 1 << 24  # elements of one block of a pair sweep or a projection
CUBE_STEPS = 8  # directions of the 3D bound: the integer points of the cube of side 2 * 8
CIRCLE_STEPS = 128  # directions of the planar bound


def roi_crop(image, mask, pad: int = 1):
    """The ROI bounding box of ``mask``, padded by ``pad`` empty voxels:
    ``(image crop, mask crop)`` tensors on ``mask``'s device (image None
    when not given)."""
    m = torch.as_tensor(mask).bool()
    lo, hi = [], []
    for axis in range(3):
        other = tuple(a for a in range(3) if a != axis)
        idx = m.any(dim=other).nonzero()[:, 0]
        if idx.numel() == 0:
            raise ValueError("mask is empty")
        lo.append(int(idx[0]))
        hi.append(int(idx[-1]) + 1)
    sl = tuple(slice(a, b) for a, b in zip(lo, hi))
    mc = torch.nn.functional.pad(m[sl].to(torch.uint8), (pad,) * 6).bool()
    ic = None
    if image is not None:
        img = torch.as_tensor(image, device=m.device)
        ic = torch.nn.functional.pad(img[sl].to(torch.float32), (pad,) * 6)
    return ic, mc


def _cube_index(inside: torch.Tensor) -> torch.Tensor:
    cx, cy, cz = (n - 1 for n in inside.shape)
    ins = inside.to(torch.int32)
    idx = torch.zeros((cx, cy, cz), dtype=torch.int32, device=inside.device)
    for c, (dx, dy, dz) in enumerate(mct.CORNERS.tolist()):
        idx += ins[dx:dx + cx, dy:dy + cy, dz:dz + cz] << c
    return idx


def triangle_count(mask_crop: torch.Tensor) -> int:
    """Triangles of the marching-cubes mesh of a padded ROI crop."""
    n_tris = torch.as_tensor(mct.N_TRIS, device=mask_crop.device)
    return int(n_tris[_cube_index(mask_crop.bool()).long()].sum())


def mesh(mask_crop: torch.Tensor, spacing, dtype=torch.float64):
    """``(volume, area)`` of the mesh of a padded ROI crop, in ``dtype``."""
    inside = mask_crop.bool()
    dev = inside.device
    vals = inside.to(dtype)
    sp = torch.as_tensor(np.asarray(spacing, np.float64), device=dev).to(dtype)
    idx = _cube_index(inside)
    i, j, k = ((idx != 0) & (idx != 255)).nonzero(as_tuple=True)
    cells = torch.stack([i, j, k], dim=1)
    pos = []
    for axis, off in zip(mct.EDGE_CELL_AXIS.tolist(), mct.EDGE_CELL_OFFSET.tolist()):
        p0 = cells + torch.as_tensor(off, device=dev)
        step = torch.zeros(3, dtype=torch.int64, device=dev)
        step[axis] = 1
        p1 = p0 + step
        v0 = vals[p0[:, 0], p0[:, 1], p0[:, 2]]
        v1 = vals[p1[:, 0], p1[:, 1], p1[:, 2]]
        denom = v1 - v0
        t = torch.where(denom == 0, torch.zeros_like(denom), (0.5 - v0) / torch.where(
            denom == 0, torch.ones_like(denom), denom))
        p = p0.to(dtype)
        p[:, axis] = p[:, axis] + t
        pos.append(p * sp)
    edges = torch.stack(pos, dim=1)  # (cells, 12, 3)
    tids = torch.as_tensor(mct.TRI_TABLE, dtype=torch.int64, device=dev)[idx[i, j, k].long()]
    tids = tids.reshape(-1, mct.MAX_TRIS, 3)
    valid = tids[..., 0] >= 0
    cell_of = torch.arange(len(cells), device=dev)[:, None].expand(-1, mct.MAX_TRIS)[valid]
    tri = edges[cell_of[:, None], tids[valid]]  # (triangles, 3, 3)
    a, b, c = tri.unbind(1)
    area = 0.5 * torch.linalg.vector_norm(torch.linalg.cross(b - a, c - a), dim=1)
    svol = (a * torch.linalg.cross(b, c)).sum(1) / 6.0
    return svol.sum().abs(), area.sum()


def vertices(mask_crop: torch.Tensor, spacing, dtype=torch.float64) -> torch.Tensor:
    """``(n, 3)`` positions of every mesh vertex: the iso-0.5 crossing on
    each grid edge whose two ends straddle the surface."""
    inside = mask_crop.bool()
    dev = inside.device
    sp = torch.as_tensor(np.asarray(spacing, np.float64), device=dev).to(dtype)
    out = []
    for axis in range(3):
        a = inside.narrow(axis, 0, inside.shape[axis] - 1)
        b = inside.narrow(axis, 1, inside.shape[axis] - 1)
        p = (a != b).nonzero().to(dtype)
        p[:, axis] += 0.5  # binary values: the crossing is at the edge's midpoint
        out.append(p * sp)
    return torch.cat(out)


def directions(dim: int, dtype, device) -> tuple[torch.Tensor, float]:
    """``(K, dim)`` unit directions, symmetric under negation, and the cosine
    of their covering radius: every unit vector lies within that angle of
    one of them.  3D: the integer points of the surface of the cube
    ``[-n, n]^3`` (a point on a face lies within ``sqrt(2) / (2n)`` of a grid
    point, both at norm >= n / n, so within the angle ``2 asin(sqrt(2) /
    (4n))``); 2D: ``CIRCLE_STEPS`` equal angles (within ``pi / K``)."""
    if dim == 2:
        ang = torch.arange(CIRCLE_STEPS, dtype=torch.float64) * (2 * math.pi / CIRCLE_STEPS)
        d = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
        cos_theta = math.cos(math.pi / CIRCLE_STEPS)
    else:
        n = CUBE_STEPS
        r = torch.arange(-n, n + 1, dtype=torch.float64)
        g = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
        g = g[g.abs().amax(1) == n]
        d = g / torch.linalg.vector_norm(g, dim=1, keepdim=True)
        cos_theta = math.cos(2.0 * math.asin(math.sqrt(2.0) / (4.0 * n)))
    return d.to(dtype=dtype, device=device), cos_theta


def _row_blocks(n: int, width: int):
    rows = max(1, _BLOCK_ELEMS // max(1, width))
    for r0 in range(0, n, rows):
        yield r0, min(n, r0 + rows)


def survivors(points: torch.Tensor) -> torch.Tensor:
    """Indices of the points that may end a longest pair of ``points``.

    With ``h(u) = max_q q . u`` over directions ``u`` of covering-radius
    cosine ``c``: for any pair, some ``u`` lies within that angle of
    ``q - p``, so ``|q - p| <= (h(u) - p . u) / c``; the largest of those
    over ``u`` bounds every pair that ``p`` ends.  ``L``, the longest
    distance between the two extreme points of a direction, is the length
    of a real pair, so a point whose bound is below ``L`` ends no longest
    pair.
    """
    n, dim = points.shape
    dirs, cos_theta = directions(dim, points.dtype, points.device)
    h = torch.full((len(dirs),), -math.inf, dtype=points.dtype, device=points.device)
    arg = torch.zeros(len(dirs), dtype=torch.int64, device=points.device)
    for r0, r1 in _row_blocks(n, len(dirs)):
        best, where = (points[r0:r1] @ dirs.T).max(0)
        take = best > h
        h = torch.where(take, best, h)
        arg = torch.where(take, where + r0, arg)
    # the antipode of direction k: its extreme point is the other end of a real pair
    anti = (dirs @ dirs.T).argmin(1)
    ends = points[arg] - points[arg[anti]]
    longest = torch.linalg.vector_norm(ends, dim=1).max()
    keep = []
    for r0, r1 in _row_blocks(n, len(dirs)):
        bound = (h[None, :] - points[r0:r1] @ dirs.T).amax(1) / cos_theta
        keep.append(bound * (1.0 + 1e-9) >= longest)
    return torch.cat(keep).nonzero()[:, 0]


def _max_pair_sq(points: torch.Tensor) -> torch.Tensor:
    best = torch.zeros((), dtype=points.dtype, device=points.device)
    for r0, r1 in _row_blocks(len(points), len(points)):
        d = points[r0:r1, None, :] - points[None, :, :]
        best = torch.maximum(best, (d * d).sum(-1).max())
    return best


def max_diameters(verts: torch.Tensor, prune: bool = True) -> torch.Tensor:
    """``(4,)`` longest vertex distances: 3D, (x, y), (x, z), (y, z), in
    ``verts``' dtype; the exact filter of ``survivors`` runs in float64 on
    those same points, whatever their dtype."""
    out = []
    for axes in COMBOS:
        p = verts[:, list(axes)]
        if prune and len(p) > 2:
            p = p[survivors(p.double())]
        out.append(torch.sqrt(_max_pair_sq(p)))
    return torch.stack(out)


def quantize(img: torch.Tensor, m: torch.Tensor, n_bins: int, qdtype):
    """Bin ids (int64), bin width and the masked ``(lo, hi)``."""
    x = img[m].to(qdtype)
    lo, hi = x.min(), x.max()
    span = hi - lo
    width = span / torch.tensor(float(n_bins), dtype=qdtype, device=img.device)
    safe = torch.where(width > 0, width, torch.ones_like(width))
    q = torch.clamp(torch.floor((img.to(qdtype) - lo) / safe), 0, n_bins - 1)
    q = torch.where(m, q, torch.zeros_like(q)).to(torch.int64)
    return q, width, lo, hi


def firstorder(img: torch.Tensor, m: torch.Tensor, n_bins: int, dtype=torch.float64):
    """``(9,)`` first-order features (``FIRSTORDER``) in ``dtype``."""
    qdtype = torch.float32 if dtype == torch.float64 else dtype
    q, width, lo, hi = quantize(img, m, n_bins, qdtype)
    x = img[m].to(dtype)
    n = x.numel()
    s1, s2 = x.sum(), (x * x).sum()
    hist = torch.bincount(q[m], minlength=n_bins).to(dtype)
    mean = s1 / n
    std = torch.sqrt(torch.clamp(s2 / n - mean * mean, min=0))
    p = hist / n
    entropy = -(torch.where(p > 0, p * torch.log2(torch.where(p > 0, p, torch.ones_like(p))),
                            torch.zeros_like(p))).sum()
    centers = (lo.to(dtype) + (torch.arange(n_bins, device=img.device, dtype=dtype) + 0.5)
               * width.to(dtype))
    cum = torch.cumsum(hist, 0).to(torch.float32)

    def pct(frac):
        rank = torch.tensor(frac, dtype=torch.float32) * torch.tensor(float(n),
                                                                     dtype=torch.float32)
        return centers[int((cum >= rank.to(img.device)).to(torch.uint8).argmax())]

    return torch.stack([mean, std, lo.to(dtype), hi.to(dtype), pct(0.1), pct(0.5), pct(0.9),
                        s2, entropy])


def glcm_counts(img: torch.Tensor, m: torch.Tensor, n_bins: int, qdtype=torch.float32):
    """``(n_bins, n_bins)`` symmetrised co-occurrence counts (int64) and the
    number of in-mask neighbour pairs."""
    q, _, _, _ = quantize(img, m, n_bins, qdtype)
    g = torch.zeros(n_bins * n_bins, dtype=torch.int64, device=img.device)
    pairs = 0
    for off in OFFSETS:
        a = tuple(slice(None, -o) if o else slice(None) for o in off)
        b = tuple(slice(o, None) for o in off)
        both = m[a] & m[b]
        pairs += int(both.sum())
        g += torch.bincount((q[a] * n_bins + q[b])[both], minlength=n_bins * n_bins)
    g = g.reshape(n_bins, n_bins)
    return g + g.T, pairs


def glcm(img: torch.Tensor, m: torch.Tensor, n_bins: int, dtype=torch.float64):
    """``(4,)`` GLCM features (``GLCM``) in ``dtype``."""
    qdtype = torch.float32 if dtype == torch.float64 else dtype
    g, _ = glcm_counts(img, m, n_bins, qdtype)
    P = g.to(dtype)
    P = P / P.sum().clamp(min=1)
    lv = torch.arange(n_bins, dtype=dtype, device=img.device)
    i, j = lv[:, None], lv[None, :]
    diff2 = (i - j) ** 2
    px = P.sum(1)
    mu = (lv * px).sum()
    sig2 = ((lv - mu) ** 2 * px).sum()
    corr = torch.where(sig2 > 0, ((i * j * P).sum() - mu * mu) / torch.where(
        sig2 > 0, sig2, torch.ones_like(sig2)), torch.ones_like(sig2))
    return torch.stack([(diff2 * P).sum(), corr, (P / (1 + diff2)).sum(), (P * P).sum()])


def case_features(image, mask, spacing, families=("shape",), n_bins: int = 32,
                  dtype=torch.float64, device="cpu") -> dict:
    """The compared features of one case, as float64 numpy arrays:
    ``shape`` ``[volume, area, d3D, d_xy, d_xz, d_yz]``, ``firstorder`` (9)
    and ``glcm`` (4), for the families asked for."""
    ic, mc = roi_crop(torch.as_tensor(image).to(device), torch.as_tensor(mask).to(device))
    out = {}
    if "shape" in families:
        vol, area = mesh(mc, spacing, dtype)
        d = max_diameters(vertices(mc, spacing, dtype))
        out["shape"] = torch.cat([torch.stack([vol, area]), d]).double().cpu().numpy()
    if "firstorder" in families:
        out["firstorder"] = firstorder(ic, mc, n_bins, dtype).double().cpu().numpy()
    if "glcm" in families:
        out["glcm"] = glcm(ic, mc, n_bins, dtype).double().cpu().numpy()
    return out
