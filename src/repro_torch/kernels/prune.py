"""Exact candidate pruning for the O(M^2) diameter search.

Counterpart of ``repro.kernels.prune`` (single-case part).  The keep mask
is plain PyTorch on the vertices' device, as the reference's is plain jnp
(it has no TPU kernel); compaction stays on the host, as in the reference.

Method (per combo c in {3D, xy, xz, yz}, restricted to c's axes):

1. *Lower bound* L_c: project the vertices onto K sampled unit directions
   (always including the coordinate axes), take the arg-min/arg-max vertex
   per direction, and brute-force the <= 2K extreme points.  Every extreme
   is a real valid vertex, so L_c <= D_c (the true combo diameter).
2. *Upper bound* ub_c(p) per vertex: distance from p to the farthest corner
   of the candidate bounding box (``x -> |p - x|`` is convex, so its max
   over a box is at a corner), intersected with the triangle-inequality
   bound ``|p - centre| + max_q |q - centre|``.
3. Discard p for combo c iff ub_c(p) < L_c.

A vertex survives if ANY combo keeps it, so one 4-combo sweep over the
survivors finds every maximum.  The extreme witnesses are force-kept (the
axis directions are always sampled), so the candidate bounding box, and
with it the sweep's centring, does not change: on the card the pruned
diameters equal the unpruned ones bitwise.

The ``pc @ d.T`` projection must run in full float32: TF32 would move the
bounds (``torch.backends.cuda.matmul.allow_tf32`` must stay False).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

COMBOS = ((0, 1, 2), (0, 1), (0, 2), (1, 2))  # 3D, xy, xz, yz

# relative slack on the squared upper bound; >> f32 rounding, prunes
# a negligible shell of borderline candidates less aggressively
_SLACK = np.float32(1.0 + 1e-4)

_CORNER_SIGNS = [[sx, sy, sz] for sx in (0, 1) for sy in (0, 1) for sz in (0, 1)]


def _directions(combo: tuple, k: int) -> np.ndarray:
    """(K', 3) unit directions spanning ``combo``'s axes.

    Always starts with the coordinate axes and the subspace diagonals;
    extra directions come from a deterministic golden-ratio sweep (2D:
    half-circle angles, 3D: spiral hemisphere).  Min/max projections are
    both taken per direction, so antipodes are covered for free.
    """
    dirs = []
    for a in combo:
        e = np.zeros(3)
        e[a] = 1.0
        dirs.append(e)
    if len(combo) == 2:
        a0, a1 = combo
        for s in (1.0, -1.0):
            d = np.zeros(3)
            d[a0], d[a1] = 1.0, s
            dirs.append(d)
        for i in range(max(0, k - len(dirs))):
            th = np.pi * (i + 0.5) / max(1, k - 4)
            d = np.zeros(3)
            d[a0], d[a1] = np.cos(th), np.sin(th)
            dirs.append(d)
    else:
        for sx in (1.0, -1.0):
            for sy in (1.0, -1.0):
                dirs.append(np.array([1.0, sx, sy]))
        golden = (1.0 + 5.0 ** 0.5) / 2.0
        n_extra = max(0, k - len(dirs))
        for i in range(n_extra):
            z = (i + 0.5) / n_extra
            r = (1.0 - z * z) ** 0.5
            th = 2.0 * np.pi * i / golden
            dirs.append(np.array([r * np.cos(th), r * np.sin(th), z]))
    d = np.stack(dirs)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d.astype(np.float32)


def candidate_keep_mask(verts, mask, k_dirs: int = 16):
    """Exact per-vertex keep mask for the 4-combo diameter search.

    Returns ``(keep, lower_sq)`` on ``verts``' device: ``keep`` is an (M,)
    bool mask (False = provably not an endpoint of any of the 4 maxima, or
    invalid), and ``lower_sq`` the (4,) squared lower bounds per combo.
    """
    verts = torch.as_tensor(verts, dtype=torch.float32)
    dev = verts.device
    m = torch.as_tensor(mask, device=dev).bool()
    v0 = verts[m.to(torch.uint8).argmax()]  # first valid vertex (callers reject empty)
    vfill = torch.where(m[:, None], verts, v0)
    signs = torch.tensor(_CORNER_SIGNS, dtype=torch.float32, device=dev)

    keep_any = torch.zeros(m.shape, dtype=torch.bool, device=dev)
    lower_sq = []
    for combo in COMBOS:
        axes = torch.zeros(3, dtype=torch.float32, device=dev)
        axes[list(combo)] = 1.0
        pc = vfill * axes  # off-combo axes zeroed
        d = torch.as_tensor(_directions(combo, k_dirs), device=dev)  # (K, 3)
        proj = pc @ d.T  # (M, K)
        # bias invalid (duplicated-fill) slots out of the extreme search so
        # the witnesses are real valid vertices
        pmax = torch.where(m[:, None], proj, -torch.inf)
        pmin = torch.where(m[:, None], proj, torch.inf)
        ext = torch.cat([pmax.argmax(0), pmin.argmin(0)])
        e = pc[ext]  # (2K, 3) extreme points
        de = e[:, None, :] - e[None, :, :]
        l2 = (de * de).sum(-1).amax()  # squared lower bound

        lo = pc.amin(0)
        hi = pc.amax(0)
        corners = lo + signs * (hi - lo)  # (8, 3); duplicates are harmless
        dc = pc[:, None, :] - corners[None, :, :]
        ub_corner2 = (dc * dc).sum(-1).amax(1)  # (M,)
        r = ((pc - 0.5 * (lo + hi)) ** 2).sum(-1).sqrt()
        ub_centre2 = (r + r.amax()) ** 2
        ub2 = torch.minimum(ub_corner2, ub_centre2)
        keep_any |= ub2 * float(_SLACK) >= l2
        # force-keep the extreme witnesses: dropping one would move the
        # candidate bounding box and with it the sweep's centring
        keep_any[ext] = True
        lower_sq.append(l2)
    return keep_any & m, torch.stack(lower_sq)


@dataclasses.dataclass(frozen=True)
class PruneInfo:
    """Host-side pruning statistics."""

    m_total: int  # input rows (incl. padding)
    m_valid: int  # valid vertices before pruning
    m_kept: int  # surviving candidates (M')
    pruned: bool  # False when pruning was skipped (degenerate input)


def _compact_survivors(verts_np, mask_np, keep):
    """Host-side compaction of the survivors (numpy in, numpy out)."""
    m_valid = int(mask_np.sum())
    if m_valid < 2:
        return verts_np, mask_np, PruneInfo(len(verts_np), m_valid, m_valid, False)
    keep = np.asarray(keep)
    m_kept = int(keep.sum())
    if m_kept < 2 or m_kept >= m_valid:
        return verts_np, mask_np, PruneInfo(len(verts_np), m_valid, m_valid, False)
    idx = np.nonzero(keep)[0]
    return (
        np.ascontiguousarray(verts_np[idx]),
        np.ones((m_kept,), bool),
        PruneInfo(len(verts_np), m_valid, m_kept, True),
    )


def prune_vertices(verts, mask, k_dirs: int = 16):
    """Prune on the vertices' device, compact the survivors on the host.

    Returns ``(verts', mask', info)`` as numpy arrays with
    ``verts'.shape == (M', 3)`` and an all-true mask.  Degenerate inputs
    (fewer than 2 survivors, or nothing pruned) return the originals.
    """
    verts = torch.as_tensor(verts, dtype=torch.float32)
    mask = torch.as_tensor(mask, device=verts.device).bool()
    verts_np = verts.cpu().numpy()
    mask_np = mask.cpu().numpy()
    if int(mask_np.sum()) < 2:  # callers reject empty; skip the bound
        keep = np.zeros(len(verts_np), bool)
    else:
        keep = candidate_keep_mask(verts, mask, k_dirs=k_dirs)[0].cpu().numpy()
    return _compact_survivors(verts_np, mask_np, keep)
