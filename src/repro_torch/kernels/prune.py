"""Exact candidate pruning for the O(M^2) diameter search.

Counterpart of ``repro.kernels.prune``.  The keep mask is plain PyTorch on
the vertices' device, as the reference's is plain jnp (it has no TPU
kernel), for one case (:func:`candidate_keep_mask`) or a (B, M) stack
(:func:`keep_mask_batch`, the batched pipeline's pass-1 bound).  The
survivors are compacted on the host here (the single-case path and the
batched ``device_compact=False`` baseline) or on the card by
``kernels/compact``; :func:`plan_compaction` is the one decision rule both
follow.

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
survivors finds every maximum.  The extreme witnesses are force-kept, as
the reference keeps them, so the two packages' keep masks agree.  The
sweep's per-pair values do not depend on which other candidates survive
(``ref.diameter_input_batch`` shifts nothing), so on the card the pruned
diameters equal the unpruned ones bitwise.

The ``pc @ d.T`` projection must run in full float32: TF32 would move the
bounds (``torch.backends.cuda.matmul.allow_tf32`` must stay False).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.dispatcher import await_shared, stream_shared, to_device

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


def _constants(device: torch.device, k_dirs: int):
    """The bound's constant tensors on ``device``: the (8, 3) corner signs
    and, per combo, its (3,) axis selector and (K', 3) directions; made
    once and ready for the current stream, whichever stream made them."""
    return await_shared(_constant_tensors(device, k_dirs), device)


@functools.lru_cache(maxsize=None)
def _constant_tensors(device: torch.device, k_dirs: int):
    signs = to_device(np.asarray(_CORNER_SIGNS, np.float32), device)
    per_combo = []
    for combo in COMBOS:
        axes = np.zeros(3, np.float32)
        axes[list(combo)] = 1.0
        per_combo.append((to_device(axes, device),
                          to_device(_directions(combo, k_dirs), device)))
    # one event behind the last copy covers them all: one stream, in order
    return stream_shared((signs, tuple(per_combo)), device)


def candidate_keep_mask(verts, mask, k_dirs: int = 16):
    """Exact per-vertex keep mask for the 4-combo diameter search.

    Returns ``(keep, lower_sq)`` on ``verts``' device: ``keep`` is an (M,)
    bool mask (False = provably not an endpoint of any of the 4 maxima, or
    invalid), and ``lower_sq`` the (4,) squared lower bounds per combo.
    The batch of one of :func:`keep_mask_batch`, so a case's mask is the
    same bits alone or in a stack.
    """
    verts = torch.as_tensor(verts, dtype=torch.float32)
    mask = torch.as_tensor(mask, device=verts.device)
    keep, lower_sq = keep_mask_batch(verts[None], mask[None], k_dirs)
    return keep[0], lower_sq[0]


def _sq3(x: torch.Tensor) -> torch.Tensor:
    """``(x * x).sum(-1)`` over a last axis of 3, as ``(x0² + x1²) + x2²``.

    Written out so the rounding never depends on the reduction kernel a
    tensor's shape selects.
    """
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def keep_mask_batch(verts, masks, k_dirs: int = 16):
    """:func:`candidate_keep_mask` over a (B, M, 3) stack, on its device.

    Returns ``(keep, lower_sq)``: a (B, M) bool mask and the (B, 4)
    squared lower bounds.  The batched pipeline's pass-1 bound.  A case's
    result does not depend on the rest of the stack: every step is
    elementwise, an exact min/max/arg-extreme (first index on ties) or a
    written-out 3-term sum, and the projection ``pc @ d.T`` is taken per
    case at the single-case (M, 3) x (3, K) shape, because a GEMM library
    may pick another kernel, and another rounding, for a folded
    (B*M, 3) product.
    """
    verts = torch.as_tensor(verts, dtype=torch.float32)
    dev = verts.device
    m = torch.as_tensor(masks, device=dev).bool()
    if verts.ndim != 3 or verts.shape[2] != 3 or m.shape != verts.shape[:2]:
        raise ValueError(f"need verts (B, M, 3) and masks (B, M), got "
                         f"{tuple(verts.shape)} and {tuple(m.shape)}")
    b = torch.arange(verts.shape[0], device=dev)
    v0 = verts[b, m.to(torch.uint8).argmax(1)]  # (B, 3) first valid vertex
    vfill = torch.where(m[..., None], verts, v0[:, None, :])
    signs, per_combo = _constants(dev, k_dirs)

    keep_any = torch.zeros(m.shape, dtype=torch.bool, device=dev)
    lower_sq = []
    for axes, d in per_combo:
        pc = vfill * axes  # (B, M, 3), off-combo axes zeroed
        proj = torch.stack([pc_b @ d.T for pc_b in pc])  # (B, M, K)
        # bias invalid (duplicated-fill) slots out of the extreme search so
        # the witnesses are real valid vertices
        pmax = torch.where(m[..., None], proj, -torch.inf)
        pmin = torch.where(m[..., None], proj, torch.inf)
        ext = torch.cat([pmax.argmax(1), pmin.argmin(1)], dim=1)  # (B, 2K)
        e = torch.gather(pc, 1, ext[..., None].expand(-1, -1, 3))  # extreme points
        l2 = _sq3(e[:, :, None, :] - e[:, None, :, :]).flatten(1).amax(1)  # (B,)

        lo = pc.amin(1, keepdim=True)  # (B, 1, 3)
        hi = pc.amax(1, keepdim=True)
        corners = lo + signs * (hi - lo)  # (B, 8, 3); duplicates are harmless
        ub_corner2 = _sq3(pc[:, :, None, :] - corners[:, None, :, :]).amax(2)  # (B, M)
        r = _sq3(pc - 0.5 * (lo + hi)).sqrt()
        ub_centre2 = (r + r.amax(1, keepdim=True)) ** 2
        ub2 = torch.minimum(ub_corner2, ub_centre2)
        keep_any |= ub2 * float(_SLACK) >= l2[:, None]
        # force-keep the extreme witnesses, as the reference does
        keep_any.scatter_(1, ext, True)
        lower_sq.append(l2)
    return keep_any & m, torch.stack(lower_sq, dim=1)


@dataclasses.dataclass(frozen=True)
class PruneInfo:
    """Host-side pruning statistics."""

    m_total: int  # input rows (incl. padding)
    m_valid: int  # valid vertices before pruning
    m_kept: int  # surviving candidates (M')
    pruned: bool  # False when pruning was skipped (degenerate input)

    @property
    def keep_fraction(self) -> float:
        return self.m_kept / self.m_valid if self.m_valid else 1.0


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


def prune_on_host(verts, mask, k_dirs: int = 16, fetch=None):
    """Prune on the vertices' device, compact the survivors on the host.

    ``fetch`` copies a tensor to a host numpy array (default
    ``.cpu().numpy()``; the tiled engine passes its executor's counted
    fetch).  Returns ``(verts_np, mask_np, (verts', mask', info))``: the
    host copies of the inputs, then numpy arrays with ``verts'.shape ==
    (M', 3)`` and an all-true mask.  Degenerate inputs (fewer than 2
    survivors, or nothing pruned) return the originals.
    """
    fetch = fetch or (lambda t: t.cpu().numpy())
    verts = torch.as_tensor(verts, dtype=torch.float32)
    mask = torch.as_tensor(mask, device=verts.device).bool()
    verts_np = fetch(verts)
    mask_np = fetch(mask)
    if int(mask_np.sum()) < 2:  # callers reject empty; skip the bound
        keep = np.zeros(len(verts_np), bool)
    else:
        keep = fetch(candidate_keep_mask(verts, mask, k_dirs=k_dirs)[0])
    return verts_np, mask_np, _compact_survivors(verts_np, mask_np, keep)


def plan_compaction(m_total: int, m_valid: int, m_kept: int, bucket_fn):
    """Shared pruned/kept decision for both compaction paths.

    Composes the degenerate-input rule of :func:`_compact_survivors`
    (fewer than 2 valid or surviving vertices, or nothing pruned -> keep
    the originals) with the re-bucketing rule of
    ``ops._rebucket_pruned`` (a survivor bucket no smaller than the input
    wins nothing -> keep the originals).  Returns ``(cap, info)`` where
    ``cap`` is the M' bucket to compact into, or ``None`` when the case
    keeps its original arrays.  Both the host path and the device path
    derive their ``PruneInfo`` from this single function, so the two can
    never drift.
    """
    if m_valid < 2 or m_kept < 2 or m_kept >= m_valid:
        return None, PruneInfo(m_total, m_valid, m_valid, False)
    cap = int(bucket_fn(m_kept))
    if cap >= m_total:
        return None, PruneInfo(m_total, m_valid, m_valid, False)
    return cap, PruneInfo(m_total, m_valid, m_kept, True)


def prune_vertices_batch(verts, masks, k_dirs: int = 16, device=None):
    """Batched pass-1 bound on ``device``, host compaction per case.

    ``verts``: (B, M, 3), ``masks``: (B, M), host arrays.  One
    :func:`keep_mask_batch` on ``device`` (default the CPU) computes every
    case's bound; the survivors are compacted on the host per case because
    their counts M' are ragged.  Returns a list of B numpy
    ``(verts', mask', info)`` triples with the degenerate-input semantics
    of :func:`prune_on_host`.
    """
    verts_np = np.asarray(verts, np.float32)
    masks_np = np.asarray(masks).astype(bool)
    dev = torch.device("cpu" if device is None else device)
    keep = keep_mask_batch(to_device(verts_np, dev), to_device(masks_np, dev), k_dirs)[0]
    return [
        _compact_survivors(v, m, k)
        for v, m, k in zip(verts_np, masks_np, keep.cpu().numpy())
    ]
