"""Plain PyTorch versions of the reference ops and the shape path's kernels.

Counterpart of ``repro.kernels.ref``.  These run on whatever device their
input lies on.  The vertex-field, count and compaction ops are the main
path's own steps on every device (the reference has no TPU kernel for
them either).  :func:`mc_volume_area`, :func:`max_diameters_sq`, the
batched :func:`mc_volume_area_batch`, :func:`max_diameters_sq_batch` (one
plain version per diameter variant, over :func:`pair_sweep`) and
:func:`compact_batch`, and the tiled path's :func:`mc_slab_partials` and
:func:`mc_partials_fold` are the plain versions of the CUDA kernels: the
kernel wrappers take them only for a tensor on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card.
:func:`intensity_range` and :func:`quantize_intensity` are the intensity
families' shared quantisation contract, :func:`check_bins` and
:func:`check_volumes` what both of their kernels take (the plain versions
of those kernels live in ``kernels/firstorder.py`` and ``kernels/glcm.py``).

Conventions
-----------
* volumes are ``(nx, ny, nz)`` float32 tensors; a voxel is *inside* iff
  ``value > iso`` (binary masks with ``iso=0.5``, as PyRadiomics uses).
* ``spacing``/``origin`` map index space to physical space:
  ``pos_phys = origin + index * spacing``.
* mesh vertices are deduplicated by construction: every *grid edge* owns at
  most one vertex, stored in three dense per-axis fields (VX, VY, VZ).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import mc_tables as mct
from repro_torch.core.dispatcher import to_device

NEG = -1e30
# the diameter variants of the reference (repro.kernels.diameter.VARIANTS)
DIAMETER_VARIANTS = ("naive", "fused", "tri", "seqacc", "tri_prefetch", "nomask", "gram")
COMBOS = ((0, 1, 2), (0, 1), (0, 2), (1, 2))  # the axes of [3D, xy, xz, yz]
# elements of one (rows, M) block of the plain pair sweep: bounds its memory
_SWEEP_ELEMS = 1 << 24
MAX_BINS = 64  # the intensity kernels' shared histogram size
MC_CHUNK_Z = 8  # cell planes per z-granule of the marching-cubes partial layout


class VertexFields(NamedTuple):
    """Dense per-axis vertex fields."""

    vx: torch.Tensor  # (nx-1, ny, nz, 3) positions on x-directed edges
    vy: torch.Tensor  # (nx, ny-1, nz, 3)
    vz: torch.Tensor  # (nx, ny, nz-1, 3)
    ax: torch.Tensor  # (nx-1, ny, nz) bool, edge active
    ay: torch.Tensor
    az: torch.Tensor


def _f32(x, device) -> torch.Tensor:
    return to_device(x, device, torch.float32)


def _interp(v0, v1, iso):
    """Interpolation parameter of the iso crossing along an edge."""
    denom = v1 - v0
    safe = torch.where(denom.abs() < 1e-30, torch.ones_like(denom), denom)
    return ((iso - v0) / safe).clamp(0.0, 1.0)


def vertex_fields(vol, iso=0.5, spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0),
                  index_offset=None) -> VertexFields:
    """Deduplicated mesh-vertex fields (pure elementwise pass).

    ``index_offset`` shifts the per-axis grid indices before the physical
    mapping, so a sub-window of a larger volume emits positions in the full
    volume's index frame; the integer offset add is exact.
    """
    vol = torch.as_tensor(vol, dtype=torch.float32)
    dev = vol.device
    sp = _f32(spacing, dev)
    og = _f32(origin, dev)
    off = None if index_offset is None else _f32(index_offset, dev)
    inside = vol > iso

    def axis_field(axis):
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[axis] = slice(0, -1)
        sl1[axis] = slice(1, None)
        v0, v1 = vol[tuple(sl0)], vol[tuple(sl1)]
        act = inside[tuple(sl0)] != inside[tuple(sl1)]
        t = _interp(v0, v1, iso)
        idx = list(torch.meshgrid(
            *(torch.arange(n, dtype=torch.float32, device=dev) for n in v0.shape),
            indexing="ij",
        ))
        if off is not None:
            idx = [g + off[a] for a, g in enumerate(idx)]
        idx[axis] = idx[axis] + t
        return torch.stack(idx, dim=-1) * sp + og, act

    vx, ax = axis_field(0)
    vy, ay = axis_field(1)
    vz, az = axis_field(2)
    return VertexFields(vx, vy, vz, ax, ay, az)


def count_vertices(f: VertexFields) -> torch.Tensor:
    return f.ax.sum() + f.ay.sum() + f.az.sum()


def compact_vertices(f: VertexFields, max_vertices: int):
    """Gather active-edge vertices into a padded (max_vertices, 3) array.

    Returns ``(verts, mask, n_active)``.  The order is the reference's
    stable active-first sort (``argsort(~act, stable=True)``) in full:
    actives in field order (x, y, z, row-major), then the inactive slots in
    field order, which carry their edges' positions, not zeros.  Excess
    actives beyond ``max_vertices`` are dropped (callers size the cap from
    :func:`count_vertices`).
    """
    pos = torch.cat([f.vx.reshape(-1, 3), f.vy.reshape(-1, 3), f.vz.reshape(-1, 3)])
    act = torch.cat([f.ax.reshape(-1), f.ay.reshape(-1), f.az.reshape(-1)])
    order = torch.argsort((~act).to(torch.uint8), stable=True)[:max_vertices]
    return pos[order], act[order], act.sum()


def centred_origin(shape, spacing) -> np.ndarray:
    """The marching-cubes origin ``-0.5 * shape * spacing`` (float32).

    Centring keeps the signed tetrahedron volumes small, which bounds f32
    cancellation; the kernel and the plain version both use it.
    """
    sp = torch.as_tensor(spacing, dtype=torch.float32).cpu().numpy().reshape(3)
    return np.float32(-0.5) * np.asarray(shape, np.float32) * sp


def _cell_cube_index(vol, iso):
    """(nx-1, ny-1, nz-1) int32 marching-cubes case index per cell."""
    inside = (vol > iso).to(torch.int32)
    cx, cy, cz = (n - 1 for n in vol.shape)
    idx = torch.zeros((cx, cy, cz), dtype=torch.int32, device=vol.device)
    for c, (dx, dy, dz) in enumerate(mct.CORNERS.tolist()):
        idx += inside[dx:dx + cx, dy:dy + cy, dz:dz + cz] << c
    return idx


def _cross(u, w):
    u0, u1, u2 = u.unbind(-1)
    w0, w1, w2 = w.unbind(-1)
    return u1 * w2 - u2 * w1, u2 * w0 - u0 * w2, u0 * w1 - u1 * w0


def _tree_sum(y: torch.Tensor) -> torch.Tensor:
    """Sum of a 1-D tensor by a fixed pairwise tree: zero-pad to a power
    of two, then halve (``y[:h] + y[h:]``) down to one element.  Every add
    is elementwise, so the bits depend on the values and their order only."""
    n = 1 << max(0, (y.numel() - 1).bit_length())
    y = torch.nn.functional.pad(y, (0, n - y.numel()))
    while y.numel() > 1:
        h = y.numel() // 2
        y = y[:h] + y[h:]
    return y[0]


def mc_slab_partials(vol, iso=0.5, spacing=(1.0, 1.0, 1.0), *, full_shape, k0=0,
                     chunk_z=MC_CHUNK_Z):
    """Plain version of the marching-cubes partials: per-granule ``(vol, area)``.

    ``vol`` holds the planes of a z-window of a volume of ``full_shape``
    that starts at granule ``k0`` (granules of ``chunk_z`` cell planes).
    Positions are in the whole volume's index frame
    (``vertex_fields(..., index_offset=(0, 0, k0 * chunk_z))``) against its
    centred origin, and cells past its last cell plane count as empty, so
    a window gives the whole volume's partials of its granules bitwise.
    Same cube index, edge map, table and per-triangle formulas as
    ``csrc/marching_cubes.cu``; each granule's triangles, in cell order,
    sum by :func:`_tree_sum`.  Returns two ``(ceil((nz - 1) / chunk_z),)``
    float32 tensors on ``vol``'s device.
    """
    vol = torch.as_tensor(vol, dtype=torch.float32)
    dev = vol.device
    ngran = max(1, -(-(vol.shape[2] - 1) // chunk_z))
    vol_p = torch.zeros(ngran, dtype=torch.float32, device=dev)
    area_p = torch.zeros(ngran, dtype=torch.float32, device=dev)
    if min(vol.shape) < 2:
        return vol_p, area_p
    kz0 = int(k0) * chunk_z
    f = vertex_fields(vol, iso, spacing, centred_origin(full_shape, spacing),
                      index_offset=(0.0, 0.0, float(kz0)))
    idx = _cell_cube_index(vol, iso)
    idx[:, :, max(int(full_shape[2]) - 1 - kz0, 0):] = 0  # past the last cell plane
    i, j, k = ((idx != 0) & (idx != 255)).nonzero(as_tuple=True)
    fields = (f.vx, f.vy, f.vz)
    e = torch.stack([
        fields[a][i + ox, j + oy, k + oz]
        for a, (ox, oy, oz) in zip(mct.EDGE_CELL_AXIS.tolist(), mct.EDGE_CELL_OFFSET.tolist())
    ], dim=1)  # (n, 12, 3)
    tids = torch.as_tensor(mct.TRI_TABLE, dtype=torch.int64, device=dev)[idx[i, j, k].long()]
    tri = torch.gather(e, 1, tids.clamp(min=0)[..., None].expand(-1, -1, 3))
    tri = tri.reshape(-1, mct.MAX_TRIS, 3, 3)
    valid = tids.reshape(-1, mct.MAX_TRIS, 3)[..., 0] >= 0
    a, b, c = tri[valid].unbind(1)
    n0, n1, n2 = _cross(b - a, c - a)
    area = 0.5 * torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-30)
    d0, d1, d2 = _cross(b, c)
    a0, a1, a2 = a.unbind(-1)
    svol = (a0 * d0 + a1 * d1 + a2 * d2) / 6.0
    # each triangle's granule; a stable sort keeps cell order inside one
    gran = (k // chunk_z)[:, None].expand(-1, mct.MAX_TRIS)[valid]
    order = torch.argsort(gran, stable=True)
    counts = torch.bincount(gran, minlength=ngran).tolist()
    svol, area = svol[order], area[order]
    start = 0
    for g, n in enumerate(counts):
        if n:
            vol_p[g] = _tree_sum(svol[start:start + n])
            area_p[g] = _tree_sum(area[start:start + n])
        start += n
    return vol_p, area_p


def mc_partials_fold(vol_p, area_p):
    """Plain version of the partials' finalize: ``(|sum vol_p|, sum
    area_p)`` by :func:`_tree_sum` over the flattened partials, two 0-dim
    float32 tensors.  A fixed order: the same assembled partials give the
    same bits."""
    vol_p = torch.as_tensor(vol_p, dtype=torch.float32)
    area_p = torch.as_tensor(area_p, dtype=torch.float32)
    return _tree_sum(vol_p.reshape(-1)).abs(), _tree_sum(area_p.reshape(-1))


def mc_volume_area(vol, iso=0.5, spacing=(1.0, 1.0, 1.0), chunk_z=MC_CHUNK_Z):
    """Plain version of the marching-cubes kernel: ``(|sum vol|, sum area)``.

    :func:`mc_slab_partials` over the whole volume, then
    :func:`mc_partials_fold`: the kernel's granule layout, cube index, edge
    map, table and per-triangle formulas, with the centred origin; only
    the order of the sums inside a granule and of the fold differs from
    the kernel.  Returns two 0-dim float32 tensors on ``vol``'s device.
    """
    vol = torch.as_tensor(vol, dtype=torch.float32)
    return mc_partials_fold(*mc_slab_partials(vol, iso, spacing, full_shape=tuple(vol.shape),
                                              chunk_z=chunk_z))


def diameter_input(verts, mask, block: int) -> torch.Tensor:
    """Pair-sweep input shared by the diameter kernels and their plain versions.

    Fills invalid slots with the first valid vertex, as
    ``repro.kernels.ref.max_diameters_sq`` does; a duplicated point never
    raises a maximum, so the sweep needs no mask.  Returns the (3, Mp) SoA
    transpose, padded to a multiple of ``block`` with duplicates of the
    last vertex.  The batch of one of :func:`diameter_input_batch`.
    """
    verts = torch.as_tensor(verts, dtype=torch.float32)
    m = torch.as_tensor(mask, device=verts.device).bool()
    if verts.ndim != 2 or verts.shape[1] != 3 or m.shape != verts.shape[:1]:
        raise ValueError(f"need verts (M, 3) and mask (M,), got {tuple(verts.shape)} "
                         f"and {tuple(m.shape)}")
    return diameter_input_batch(verts[None], m[None], block)[0]


def diameter_input_batch(verts, masks, block: int) -> torch.Tensor:
    """:func:`diameter_input` over a (B, M, 3) stack: (B, 3, Mp), the batched
    diameter kernels' input.  Every step is per case and elementwise, so a
    case's rows are the same bits alone or in a stack.

    The coordinates are not shifted: every path's vertices are already in
    its case's ROI crop frame (``crop_to_roi``; the tiled path keeps the
    same frame), a shift that no candidate set moves.  Centring on the
    candidates' bounding box, as the reference's plain version does,
    would let a tiled run whose bounds pruning dropped a box extreme (but
    no endpoint) round its pairs apart from the in-core run.  Each pair's
    difference is then rounded once, from the coordinates themselves.
    """
    verts = torch.as_tensor(verts, dtype=torch.float32)
    m = torch.as_tensor(masks, device=verts.device).bool()
    if verts.ndim != 3 or verts.shape[2] != 3 or m.shape != verts.shape[:2]:
        raise ValueError(f"need verts (B, M, 3) and masks (B, M), got "
                         f"{tuple(verts.shape)} and {tuple(m.shape)}")
    if verts.shape[1] == 0:
        raise ValueError("empty vertex list")
    b = torch.arange(verts.shape[0], device=verts.device)
    v0 = verts[b, m.to(torch.uint8).argmax(1)]  # (B, 3) first valid vertex
    vfill = torch.where(m[..., None], verts, v0[:, None, :])
    pad = -vfill.shape[1] % block
    if pad:
        vfill = torch.cat([vfill, vfill[:, -1:].expand(-1, pad, 3)], dim=1)
    return vfill.transpose(1, 2).contiguous()


def list_extent(masks) -> torch.Tensor:
    """(B,) int32: 1 + the index of each list's last valid slot (0 for a
    list with none), on ``masks``' device, no host sync.  Every slot of
    :func:`diameter_input_batch`'s list at or past it holds a copy of a
    valid vertex, so the pairs below it hold every maximum: the
    ``seqacc`` and ``nomask`` kernels sweep only those."""
    m = torch.as_tensor(masks).bool()
    idx = torch.arange(1, m.shape[1] + 1, dtype=torch.int32, device=m.device)
    return torch.where(m, idx, 0).amax(1).to(torch.int32)


def diameter_mask_batch(masks, block: int, device=None) -> torch.Tensor:
    """(B, Mp) bool: ``masks`` padded with False to the block multiple of
    :func:`diameter_input_batch`, the mask stream of the masked variants."""
    m = torch.as_tensor(masks, device=device).bool()
    pad = -m.shape[1] % block
    if pad:
        m = torch.cat([m, m.new_zeros((m.shape[0], pad))], dim=1)
    return m.contiguous()


def colex_tiles(t) -> tuple[torch.Tensor, torch.Tensor]:
    """``(i, j)`` of tiles ``t`` in the colex order over the upper triangle,
    ``t = j(j+1)/2 + i`` with ``i <= j`` (int64 tensors): the plain mirror
    of the ``seqacc`` kernel's decode (``csrc/diameter.cu`` ``colex_tile``,
    a float square root and an integer correction).  The first ``k(k+1)/2``
    tiles are the ``k x k`` corner, so a list's extent is a prefix."""
    t = torch.as_tensor(t, dtype=torch.int64)
    k = ((torch.sqrt(8.0 * t.to(torch.float32) + 1.0) - 1.0) * 0.5).to(torch.int64)
    k = torch.where(k * (k + 1) // 2 > t, k - 1, k)
    k = torch.where((k + 1) * (k + 2) // 2 <= t, k + 1, k)
    return t - k * (k + 1) // 2, k


def tile_schedule(nb: int) -> torch.Tensor:
    """(2, T) int32 ``(i, j)`` of the ``T = nb(nb+1)/2`` upper-triangle
    tiles in the colex order of :func:`colex_tiles`: the schedule the
    scheduled variants read, ``nomask`` a prefix of it."""
    i, j = colex_tiles(torch.arange(nb * (nb + 1) // 2))
    return torch.stack([i, j]).to(torch.int32)


def extent_tiles(extent, block: int) -> int:
    """Tiles of the colex prefix a list of ``extent`` sweeps at tile side
    ``block``: ``k(k+1)/2``, ``k = ceil(extent / block)``."""
    k = -(-int(extent) // block)
    return k * (k + 1) // 2


def tile_valid_counts(mask, block: int) -> torch.Tensor:
    """(nb,) int64: the valid slots of each ``block``-slot tile of one
    list's padded (Mp,) mask stream (:func:`diameter_mask_batch`)."""
    m = torch.as_tensor(mask).bool().reshape(-1)
    if m.numel() % block:
        raise ValueError(f"a mask stream of {m.numel()} slots is not a multiple of {block}")
    return m.reshape(-1, block).sum(1)


def computed_tiles(mask, block: int, triangular: bool) -> torch.Tensor:
    """(nb, nb) bool: the tiles ``(i, j)`` whose pairs the masked tile
    kernels ('fused', 'tri', 'naive', 'tri_prefetch', 'gram') compute,
    those with a valid row and a valid column (and ``i <= j`` where
    ``triangular``): the plain mirror of ``csrc/diameter.cu``
    ``plan_tile``'s skip."""
    any_ = tile_valid_counts(mask, block) > 0
    tiles = any_[:, None] & any_[None, :]
    return torch.triu(tiles) if triangular else tiles


def _axis_squares(v, r0, rows, axes, gram):
    """Per-axis squared differences of rows ``r0:r0+rows`` against every
    slot of ``v``: ``(r - c)^2`` in float32, or with ``gram`` the augmented
    product ``[r^2, 1, -2r] @ [1, c^2, c]^T`` in float64, rounded to
    float32 (the FP64 tensor-core product of the ``gram`` kernel)."""
    out = {}
    for a in axes:
        if gram:
            r, c = v[a, r0:r0 + rows].double(), v[a].double()
            lhs = torch.stack([r * r, torch.ones_like(r), -2.0 * r], dim=1)
            rhs = torch.stack([torch.ones_like(c), c * c, c])
            out[a] = (lhs @ rhs).float()
        else:
            d = v[a, r0:r0 + rows, None] - v[a, None, :]
            out[a] = d * d
    return out


def pair_sweep(v: torch.Tensor, mask: torch.Tensor | None = None,
               combos=(0, 1, 2, 3), gram: bool = False) -> torch.Tensor:
    """Max squared distance of each of ``combos`` over all pairs of ``v``.

    ``v`` is one (3, Mp) output of :func:`diameter_input_batch`; ``combos``
    index :data:`COMBOS` ([3D, xy, xz, yz]).  With ``mask`` ((Mp,) bool,
    :func:`diameter_mask_batch`) a pair with an invalid end counts
    :data:`NEG`, as the masked kernels select it.  A combo sums its axes'
    squares left to right in float32, the kernels' order.  Row blocks
    bound the memory.  Returns ``(len(combos),)`` float32, clamped at 0.
    """
    mp = v.shape[1]
    rows = max(1, min(mp, _SWEEP_ELEMS // mp))
    axes = sorted({a for c in combos for a in COMBOS[c]})
    best = torch.full((len(combos),), NEG, dtype=torch.float32, device=v.device)
    for r0 in range(0, mp, rows):
        q = _axis_squares(v, r0, rows, axes, gram)
        valid = None if mask is None else mask[r0:r0 + rows, None] & mask[None, :]
        maxima = []
        for c in combos:
            first, *rest = COMBOS[c]
            s = q[first]
            for a in rest:
                s = s + q[a]
            if valid is not None:
                s = torch.where(valid, s, NEG)
            maxima.append(s.amax())
        best = torch.maximum(best, torch.stack(maxima))
    return best.clamp(min=0.0)


def max_diameters_sq(verts, mask, block: int = 256, variant: str = "seqacc") -> torch.Tensor:
    """Plain version of the diameter kernels: (4,) float32 squared maxima,
    the batch of one of :func:`max_diameters_sq_batch`."""
    verts = torch.as_tensor(verts, dtype=torch.float32)
    m = torch.as_tensor(mask, device=verts.device).bool()
    if verts.ndim != 2 or verts.shape[1] != 3 or m.shape != verts.shape[:1]:
        raise ValueError(f"need verts (M, 3) and mask (M,), got {tuple(verts.shape)} "
                         f"and {tuple(m.shape)}")
    return max_diameters_sq_batch(verts[None], m[None], block, variant)[0]


def max_diameters_sq_batch(verts, masks, block: int = 256,
                           variant: str = "seqacc") -> torch.Tensor:
    """Plain version of each diameter variant: (B, 4) squared maxima.

    Every variant sweeps :func:`diameter_input_batch`'s prepared input.
    ``seqacc`` and ``nomask`` sweep the filled input with no mask;
    ``fused``, ``tri`` and ``tri_prefetch`` are the masked sweep, ``naive``
    the masked sweep one combo at a time, and ``gram`` the masked sweep
    over the augmented Gram products (:func:`pair_sweep`).  A filled slot
    duplicates a valid vertex, so the direct variants agree bitwise.
    """
    if variant not in DIAMETER_VARIANTS:
        raise ValueError(f"unknown diameter variant {variant!r}; one of {DIAMETER_VARIANTS}")
    v = diameter_input_batch(verts, masks, block)
    if variant in ("seqacc", "nomask"):
        return torch.stack([pair_sweep(x) for x in v])
    m = diameter_mask_batch(masks, block, v.device)
    if variant == "naive":
        return torch.stack([torch.cat([pair_sweep(x, mk, (c,)) for c in range(len(COMBOS))])
                            for x, mk in zip(v, m)])
    return torch.stack([pair_sweep(x, mk, gram=variant == "gram") for x, mk in zip(v, m)])


def mc_volume_area_batch(vols, iso=0.5, spacings=None, chunk_z=MC_CHUNK_Z) -> torch.Tensor:
    """Plain version of the batched marching-cubes kernel: (B, 2) rows of
    ``(|sum vol|, sum area)``, per case :func:`mc_volume_area`."""
    vols = torch.as_tensor(vols, dtype=torch.float32)
    if spacings is None:
        spacings = np.ones((vols.shape[0], 3), np.float32)
    return torch.stack([torch.stack(mc_volume_area(v, iso, sp, chunk_z))
                        for v, sp in zip(vols, spacings)])


def compact_batch(verts, keep, cap: int):
    """Plain version of the compaction kernel: stable segmented compaction.

    ``verts``: (B, M, 3) float32, ``keep``: (B, M) -> ``(out, mask, n)``
    with ``out``: (B, cap, 3), ``mask``: (B, cap) bool and ``n``: (B,)
    int32.  An exclusive prefix sum over ``keep`` gives each survivor its
    slot: survivors keep their order in slots ``0..n-1``, slots past the
    survivors hold zeros and a False mask, survivors past ``cap`` are
    dropped, and ``n`` counts every survivor (before the drop), as
    ``repro.kernels.compact.compact_batch_ref`` does.
    """
    verts = torch.as_tensor(verts, dtype=torch.float32)
    k = torch.as_tensor(keep, device=verts.device).bool()
    pos = torch.cumsum(k.to(torch.int64), dim=1) - 1  # output slot per survivor
    bi, vi = (k & (pos < cap)).nonzero(as_tuple=True)
    out = torch.zeros((k.shape[0], cap, 3), dtype=torch.float32, device=verts.device)
    out[bi, pos[bi, vi]] = verts[bi, vi]
    n = k.sum(1).to(torch.int32)
    mask = torch.arange(cap, device=verts.device) < n.clamp(max=cap)[:, None]
    return out, mask, n


# ---------------------------------------------------------------------------
# intensity-family helpers (first-order / GLCM): shared quantisation contract
# ---------------------------------------------------------------------------

def intensity_range(image, mask, dim=None):
    """Masked intensity ``(lo, hi)``: exact min and max, so any reduction
    order gives the same bits.  An empty mask gives ``(0, 0)``.

    ``dim=None`` reduces the whole array (one case, as the reference);
    an int reduces that axis only (a flattened ``(B, L)`` stack: ``dim=1``).
    """
    img = torch.as_tensor(image, dtype=torch.float32)
    m = torch.as_tensor(mask, device=img.device) > 0
    if dim is None:
        img, m, dim = img.reshape(-1), m.reshape(-1), 0
    any_ = m.any(dim)
    lo = torch.where(any_, img.masked_fill(~m, float("inf")).amin(dim), 0.0)
    hi = torch.where(any_, img.masked_fill(~m, float("-inf")).amax(dim), 0.0)
    return lo, hi


def quantize_intensity(image, mask, lo, hi, n_bins: int):
    """Fixed-bin-count discretisation: float32 bin ids in ``[0, n_bins)``.

    ``(q, width)`` with ``width = (hi - lo) / n_bins`` and
    ``q = clip(floor((img - lo) / safe), 0, n_bins - 1)``, ``safe = width``
    where it is positive and 1 elsewhere; masked-out voxels go to bin 0.
    The operations and their order are the reference's, so every bin edge
    falls where it does there.  Both divisions are true divisions by a
    tensor: PyTorch on the card turns a division by a Python number into
    a multiplication by its reciprocal, which can move a bin edge.
    ``lo``/``hi`` are tensors broadcastable against ``image``.
    """
    img = torch.as_tensor(image, dtype=torch.float32)
    span = hi - lo
    width = span / torch.full_like(span, float(n_bins))
    safe = torch.where(width > 0, width, torch.ones_like(width))
    q = torch.clamp(torch.floor((img - lo) / safe), 0.0, float(n_bins - 1))
    m = torch.as_tensor(mask, device=img.device) > 0
    return torch.where(m, q, torch.zeros_like(q)), width


def check_bins(n_bins: int) -> None:
    """The bin counts both intensity kernels take (their shared histograms)."""
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins must be in [1, {MAX_BINS}], got {n_bins}")


def check_volumes(images: torch.Tensor, masks: torch.Tensor) -> None:
    """What both intensity kernels take: contiguous (B, X, Y, Z) float32
    images and masks of one shape on one CUDA device."""
    if images.device.type != "cuda" or masks.device != images.device:
        raise ValueError(f"images and masks must share one CUDA device, got "
                         f"{images.device} and {masks.device}")
    if images.dtype != torch.float32 or masks.dtype != torch.float32:
        raise ValueError(f"need float32 images and masks, got {images.dtype}, {masks.dtype}")
    if (images.ndim != 4 or masks.shape != images.shape or not images.is_contiguous()
            or not masks.is_contiguous()):
        raise ValueError(f"need contiguous (B, X, Y, Z) images and masks of one shape, got "
                         f"{tuple(images.shape)} and {tuple(masks.shape)}")
    batch, voxels = images.shape[0], images[0].numel()
    if not 1 <= batch < 2 ** 16 or not 1 <= voxels < 2 ** 31:
        raise ValueError(f"batch {batch} of {voxels}-voxel volumes is outside the "
                         f"kernels' grid")
