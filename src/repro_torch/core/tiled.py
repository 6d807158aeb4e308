"""Out-of-core tiled extraction: halo tiles, tile pruning, streamed diameter.

Counterpart of ``repro.core.tiled``.  The layer between the slab sources
(``data/tiles.py``) and the executor: it extracts the same feature row as
the in-core pipeline (``PlanExecutor.extract_one``) for a volume that never
exists whole on the host or the card.  The executor still owns the device,
the kernel choices and the host-sync census; this engine re-partitions
passes 0 to 2 into z-tiles and re-folds the partials in the in-core order.

Data flow (one case)
--------------------
1. **Census prepass** (streamed, on the card): the global nonzero and
   inside bounding boxes, per-plane occupancy and xy boxes, the masked
   intensity range (exact min and max, order-free), and for
   ``tile_prune='bounds'`` the extreme inside-voxels the tile bound needs
   (per direction the first extreme in ``np.nonzero`` order, found among
   each row's first and last inside voxel); one fetch at its end.
2. **Frame replication**: the in-core pipeline crops to the mask's bounding
   box, pads one zero plane (``crop_to_roi``) and bucket-pads to
   ``plan.shape_bucket``.  The census gives the same frame geometry without
   materialising anything: frame index = original - lo + 1.
3. **Tile sweep**: the frame is cut into z-tiles of whole marching-cubes
   granules (``mc_chunk`` cell planes each, the in-core kernel's partial
   layout), each staged on the card (``dispatcher.to_device``: pinned,
   ``non_blocking``) with a +1-plane halo, so every cell and vertex edge on
   a tile face sees the in-core neighbour values.  Edge ownership
   partitions the three vertex fields exactly: a tile owns the x- and
   y-edges on its frame planes and the z-edge slots starting there.  Per
   tile, on the card: the MC partials of its granules
   (``ops.mc_tile_partials``, the row-2 kernel) and its owned vertices'
   positions (vertex fields on an xy-subcrop, ``index_offset`` keeping the
   global frame; exact, see ``kernels/ref.vertex_fields``, gathered on the
   card); on the host: the owned active-edge masks (their counts and global
   ranks) and the first-order voxel gather.  Every tile's work is queued
   without a host sync.
4. **Hierarchical pruning**: ``'occupancy'`` skips all-zero tiles (their MC
   partials are exactly +0.0 and they own no vertices: bitwise);
   ``'bounds'`` also skips the vertex work of tiles whose inflated box
   provably holds no farthest-pair endpoint for any of the 4 diameter
   combos; ``'none'`` stages every tile.
5. **Re-fold**: the MC partials are assembled on the card into the whole
   granule grid (skipped tiles stay +0.0, the bits an empty granule gives)
   and reduced once by the in-core kernel's finalize; the owned vertices are
   ordered by their global field rank on the card -- the in-core compacted
   buffer -- then run the unchanged tail: ``ops.prune_candidates``, then
   the diameter kernel.  First-order stats fold the mask-touched canonical
   chunks through ``kernels/firstorder.fold_packed_chunks`` (the
   first-order kernel).

Every device-to-host copy goes through ``PlanExecutor._fetch`` under the
stages ``tiled_census``, ``tiled_prune``, ``tiled_shape`` and
``tiled_firstorder``, so ``strict_syncs()`` holds over a tiled extract.

Budget: ``REPRO_TILE_MEM_MB`` (default 256) bounds the staged bytes -- two
tiles' slabs (the tile being staged and the one the card may still be
reading), mask and intensity -- and each census piece (the mask at its
staged dtype, plus the image); ``staged_bytes_peak`` is the larger of the
two.  Like ``plan.meta_bytes`` it counts staged arrays, not transient
temporaries (a tile's vertex fields are about ten times its slab).  GLCM
needs neighbour pairs across tile faces and is not offered tiled
(``ValueError``).
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from repro_torch.core import plan as planlib
from repro_torch.core.dispatcher import to_device
from repro_torch.kernels import firstorder as _fo
from repro_torch.kernels import masked_range as _range
from repro_torch.kernels import ops
from repro_torch.kernels import prune as _prune

DEFAULT_TILE_MEM_MB = 256.0
TILE_PRUNE_LEVELS = ("none", "occupancy", "bounds")

_SUBCROP_STEP = 16  # xy-subcrop dims bucket
# mask dtypes the census stages as they are; any other is widened to float64
_DEVICE_DTYPES = {np.dtype(t) for t in (np.bool_, np.uint8, np.int16, np.int32, np.int64,
                                        np.float32, np.float64)}
_warned_env: set = set()


def _env_float(name: str, default: float) -> float:
    """Float from the environment; a malformed value warns once and falls
    back to the default, an unset or empty one is the default."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        if name not in _warned_env:
            _warned_env.add(name)
            warnings.warn(f"malformed {name}={raw!r} in the environment; falling back "
                          f"to the default {default!r}", RuntimeWarning, stacklevel=2)
        return default


def tile_budget_bytes() -> int:
    """The configured staged-bytes budget (``REPRO_TILE_MEM_MB``)."""
    return int(_env_float("REPRO_TILE_MEM_MB", DEFAULT_TILE_MEM_MB) * 2**20)


def _first(flags, idx, none):
    """Smallest ``idx`` where ``flags`` holds, over dim 0 (``none`` where
    it holds nowhere)."""
    return torch.where(flags, idx, none).amin(0)


def _last(flags, idx):
    """Largest ``idx`` where ``flags`` holds, over dim 0 (-1 where nowhere)."""
    return torch.where(flags, idx, -1).amax(0)


def _row_extremes(ins, iny, z_off, depth):
    """Candidate extreme inside voxels of a piece of a census chunk.

    A linear function's maximum over the inside voxels of one (y, z) row
    lies at the row's first or last inside x, so those two per row are
    the only candidates the witnesses need.  The piece starts ``z_off``
    planes into a chunk of ``depth`` planes.  Returns ``(pts, key, ok)``:
    (2 Y dz, 3) chunk-local coordinates, their rank in the chunk's (x, y,
    z) order and whether the row has an inside voxel.
    """
    X, Y, dz = ins.shape
    u8 = ins.to(torch.uint8)
    first = u8.argmax(0)  # the first maximal index: the first inside x
    last = X - 1 - u8.flip(0).argmax(0)
    yy, zz = torch.meshgrid(torch.arange(Y, device=ins.device),
                            torch.arange(z_off, z_off + dz, device=ins.device),
                            indexing="ij")
    x = torch.cat([first.reshape(-1), last.reshape(-1)])
    y, z = yy.reshape(-1).repeat(2), zz.reshape(-1).repeat(2)
    return torch.stack([x, y, z], 1), (x * Y + y) * depth + z, iny.reshape(-1).repeat(2)


def _staged_mask(raw):
    """A mask slab as the census stages it: its own dtype where the device
    takes it, else widened to float64."""
    raw = np.asarray(raw)
    return raw if raw.dtype in _DEVICE_DTYPES else raw.astype(np.float64)


@dataclasses.dataclass
class TiledResult:
    """One tiled case's row, its planning metadata and its tile stats."""

    row: np.ndarray
    meta: planlib.CaseMeta
    stats: dict


@dataclasses.dataclass
class _Census:
    """Host prepass summary (see the module docstring, step 1)."""

    empty: bool
    lo: np.ndarray = None          # (3,) nonzero bbox lower corner (orig)
    hi: np.ndarray = None          # (3,) nonzero bbox upper corner (orig)
    plane_any: np.ndarray = None   # (Z,) any nonzero mask on orig plane z
    plane_box: np.ndarray = None   # (Z, 4) inside-voxel xlo,xhi,ylo,yhi
    int_lo: float = 0.0            # masked intensity range (exact min/max)
    int_hi: float = 0.0
    witnesses: np.ndarray = None   # (W, 3) extreme inside-voxel coords (orig)
    staged_bytes: int = 0          # the largest piece the census staged


class TiledExtractor:
    """Drives one :class:`~repro_torch.data.tiles.TiledCase` through the
    tiled pipeline on an executor's device, kernels and fetch census."""

    def __init__(self, executor, budget_bytes: int | None = None,
                 tile_prune: str = "bounds"):
        if tile_prune not in TILE_PRUNE_LEVELS:
            raise ValueError(
                f"tile_prune must be one of {TILE_PRUNE_LEVELS}, got {tile_prune!r}"
            )
        for fam in executor.families:
            if fam not in ("shape", "firstorder"):
                raise ValueError(
                    f"feature family {fam!r} is not supported in tiled mode "
                    "(GLCM needs neighbour pairs across tile faces); run it "
                    "in-core or request shape/firstorder only"
                )
        self.ex = executor
        self.budget_bytes = (tile_budget_bytes() if budget_bytes is None
                             else int(budget_bytes))
        self.tile_prune = tile_prune

    # -- census prepass -----------------------------------------------------

    def _census(self, case) -> _Census:
        """The census prepass on the executor's device: each chunk of
        planes is staged once and reduced there into running accumulators,
        which one counted fetch (``tiled_census``) brings back."""
        ex = self.ex
        dev = ex.device
        X, Y, Z = case.shape
        need_int = ex._needs_intensity
        need_wit = self.tile_prune == "bounds" and ex._shape_on
        i64, f64 = torch.int64, torch.float64
        plane_any = torch.zeros(Z, dtype=torch.bool, device=dev)
        plane_box = torch.full((Z, 4), -1, dtype=i64, device=dev)
        lo = to_device(np.asarray([X, Y, Z], np.int64), dev)
        hi = torch.full((3,), -1, dtype=i64, device=dev)
        int_lo = torch.full((), np.inf, dtype=torch.float32, device=dev)
        int_hi = torch.full((), -np.inf, dtype=torch.float32, device=dev)
        ix, iy = torch.arange(X, device=dev), torch.arange(Y, device=dev)
        if need_wit:
            dirs = to_device(_prune._directions((0, 1, 2), ex.k_dirs), dev, f64)  # (K, 3)
            sp64 = to_device(np.asarray(case.spacing, np.float64), dev, f64)
            pmax = torch.full((len(dirs),), -np.inf, dtype=f64, device=dev)
            pmin = torch.full((len(dirs),), np.inf, dtype=f64, device=dev)
            wmax = torch.zeros((len(dirs), 3), dtype=i64, device=dev)
            wmin = torch.zeros((len(dirs), 3), dtype=i64, device=dev)

        # census chunks: the reference's (a float32 mask slab the budget
        # could stage), so the witnesses break ties as its do; each is
        # staged in pieces whose bytes (the mask at its staged dtype, plus
        # the float32 image for an intensity family) fit the budget
        step = max(1, min(Z, self.budget_bytes // max(1, X * Y * 4)))
        per_voxel = _staged_mask(case.mask_slab(0, 1)).itemsize + 4 * need_int
        piece = max(1, min(step, self.budget_bytes // max(1, X * Y * per_voxel)))
        peak = 0
        for c0 in range(0, Z, step):
            c1 = min(c0 + step, Z)
            if need_wit:  # the chunk's extremes: the first in its (x, y, z) order
                big = torch.iinfo(i64).max
                ctop = torch.full((len(dirs),), -np.inf, dtype=f64, device=dev)
                cbot = torch.full((len(dirs),), np.inf, dtype=f64, device=dev)
                ktop = torch.full((len(dirs),), big, dtype=i64, device=dev)
                kbot = torch.full((len(dirs),), big, dtype=i64, device=dev)
                ptop = torch.zeros((len(dirs), 3), dtype=i64, device=dev)
                pbot = torch.zeros((len(dirs), 3), dtype=i64, device=dev)
            for z0 in range(c0, c1, piece):
                z1 = min(z0 + piece, c1)
                raw = _staged_mask(case.mask_slab(z0, z1))
                sl = to_device(raw, dev)
                staged = raw.nbytes
                iz = torch.arange(z0, z1, device=dev)
                nz = sl != 0
                anyz = nz.any(0).any(0)
                plane_any[z0:z1] = anyz
                xany, yany = nz.any(2).any(1), nz.any(2).any(0)
                lo = torch.minimum(lo, torch.stack([_first(xany, ix, X), _first(yany, iy, Y),
                                                    _first(anyz, iz, Z)]))
                hi = torch.maximum(hi, torch.stack([_last(xany, ix), _last(yany, iy),
                                                    _last(anyz, iz)]))
                ins = sl > 0.5  # iso-inside voxels: what vertices attach to
                inx, iny = ins.any(1), ins.any(0)  # (X, dz), (Y, dz)
                box = torch.stack([_first(inx, ix[:, None], X), _last(inx, ix[:, None]),
                                   _first(iny, iy[:, None], Y), _last(iny, iy[:, None])], 1)
                plane_box[z0:z1] = torch.where(inx.any(0)[:, None], box, -1)
                if need_wit:
                    pts, key, ok = _row_extremes(ins, iny, z0 - c0, c1 - c0)
                    pts[:, 2] += c0
                    proj = (pts.to(f64) * sp64) @ dirs.T  # (candidates, K)
                    top = torch.where(ok[:, None], proj, -np.inf).amax(0)
                    bot = torch.where(ok[:, None], proj, np.inf).amin(0)
                    jt = torch.where(ok[:, None] & (proj == top), key[:, None], big).argmin(0)
                    jb = torch.where(ok[:, None] & (proj == bot), key[:, None], big).argmin(0)
                    # within a chunk a tie goes to the smaller key
                    up = (top > ctop) | ((top == ctop) & (key[jt] < ktop))
                    down = (bot < cbot) | ((bot == cbot) & (key[jb] < kbot))
                    ctop, cbot = torch.where(up, top, ctop), torch.where(down, bot, cbot)
                    ktop, kbot = torch.where(up, key[jt], ktop), torch.where(down, key[jb], kbot)
                    ptop = torch.where(up[:, None], pts[jt], ptop)
                    pbot = torch.where(down[:, None], pts[jb], pbot)
                if need_int and (raw > 0).any():  # the intensity-family mask rule
                    img_np = np.asarray(case.image_slab(z0, z1), np.float32)
                    staged += img_np.nbytes
                    img = to_device(img_np, dev)
                    # the piece's range, a batch of one (it holds a masked voxel)
                    plo, phi = _range.masked_range_batch(img[None],
                                                         (sl > 0).to(torch.float32)[None])
                    int_lo = torch.minimum(int_lo, plo[0])
                    int_hi = torch.maximum(int_hi, phi[0])
                peak = max(peak, staged)
            if need_wit:  # across chunks a tie keeps the earlier chunk's
                up, down = ctop > pmax, cbot < pmin
                pmax, pmin = torch.where(up, ctop, pmax), torch.where(down, cbot, pmin)
                wmax = torch.where(up[:, None], ptop, wmax)
                wmin = torch.where(down[:, None], pbot, wmin)
        parts = [plane_any, plane_box.reshape(-1), lo, hi, int_lo[None], int_hi[None]]
        if need_wit:
            parts += [wmax.reshape(-1), wmin.reshape(-1)]
        flat = ex._fetch("tiled_census", torch.cat([p.to(f64) for p in parts]))
        plane_any = flat[:Z] != 0
        plane_box = flat[Z:5 * Z].reshape(Z, 4).astype(np.int64)
        lo, hi = (flat[5 * Z + 3 * i:5 * Z + 3 * i + 3].astype(np.int64) for i in range(2))
        int_lo, int_hi = (float(np.float32(v)) for v in flat[5 * Z + 6:5 * Z + 8])
        if hi[0] < 0:
            return _Census(empty=True, staged_bytes=peak)
        wit = (np.unique(flat[5 * Z + 8:].reshape(-1, 3).astype(np.int64), axis=0)
               if need_wit else None)
        return _Census(
            empty=False, lo=lo, hi=hi, plane_any=plane_any, plane_box=plane_box,
            int_lo=0.0 if np.isinf(int_lo) else int_lo,
            int_hi=0.0 if np.isinf(int_hi) else int_hi,
            witnesses=wit, staged_bytes=peak,
        )

    # -- tile-level bounds pruning ------------------------------------------

    @staticmethod
    def _combo_lowers(witnesses, sp64):
        """(4,) conservative lower bounds on the combo diameters (f64).

        Max pairwise distance among the direction-extreme inside-voxel
        centres, per combo projection, minus ``2 * max(spacing)``: every
        inside extreme voxel has an outside axis-neighbour (otherwise a
        farther projection would exist), so a mesh vertex lies within
        ``max(spacing)`` of its centre.
        """
        pts = witnesses * sp64  # physical centres, shift-invariant below
        slack = 2.0 * sp64.max()
        out = np.zeros(4)
        for ci, combo in enumerate(_prune.COMBOS):
            p = pts[:, combo]
            d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
            out[ci] = max(np.sqrt(d2.max()) - slack, 0.0)
        return out

    @staticmethod
    def _tile_upper(tbox_lo, tbox_hi, gbox_lo, gbox_hi, sp64):
        """(4,) upper bounds on any tile-vertex-to-anywhere distance.

        Boxes are inside-voxel index boxes inflated by one voxel (a vertex
        sits on an edge of an inside voxel, within one index step per
        axis), mapped to physical space per axis.
        """
        t_lo = (tbox_lo - 1.0) * sp64
        t_hi = (tbox_hi + 1.0) * sp64
        g_lo = (gbox_lo - 1.0) * sp64
        g_hi = (gbox_hi + 1.0) * sp64
        per_axis = np.maximum(np.maximum(g_hi - t_lo, t_hi - g_lo), 0.0)
        return np.array([np.sqrt((per_axis[list(c)] ** 2).sum()) for c in _prune.COMBOS])

    # -- the main sweep ------------------------------------------------------

    def extract(self, case) -> TiledResult:
        ex = self.ex
        fetches0 = dict(ex.transfer_log)
        t0 = time.perf_counter()
        cen = self._census(case)
        t_census = time.perf_counter() - t0
        sp = np.asarray(case.spacing, np.float32)
        if cen.empty:
            meta = planlib.CaseMeta(shape=None, roi_shape=None, vertex_cap=0, n_vertices=0,
                                    intensity=ex._needs_intensity)
            return TiledResult(np.zeros(ex.n_features, np.float32), meta,
                               {"tiles": 0, "tiles_skipped": 0, "tiles_bounds_pruned": 0})
        if ex._needs_intensity and case.image_source is None:
            raise ValueError(
                "intensity families requested but the TiledCase has no image source"
            )

        # frame geometry: crop_to_roi pad=1 + shape_bucket, from metadata
        lo, hi = cen.lo, cen.hi
        extent = hi - lo + 1
        roi_shape = tuple(int(e) + 2 for e in extent)
        bshape = planlib.shape_bucket(tuple(int(e) for e in extent))
        Xb, Yb, Zb = bshape
        fo = lo - 1  # frame index = original - fo
        ext_x, ext_y, ext_z = (int(e) for e in extent)

        # frame-plane census (frame plane p holds original plane p + fo[2])
        f_any = np.zeros(Zb, bool)
        f_box = np.full((Zb, 4), -1, np.int64)
        f_any[1:ext_z + 1] = cen.plane_any[lo[2]:hi[2] + 1]
        fb = cen.plane_box[lo[2]:hi[2] + 1].copy()
        has = fb[:, 1] >= 0
        fb[has, 0] -= fo[0]
        fb[has, 1] -= fo[0]
        fb[has, 2] -= fo[1]
        fb[has, 3] -= fo[1]
        f_box[1:ext_z + 1] = fb

        # MC granule (the in-core layout's) + tile sizing under the budget
        mc_block, cz = ex._resolve_mc(bshape)
        n_slabs = -(-(Zb - 1) // cz)
        n_int = 1 + int(ex._needs_intensity)
        plane_bytes = Xb * Yb * 4 * n_int
        # two tiles alive at once (the one staged, the one the card reads)
        g = max(1, int((self.budget_bytes / 2 / plane_bytes - 1) // cz))
        tile_bytes = plane_bytes * (g * cz + 1)
        if 2 * tile_bytes > self.budget_bytes:
            warnings.warn(
                f"tile budget {self.budget_bytes} B cannot hold two minimal "
                f"{tile_bytes} B tiles of frame {bshape}; proceeding with "
                "1-granule tiles over budget",
                RuntimeWarning, stacklevel=2,
            )
        n_tiles = -(-n_slabs // g)

        # global bounds-pruning threshold
        do_bounds = (self.tile_prune == "bounds" and ex._shape_on
                     and cen.witnesses is not None)
        sp64 = np.asarray(sp, np.float64)
        if do_bounds:
            lowers = self._combo_lowers(cen.witnesses - fo, sp64)
            rows = np.nonzero(f_box[:, 1] >= 0)[0]
            g_ins_lo = np.array([f_box[rows, 0].min(), f_box[f_box[:, 3] >= 0, 2].min(),
                                 rows.min()], np.float64)
            g_ins_hi = np.array([f_box[:, 1].max(), f_box[:, 3].max(), rows.max()],
                                np.float64)

        shape_on = ex._shape_on
        needs_int = ex._needs_intensity
        dev = ex.device
        mc_parts = []                  # (k0, k1, vol_p, area_p) on the device
        rank_list, pos_list = [], []   # owned vertices: host ranks, device positions
        fo_chunks: dict[int, list] = {}
        n_total = 0
        skipped = bounds_pruned = 0

        for t in range(n_tiles):
            k0, k1 = t * g, min((t + 1) * g, n_slabs)
            pz0 = k0 * cz
            pz_halo = min(k1 * cz + 1, Zb)          # planes with frame data
            own_end = k1 * cz if t < n_tiles - 1 else Zb  # x/y-edge planes
            dz = (k1 - k0) * cz + 1                 # staged depth (padded)

            if self.tile_prune != "none" and not f_any[pz0:pz_halo].any():
                skipped += 1
                continue

            # stage the frame slab (zeros frame + source window paste)
            slab = np.zeros((Xb, Yb, dz), np.float32)
            a, b = max(pz0, 1), min(pz_halo, ext_z + 1)
            if a < b:
                src = np.asarray(case.mask_slab(a + fo[2], b + fo[2]))
                slab[1:ext_x + 1, 1:ext_y + 1, a - pz0:b - pz0] = src[lo[0]:hi[0] + 1,
                                                                      lo[1]:hi[1] + 1]

            if shape_on:
                # MC partials of the tile's granules, left on the card
                vol_p, area_p = ops.mc_tile_partials(
                    to_device(slab, dev), 0.5, sp, device=dev, k0=k0, chunk_z=cz,
                    full_shape=bshape, block=mc_block,
                )
                mc_parts.append((k0, k1, vol_p, area_p))

                # owned active edges (host): counts always, positions unless
                # the tile bound proves it holds no farthest-pair endpoint
                inside = slab > 0.5
                ax = inside[:-1, :, :] != inside[1:, :, :]
                ay = inside[:, :-1, :] != inside[:, 1:, :]
                az = inside[:, :, :-1] != inside[:, :, 1:]
                o = own_end - pz0
                if t < n_tiles - 1:
                    ax, ay = ax[:, :, :o], ay[:, :, :o]
                n_tile = sum(int(np.count_nonzero(e)) for e in (ax, ay, az))
                n_total += n_tile

                pruned = False
                if do_bounds and n_tile:
                    tb = f_box[pz0:pz_halo]
                    thas = np.nonzero(tb[:, 1] >= 0)[0]
                    t_lo = np.array([tb[thas, 0].min(), tb[thas, 2].min(),
                                     pz0 + thas.min()], np.float64)
                    t_hi = np.array([tb[thas, 1].max(), tb[thas, 3].max(),
                                     pz0 + thas.max()], np.float64)
                    ups = self._tile_upper(t_lo, t_hi, g_ins_lo, g_ins_hi, sp64)
                    pruned = bool((ups * (1.0 + 1e-9) < lowers).all())
                if pruned:
                    bounds_pruned += 1
                elif n_tile:
                    self._emit_vertices(slab, (ax, ay, az), f_box, pz0, pz_halo, sp,
                                        bshape, rank_list, pos_list)

            # first-order voxel gather over OWNED planes
            if needs_int:
                o1 = min(own_end, Zb) - pz0
                mm = slab[:, :, :o1] > 0
                if mm.any():
                    img = np.zeros((Xb, Yb, dz), np.float32)
                    if a < b:
                        isrc = np.asarray(case.image_slab(a + fo[2], b + fo[2]))
                        img[1:ext_x + 1, 1:ext_y + 1, a - pz0:b - pz0] = isrc[
                            lo[0]:hi[0] + 1, lo[1]:hi[1] + 1]
                    xs, ys, zs = np.nonzero(mm)
                    flat = (xs.astype(np.int64) * Yb + ys) * Zb + (zs + pz0)
                    self._scatter_chunks(fo_chunks, flat, img[xs, ys, zs])

        # -- re-fold ---------------------------------------------------------
        t_sweep = time.perf_counter() - t0 - t_census
        parts = [
            self._finish_shape(mc_parts, n_slabs, rank_list, pos_list, n_total)
            if family == "shape" else self._finish_firstorder(fo_chunks, cen)
            for family in ex.families
        ]
        row = parts[0] if len(parts) == 1 else np.concatenate(parts)

        cap = planlib.vertex_bucket(max(n_total, 1)) if shape_on else 0
        meta = planlib.CaseMeta(shape=bshape, roi_shape=roi_shape, vertex_cap=cap,
                                n_vertices=n_total, intensity=needs_int)
        stats = {
            "tiles": n_tiles, "tiles_skipped": skipped,
            "tiles_bounds_pruned": bounds_pruned,
            "granule_cz": cz, "granules_per_tile": g,
            "tile_bytes": tile_bytes, "budget_bytes": self.budget_bytes,
            "census_bytes_peak": cen.staged_bytes,
            "staged_bytes_peak": max(cen.staged_bytes, 2 * tile_bytes),
            "n_vertices": n_total,
            "emitted_vertices": sum(len(r) for r in rank_list),
            "host_fetches": {k: v - fetches0.get(k, 0) for k, v in ex.transfer_log.items()
                             if v - fetches0.get(k, 0)},
            # host clock: the census (to its fetch), the sweep (queued, not
            # waited for), the re-fold (to its last fetch)
            "seconds": {"census": t_census, "sweep": t_sweep,
                        "refold": time.perf_counter() - t0 - t_census - t_sweep},
        }
        return TiledResult(row.astype(np.float32), meta, stats)

    # -- per-tile helpers ----------------------------------------------------

    def _emit_vertices(self, slab, active, f_box, pz0, pz_halo, sp, bshape, rank_list,
                       pos_list):
        """Vertex fields of the tile's xy-subcrop on the card; appends each
        owned field's global ranks (host) and gathered positions (device).

        The subcrop spans the tile's inside-voxel xy box inflated by one
        (every active edge has an inside endpoint, and the frame border is
        all-zero by construction), bucketed to :data:`_SUBCROP_STEP`; the
        excess is zero-extended, which activates nothing.  Owned active
        indices come from the host edge masks (the same exact comparisons
        the fields make), so the positions are gathered on the card with
        no round trip.
        """
        dev = self.ex.device
        Xb, Yb, Zb = bshape
        dz = slab.shape[2]
        tb = f_box[pz0:pz_halo]
        thas = tb[:, 1] >= 0
        sx0 = max(int(tb[thas, 0].min()) - 1, 0)
        sy0 = max(int(tb[thas, 2].min()) - 1, 0)
        sx1 = min(int(tb[thas, 1].max()) + 2, Xb)
        sy1 = min(int(tb[thas, 3].max()) + 2, Yb)
        sxb = -(-(sx1 - sx0) // _SUBCROP_STEP) * _SUBCROP_STEP
        syb = -(-(sy1 - sy0) // _SUBCROP_STEP) * _SUBCROP_STEP
        sub = np.zeros((sxb, syb, dz), np.float32)
        cx, cy = min(sx0 + sxb, Xb) - sx0, min(sy0 + syb, Yb) - sy0
        sub[:cx, :cy] = slab[sx0:sx0 + cx, sy0:sy0 + cy]

        fields = ops.vertex_fields(to_device(sub, dev), 0.5, sp,
                                   index_offset=np.asarray([sx0, sy0, pz0], np.float32))
        off_y = (Xb - 1) * Yb * Zb
        off_z = off_y + Xb * (Yb - 1) * Zb
        specs = [
            (fields.vx, (sxb - 1, syb, dz), 0, Yb, Zb),
            (fields.vy, (sxb, syb - 1, dz), off_y, Yb - 1, Zb),
            (fields.vz, (sxb, syb, dz - 1), off_z, Yb, Zb - 1),
        ]
        for act, (pos, fshape, roff, ry, rz) in zip(active, specs):
            ii, jj, ll = np.nonzero(act[sx0:sx1, sy0:sy1])  # every active edge lies there
            if not len(ii):
                continue
            ii, jj, gz = ii + sx0, jj + sy0, ll + pz0  # global frame coords
            rank_list.append(roff + ((ii.astype(np.int64) * ry + jj) * rz + gz))
            # local indices into the subcrop field
            flat = ((ii - sx0).astype(np.int64) * fshape[1] + (jj - sy0)) * fshape[2] + ll
            pos_list.append(pos.reshape(-1, 3).index_select(0, to_device(flat, dev)))

    @staticmethod
    def _scatter_chunks(chunks: dict, flat: np.ndarray, vals: np.ndarray):
        """Accumulate masked voxels into canonical-chunk buffers."""
        C = _fo.CANON_CHUNK
        cids = flat // C
        offs = flat % C
        uniq, starts = np.unique(cids, return_index=True)
        bounds = list(starts) + [len(flat)]
        for u, s, e in zip(uniq, bounds[:-1], bounds[1:]):
            buf = chunks.get(int(u))
            if buf is None:
                buf = chunks[int(u)] = [np.zeros(C, np.float32), np.zeros(C, np.float32)]
            buf[0][offs[s:e]] = vals[s:e]
            buf[1][offs[s:e]] = 1.0

    # -- re-fold helpers -----------------------------------------------------

    def _finish_shape(self, mc_parts, n_slabs, rank_list, pos_list, n_total):
        ex = self.ex
        dev = ex.device
        if mc_parts:
            # the whole granule grid; skipped tiles stay exact +0.0
            full = [torch.zeros((n_slabs,) + tuple(mc_parts[0][2].shape[1:]),
                                dtype=torch.float32, device=dev) for _ in range(2)]
            for k0, k1, vol_p, area_p in mc_parts:
                full[0][k0:k1] = vol_p
                full[1][k0:k1] = area_p
            vol, area = ops.mc_tile_finalize(*full)
        else:
            vol = area = torch.zeros((), dtype=torch.float32, device=dev)

        # streamed farthest pair: the global-rank order reproduces the
        # in-core compacted buffer; then the unchanged tail
        if pos_list:
            order = np.argsort(np.concatenate(rank_list), kind="stable")
            n_emitted = len(order)
            cap = planlib.vertex_bucket(n_emitted)
            verts = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
            verts[:n_emitted] = torch.cat(pos_list).index_select(0, to_device(order, dev))
            vmask = torch.arange(cap, device=dev) < n_emitted
            if ex.prune:
                verts, vmask, _ = ops.prune_candidates(
                    verts, vmask, k_dirs=ex.k_dirs,
                    fetch=lambda x: ex._fetch("tiled_prune", x))
            variant, block = ex._resolve_diameter(len(verts))
            d = ops.max_diameters(verts, vmask, device=dev, block=block, variant=variant)
        else:
            d = torch.zeros(4, dtype=torch.float32, device=dev)
        out = ex._fetch("tiled_shape", torch.cat([torch.stack([vol, area]), d]))
        return np.concatenate([out, np.asarray([n_total], np.float32)])

    def _finish_firstorder(self, chunks: dict, cen: _Census):
        ex = self.ex
        if not chunks:
            return np.zeros(_fo.N_FEATURES, np.float32)
        cids = sorted(chunks)
        C = _fo.CANON_CHUNK
        x = np.zeros((len(cids), C), np.float32)
        m = np.zeros((len(cids), C), np.float32)
        for i, cid in enumerate(cids):
            x[i], m[i] = chunks[cid]
        rng = to_device(np.asarray([cen.int_lo, cen.int_hi], np.float32), ex.device)
        packed = _fo.fold_packed_chunks(to_device(x, ex.device), to_device(m, ex.device),
                                        rng[0], rng[1], n_bins=ex.n_bins)
        return ex._family_row("firstorder", ex._fetch("tiled_firstorder", packed))
