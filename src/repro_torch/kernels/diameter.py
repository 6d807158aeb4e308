"""Maximum pairwise vertex distances (3D + three planes): CUDA kernel wrappers.

Replaces ``repro.kernels.diameter.max_diameters_sq_pallas`` and
``max_diameters_pallas`` in every variant of the reference (:data:`VARIANTS`,
the paper's Fig. 1 axis): ``seqacc`` (TPU kernel ``_kernel_seqacc``, the
default), ``fused``, ``tri`` and ``naive`` (``_kernel_partial``),
``tri_prefetch`` and ``gram`` (``_kernel_tri_prefetch`` with
``_pairwise_combos`` or ``_pairwise_combos_gram``) and ``nomask``
(``_kernel_nomask``).  The paper's hot spot: 95.7-99.9% of shape time goes
to this farthest-pair sweep.  The kernels are in ``csrc/diameter.cu``,
which says what bounds them and how each variant's grid and streams
differ.  The main path's two (``seqacc`` and ``nomask``, the ones
``'auto'`` picks) sweep only each list's valid extent, on a persistent
grid of register-tiled blocks; the others give each block one tile of
the whole padded list.  ``fused``, ``tri``, ``naive``, ``tri_prefetch``
(register-tiled rows, as the sweep) and ``gram`` (FP64 ``mma.sync``
m16n8k4) apply the mask outside their pair loop: a tile with no valid row
or no valid column writes an empty partial, only a tile's valid columns
are staged, and an invalid row's maxima are reset once
(``csrc/diameter.cu`` ``plan_tile``).  ``tri_prefetch`` runs ``tri``'s
tile body on the upper-triangle tiles only, each block reading its tile
from the (2, T) schedule in device memory (the reference's scalar
prefetch), where ``tri`` launches the full grid and returns below the
diagonal.

Every variant sweeps the same prepared input
(:func:`repro_torch.kernels.ref.diameter_input_batch`): invalid slots
filled with the first valid vertex, transposed to SoA and padded to the
block.  The masked variants also read the padded mask
(:func:`repro_torch.kernels.ref.diameter_mask_batch`), ``seqacc`` and
``nomask`` each list's extent (:func:`repro_torch.kernels.ref.list_extent`,
computed on the device: no host sync).  On the same input each kernel's
maxima equal its plain version's
(:func:`repro_torch.kernels.ref.max_diameters_sq_batch`, which sweeps the
whole padded list) bitwise, and the direct variants (all but ``gram``)
equal each other's: a filled slot duplicates a valid vertex.  ``gram``
forms each squared difference from the Gram identity in float64 and
rounds it once, so its bits may differ from the direct sweep's in the
last place.  One launch sweeps a (B, M) stack
(:func:`max_diameters_sq_batch`), pass 2b of the batched pipeline; the
single-case :func:`max_diameters_sq` is its batch of one, and a case's row
is the same bits alone or in a stack.  ``naive`` launches its kernel four
times, one combo each.

:func:`computed_pairs`, :func:`flop_estimate`, :func:`tensor_flop_estimate`
and :func:`bytes_estimate` count each variant's work from the CUDA source,
from a list's mask where the kernel skips by it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.dispatcher import await_shared, stream_shared, to_device
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

VARIANTS = _ref.DIAMETER_VARIANTS
DEFAULT_VARIANT = "seqacc"
# tile side, and the unit each list is padded to: without the autotuner,
# the block with the smallest mean and worst loss against each key's best
# over the card's sweep of buckets 512-131072 at depths 1-16 (PERF.md, section 6)
DEFAULT_BLOCK = 128
# The revision of the kernels and of the tuner's probes: an autotune record
# measured against another one is swept again (runtime/autotune.py).  2:
# 'seqacc' and 'nomask' sweep each list's extent on persistent
# register-tiled blocks; 3: a static target is tuned under a key of its
# own, on lists 1/32 full.
REVISION = 3
# kernel launches on CUDA tensors per variant, single-case and batched
# ('naive' counts its four launches)
LAUNCHES = dict.fromkeys(VARIANTS, 0)

_FULL_GRID = ("naive", "fused", "tri")  # csrc diameter_partial_launch
_SWEEP_KIND = {"seqacc": 0, "nomask": 1}  # diameter_sweep_launch
_ALL_COMBOS = 0xF
_SCHEDULES: dict = {}  # (nb, device) -> (2, T) int32 tile schedule on the card, its event
_RESIDENT: dict = {}  # (block, kind, device) -> sweep blocks the card holds at once

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "diameter_sweep_resident": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    "diameter_sweep_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "diameter_partial_launch": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "diameter_sched_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
}


def check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown diameter variant {variant!r}; one of {VARIANTS}")


def _check_inputs(verts, mask, block):
    if verts.device.type != "cuda" or mask.device != verts.device:
        raise ValueError(f"verts and mask must share one CUDA device, got "
                         f"{verts.device} and {mask.device}")
    if verts.dtype != torch.float32 or mask.dtype != torch.bool:
        raise ValueError(f"need float32 verts and bool mask, got {verts.dtype}, {mask.dtype}")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"block must be a multiple of 32 in [32, 1024], got {block}")


def _tiles(variant: str, nb: int) -> int:
    """Tiles one list's launch covers: the full grid or the upper triangle."""
    return nb * nb if variant in _FULL_GRID else nb * (nb + 1) // 2


def _schedule(nb: int, device: torch.device) -> torch.Tensor:
    """The (2, T) colex upper-triangle schedule on ``device``, built once
    per ``nb`` and device (pinned, ``non_blocking``: no host sync) and
    ready for the current stream, whichever stream built it."""
    key = (nb, device)
    shared = _SCHEDULES.get(key)
    if shared is None:
        shared = _SCHEDULES[key] = stream_shared(to_device(_ref.tile_schedule(nb), device),
                                                 device)
    return await_shared(shared, device)


def sweep_rows(block: int) -> int:
    """Row vertices each thread of the ``seqacc``/``nomask`` sweep holds at
    tile side ``block``: the largest of 8, 4, 2, 1 that leaves ``block / R``
    a multiple of 32 (``csrc/diameter.cu`` ``sweep_shape``)."""
    return next(r for r in (8, 4, 2, 1) if block % (32 * r) == 0)


def sweep_grid(lib, block: int, variant: str, batch: int, ntiles: int,
               device: torch.device) -> int:
    """Persistent blocks per list of a ``seqacc``/``nomask`` launch: the
    blocks the card holds at once, split over the ``batch`` lists, never
    more than a list's ``ntiles`` tiles.  Depends on the padded shape
    only, never on an extent (no host sync)."""
    key = (block, variant, device)
    resident = _RESIDENT.get(key)
    if resident is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = lib.diameter_sweep_resident(block, _SWEEP_KIND[variant], ctypes.byref(out))
        _build.check(lib, err, f"diameter_sweep_resident[{variant}, {block}]")
        resident = _RESIDENT[key] = max(1, out.value)
    return max(1, min(ntiles, -(-resident // batch)))


def max_diameters_sq(verts: torch.Tensor, mask: torch.Tensor, *,
                     block: int = DEFAULT_BLOCK, variant: str = DEFAULT_VARIANT) -> torch.Tensor:
    """(4,) float32 squared maxima [3D, xy(Slice), xz(Row), yz(Column)].

    ``verts``: (M, 3) float32, ``mask``: (M,) bool, at least one valid.  The
    batch of one of :func:`max_diameters_sq_batch`.
    """
    return max_diameters_sq_batch(verts[None], mask[None], block=block, variant=variant)[0]


def max_diameters(verts, mask, *, block: int = DEFAULT_BLOCK,
                  variant: str = DEFAULT_VARIANT) -> torch.Tensor:
    """(4,) float32 diameters [3D, Slice(xy), Row(xz), Column(yz)]."""
    return torch.sqrt(max_diameters_sq(verts, mask, block=block, variant=variant))


def max_diameters_sq_batch(verts: torch.Tensor, masks: torch.Tensor, *,
                           block: int = DEFAULT_BLOCK,
                           variant: str = DEFAULT_VARIANT) -> torch.Tensor:
    """(B, 4) float32 squared maxima, row b those of ``verts[b]``.

    ``verts``: (B, M, 3) float32, ``masks``: (B, M) bool, each case with at
    least one valid slot; ``variant`` one of :data:`VARIANTS`.  A CUDA
    tensor launches that variant's kernel (or raises); only a CPU tensor
    takes its plain version.
    """
    check_variant(variant)
    if verts.device.type == "cpu":
        return _ref.max_diameters_sq_batch(verts, masks, block, variant)
    return batch_launcher(verts, masks, block=block, variant=variant)()


def batch_launcher(verts: torch.Tensor, masks: torch.Tensor, *, block: int = DEFAULT_BLOCK,
                   variant: str = DEFAULT_VARIANT):
    """The kernel launch of :func:`max_diameters_sq_batch` on CUDA tensors,
    its input prepared here, once: a callable that launches ``variant``'s
    kernel on that input and returns the (B, 4) maxima.  The autotuner
    times it alone."""
    check_variant(variant)
    _check_inputs(verts, masks, block)
    batch = verts.shape[0]
    if not 1 <= batch < 2 ** 16:
        raise ValueError(f"batch of {batch} vertex lists is outside the kernel's grid")
    v = _ref.diameter_input_batch(verts, masks, block)
    mp = v.shape[2]
    nb = mp // block
    ntiles = _tiles(variant, nb)
    if mp >= 2 ** 31 or ntiles >= 2 ** 31:
        raise ValueError(f"{mp} vertices exceed the kernel's grid")
    lib = _build.load("diameter", _SIGNATURES)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    m = None if variant in _SWEEP_KIND else _ref.diameter_mask_batch(masks, block)

    def launch(entry, nparts, *args):
        partials = torch.empty(4 * nparts * batch, dtype=torch.float32, device=v.device)
        out = torch.empty((batch, 4), dtype=torch.float32, device=v.device)
        with torch.cuda.device(v.device):
            err = getattr(lib, entry)(*args, partials.data_ptr(), out.data_ptr(), stream)
        _build.check(lib, err, f"max_diameters_sq_batch[{variant}]")
        LAUNCHES[variant] += 1
        return out

    if variant in _SWEEP_KIND:
        extent = _ref.list_extent(masks)
        grid_x = sweep_grid(lib, block, variant, batch, ntiles, v.device)
        ij = _schedule(nb, v.device) if variant == "nomask" else None
        return lambda: launch("diameter_sweep_launch", grid_x, v.data_ptr(), extent.data_ptr(),
                              0 if ij is None else ij.data_ptr(), batch, mp, block, grid_x,
                              _SWEEP_KIND[variant])
    if variant in _FULL_GRID:
        combos = [1 << c for c in range(4)] if variant == "naive" else [_ALL_COMBOS]

        def full_grid():
            outs = [launch("diameter_partial_launch", ntiles, v.data_ptr(), m.data_ptr(), batch,
                           mp, block, int(variant == "tri"), c) for c in combos]
            # 'naive': launch c holds combo c, the reference's concatenation
            return outs[0] if len(outs) == 1 else torch.stack(
                [o[:, c] for c, o in enumerate(outs)], dim=1)
        return full_grid
    ij = _schedule(nb, v.device)
    return lambda: launch("diameter_sched_launch", ntiles, v.data_ptr(), m.data_ptr(),
                          ij.data_ptr(), ntiles, batch, mp, block, int(variant == "gram"))


def max_diameters_batch(verts, masks, *, block: int = DEFAULT_BLOCK,
                        variant: str = DEFAULT_VARIANT) -> torch.Tensor:
    """(B, 4) float32 diameters [3D, Slice(xy), Row(xz), Column(yz)]."""
    return torch.sqrt(max_diameters_sq_batch(verts, masks, block=block, variant=variant))


# -- work counted from csrc/diameter.cu, per launch of one list -------------

# FP32 operations a pair costs on the CUDA cores: 3 sub, 3 mul, 4 add and
# 4 max.  The masked variants apply the mask outside the pair loop, so
# they select on no pair: 'naive' computes one combo a launch (3D: 3 sub,
# 3 mul, 2 add and a max; a plane 2, 2, 1 and a max), 'gram' converts 3
# products to float32 and forms the combos (4 add, 4 max).
_DIRECT_OPS = 14
_NAIVE_OPS = (3 + 3 + 2 + 1) + 3 * (2 + 2 + 1 + 1)
_GRAM_OPS = 3 + 4 + 4
# an m16n8k4 FP64 product per axis: 2 x 16 x 8 x 4 FLOP for 128 pairs,
# the zero K term included
_GRAM_TENSOR_FLOP = 3 * 2 * 4
# csrc diameter_tile_kernel and diameter_gram_kernel: the mask applied
# outside the pair loop (plan_tile)
_TILE_VARIANTS = ("naive", "fused", "tri", "tri_prefetch", "gram")
# the tile kernels that compute the upper triangle only
_TRIANGULAR = ("tri", "tri_prefetch", "gram")


def column_unit(block: int, variant: str) -> int:
    """The unit a masked tile kernel pads a tile's staged valid columns
    to: 8 for 'gram' (the m16n8k4 product's columns), else 4 columns (a
    16-byte load) times the block's column groups (``csrc/diameter.cu``
    ``sweep_shape``)."""
    if variant == "gram":
        return 8
    row_threads = block // sweep_rows(block)
    groups = 128 // row_threads if row_threads < 128 and 128 % row_threads == 0 else 1
    return 4 * groups


def _list_mask(M: int, block: int, mask) -> torch.Tensor:
    """One list's padded (Mp,) mask stream: ``mask`` ((M,) bool) or, by
    default, every one of the ``M`` slots valid."""
    m = (torch.ones(M, dtype=torch.bool) if mask is None
         else torch.as_tensor(mask).bool().reshape(-1).cpu())
    if m.numel() != M:
        raise ValueError(f"need a mask of {M} slots, got {m.numel()}")
    return _ref.diameter_mask_batch(m[None], block)[0]


def _computed_tiles(M: int, block: int, variant: str, extent: int | None = None,
                    mask=None) -> int:
    """Tiles whose pairs a launch computes: the colex prefix of a list's
    extent ('seqacc', 'nomask'; ``extent``, else the one of ``mask``,
    else the whole list), or the tiles with a valid row and a valid
    column of ``mask`` (default: all ``M`` slots valid) in the full grid
    ('fused', 'naive') or its upper triangle ('tri', 'tri_prefetch',
    'gram')."""
    nb = -(-M // block)
    if variant in _SWEEP_KIND:
        if extent is None and mask is not None:
            extent = int(_ref.list_extent(_list_mask(M, block, mask)[None])[0])
        return _ref.extent_tiles(min(M if extent is None else int(extent), nb * block), block)
    return int(_ref.computed_tiles(_list_mask(M, block, mask), block,
                                   variant in _TRIANGULAR).sum())


def computed_pairs(M: int, block: int, variant: str, extent: int | None = None,
                   mask=None) -> int:
    """Pairs one launch computes for a list: ``block`` squared a computed
    tile (:func:`_computed_tiles`), but for the masked tile
    kernels ``block`` rows times the tile's staged columns (its valid
    columns padded to :func:`column_unit`).  ``extent`` and ``mask`` as
    in :func:`_computed_tiles`."""
    check_variant(variant)
    if variant not in _TILE_VARIANTS:
        return _computed_tiles(M, block, variant, extent, mask) * block * block
    m = _list_mask(M, block, mask)
    unit = column_unit(block, variant)
    cols = (_ref.tile_valid_counts(m, block) + unit - 1) // unit * unit
    tiles = _ref.computed_tiles(m, block, variant in _TRIANGULAR)
    return int((tiles * cols[None, :]).sum()) * block


def flop_estimate(M: int, block: int, variant: str, extent: int | None = None,
                  mask=None) -> float:
    """FP32 operations on the CUDA cores for one list of ``M`` slots
    (all launches of the variant): :func:`computed_pairs` times the
    operations a pair."""
    per_pair = {"naive": _NAIVE_OPS, "gram": _GRAM_OPS}.get(variant, _DIRECT_OPS)
    return float(computed_pairs(M, block, variant, extent, mask)) * per_pair


def tensor_flop_estimate(M: int, block: int, variant: str, mask=None) -> float:
    """FP64 tensor-core FLOP ('gram' only): three m16n8k4 products per
    16 x 8 sub-tile of the computed pairs, the zero fourth K term
    included."""
    check_variant(variant)
    if variant != "gram":
        return 0.0
    return float(computed_pairs(M, block, variant, mask=mask)) * _GRAM_TENSOR_FLOP


def bytes_estimate(M: int, block: int, variant: str, extent: int | None = None,
                   mask=None) -> float:
    """Device-memory bytes for one list: each computed tile reads its row
    and column tiles (12 bytes a slot, and 8 per tile of schedule on the
    scheduled variants), and every block writes a (4,) partial that the
    finalize reads back: one a launched tile, or for 'seqacc' and 'nomask'
    at most one a computed tile (their persistent grid holds no more
    blocks than a list has tiles), which also read the list's extent.  The
    masked tile kernels read the mask of the row and the column tile in
    every block but 'tri''s below the diagonal, and the scheduled ones
    ('tri_prefetch', 'gram') 8 bytes of schedule a launched tile.
    ``extent`` and ``mask`` as in :func:`flop_estimate`."""
    check_variant(variant)
    nb = -(-M // block)
    computed = _computed_tiles(M, block, variant, extent, mask)
    sched = 8 if variant in ("nomask", "tri_prefetch", "gram") else 0
    if variant in _SWEEP_KIND:
        return float(computed * (2 * block * 12 + sched) + 2 * 16 * computed + 16 + 4)
    launched = _tiles(variant, nb)
    visited = nb * (nb + 1) // 2 if variant == "tri" else launched
    per_launch = (visited * (2 * block + sched) + computed * 2 * block * 12
                  + 2 * 16 * launched + 16)
    return float(per_launch) * (4 if variant == "naive" else 1)
