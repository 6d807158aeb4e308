"""Maximum pairwise vertex distances (3D + three planes): CUDA kernel wrappers.

Replaces ``repro.kernels.diameter.max_diameters_sq_pallas`` and
``max_diameters_pallas`` in every variant of the reference (:data:`VARIANTS`,
the paper's Fig. 1 axis): ``seqacc`` (TPU kernel ``_kernel_seqacc``, the
default), ``fused``, ``tri`` and ``naive`` (``_kernel_partial``),
``tri_prefetch`` and ``gram`` (``_kernel_tri_prefetch`` with
``_pairwise_combos`` or ``_pairwise_combos_gram``) and ``nomask``
(``_kernel_nomask``).  The paper's hot spot: 95.7-99.9% of shape time goes
to this farthest-pair sweep.  The kernels (``csrc/diameter.cu``) walk
tiles of the pair space, one tile per block; the source says what bounds
them, how each variant's grid and streams differ, and why ``gram`` runs on
the FP64 tensor cores.

Every variant sweeps the same prepared input
(:func:`repro_torch.kernels.ref.diameter_input_batch`): invalid slots
filled with the first valid vertex, centred on the bounding-box midpoint,
transposed to SoA and padded to the block.  The masked variants also read
the padded mask (:func:`repro_torch.kernels.ref.diameter_mask_batch`).  On
the same input each kernel's maxima equal its plain version's
(:func:`repro_torch.kernels.ref.max_diameters_sq_batch`) bitwise, and the
direct variants (all but ``gram``) equal each other's: a filled slot
duplicates a valid vertex.  ``gram`` forms each squared difference from the
Gram identity in float64 and rounds it once, so its bits may differ from
the direct sweep's in the last place.  One launch sweeps a (B, M) stack
(:func:`max_diameters_sq_batch`), pass 2b of the batched pipeline; the
single-case :func:`max_diameters_sq` is its batch of one, and a case's row
is the same bits alone or in a stack.  ``naive`` launches its kernel four
times, one combo each.

:func:`flop_estimate`, :func:`tensor_flop_estimate` and
:func:`bytes_estimate` count each variant's work from the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.dispatcher import to_device
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

VARIANTS = _ref.DIAMETER_VARIANTS
DEFAULT_VARIANT = "seqacc"
DEFAULT_BLOCK = 256  # tile width = threads per block
# kernel launches on CUDA tensors per variant, single-case and batched
# ('naive' counts its four launches)
LAUNCHES = dict.fromkeys(VARIANTS, 0)

_FULL_GRID = ("naive", "fused", "tri")  # csrc diameter_partial_launch
_SCHED_KIND = {"tri_prefetch": 0, "nomask": 1, "gram": 2}  # diameter_sched_launch
_ALL_COMBOS = 0xF
_SCHEDULES: dict = {}  # (nb, device) -> (2, T) int32 tile schedule on the card

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "max_diameters_sq_launch": [_P, _I, _I, _I, _P, _P, _P],
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
    """The (2, T) upper-triangle schedule on ``device``, built once per
    ``nb`` and device (pinned, ``non_blocking``: no host sync)."""
    key = (nb, device)
    ij = _SCHEDULES.get(key)
    if ij is None:
        ij = _SCHEDULES[key] = to_device(_ref.tile_schedule(nb), device)
    return ij


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
    m = None if variant in ("seqacc", "nomask") else _ref.diameter_mask_batch(masks, block)

    def launch(entry, *args):
        partials = torch.empty(4 * ntiles * batch, dtype=torch.float32, device=v.device)
        out = torch.empty((batch, 4), dtype=torch.float32, device=v.device)
        with torch.cuda.device(v.device):
            err = getattr(lib, entry)(*args, partials.data_ptr(), out.data_ptr(), stream)
        _build.check(lib, err, f"max_diameters_sq_batch[{variant}]")
        LAUNCHES[variant] += 1
        return out

    if variant == "seqacc":
        return lambda: launch("max_diameters_sq_launch", v.data_ptr(), batch, mp, block)
    if variant in _FULL_GRID:
        combos = [1 << c for c in range(4)] if variant == "naive" else [_ALL_COMBOS]

        def full_grid():
            outs = [launch("diameter_partial_launch", v.data_ptr(), m.data_ptr(), batch, mp,
                           block, int(variant == "tri"), c) for c in combos]
            # 'naive': launch c holds combo c, the reference's concatenation
            return outs[0] if len(outs) == 1 else torch.stack(
                [o[:, c] for c, o in enumerate(outs)], dim=1)
        return full_grid
    ij = _schedule(nb, v.device)
    return lambda: launch("diameter_sched_launch", v.data_ptr(),
                          0 if m is None else m.data_ptr(), ij.data_ptr(), ntiles, batch, mp,
                          block, _SCHED_KIND[variant])


def max_diameters_batch(verts, masks, *, block: int = DEFAULT_BLOCK,
                        variant: str = DEFAULT_VARIANT) -> torch.Tensor:
    """(B, 4) float32 diameters [3D, Slice(xy), Row(xz), Column(yz)]."""
    return torch.sqrt(max_diameters_sq_batch(verts, masks, block=block, variant=variant))


# -- work counted from csrc/diameter.cu, per launch of one list -------------

# FP32 operations a pair costs on the CUDA cores: 3 sub, 3 mul, 4 add and
# 4 max; the mask adds a compare, an and and 4 selects.  'naive' computes
# one combo a launch (3D: 3 sub, 3 mul, 2 add; a plane: 2, 2, 1; each a
# max and a select, plus the mask's compare and and).  'gram' converts 3
# products to float32 and forms the combos (4 add, 4 max, 4 select, 2).
_DIRECT_OPS = 14
_MASK_OPS = 6
_NAIVE_OPS = (3 + 3 + 2 + 2 + 2) + 3 * (2 + 2 + 1 + 2 + 2)
_GRAM_OPS = 3 + 4 + 4 + _MASK_OPS
_GRAM_TENSOR_FLOP = 3 * 2 * 4  # an m8n8k4 product per axis: 2 K FLOP a pair


def _computed_tiles(M: int, block: int, variant: str) -> int:
    """Tiles whose pairs a launch computes ('tri' skips the lower ones)."""
    nb = -(-M // block)
    return nb * nb if variant in ("naive", "fused") else nb * (nb + 1) // 2


def flop_estimate(M: int, block: int, variant: str) -> float:
    """FP32 operations on the CUDA cores for one list of ``M`` slots."""
    check_variant(variant)
    per_pair = {"seqacc": _DIRECT_OPS, "nomask": _DIRECT_OPS, "naive": _NAIVE_OPS,
                "gram": _GRAM_OPS}.get(variant, _DIRECT_OPS + _MASK_OPS)
    return float(_computed_tiles(M, block, variant)) * block * block * per_pair


def tensor_flop_estimate(M: int, block: int, variant: str) -> float:
    """FP64 tensor-core FLOP ('gram' only): three m8n8k4 products per 8 x 8
    sub-tile, the zero fourth K term included."""
    check_variant(variant)
    if variant != "gram":
        return 0.0
    return float(_computed_tiles(M, block, variant)) * block * block * _GRAM_TENSOR_FLOP


def bytes_estimate(M: int, block: int, variant: str) -> float:
    """Device-memory bytes for one list: each computed tile reads its row
    and column tiles (12 bytes a slot, 13 with the mask stream, and 8 per
    tile of schedule on the triangular schedules), and every launched tile
    writes a (4,) partial that the finalize reads back."""
    check_variant(variant)
    nb = -(-M // block)
    launched = _tiles(variant, nb)
    slot = 12 if variant in ("seqacc", "nomask") else 13
    sched = 8 if variant in _SCHED_KIND else 0
    per_launch = (_computed_tiles(M, block, variant) * (2 * block * slot + sched)
                  + 2 * 16 * launched + 16)
    return float(per_launch) * (4 if variant == "naive" else 1)
