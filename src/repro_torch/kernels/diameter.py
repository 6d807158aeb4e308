"""Maximum pairwise vertex distances (3D + three planes): CUDA kernel wrapper.

Replaces ``repro.kernels.diameter.max_diameters_sq_pallas`` in its default
variant ``'seqacc'`` (TPU kernel ``_kernel_seqacc``) and
``max_diameters_pallas``.  The paper's hot spot: 95.7-99.9% of shape time
goes to this farthest-pair sweep.  The kernel (``csrc/diameter.cu``) walks
the upper-triangle tiles of the pair space; its source says what bounds it
and how the design answers that.

The input preparation is shared with the plain version
(:func:`repro_torch.kernels.ref.diameter_input`): fill invalid slots with
the first valid vertex, centre on the bounding-box midpoint, transpose to
SoA and pad to the block.  On the same prepared input the kernel's maxima
equal the plain version's bitwise.  One launch sweeps a (B, M) stack
(:func:`max_diameters_sq_batch`): the batched pipeline's pass 2b, where the
reference maps the single kernel over the stack with ``lax.map``, and, as
its batch of one, the single-case :func:`max_diameters_sq`; a case's row
is the same bits alone or in a stack.  The other TPU variants (``fused``,
``tri``, ``tri_prefetch``, ``gram``, ``nomask``) are not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

DEFAULT_BLOCK = 256  # tile width = threads per block
LAUNCHES = 0  # kernel launches on CUDA tensors, single-case and batched

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"max_diameters_sq_launch": [_P, _I, _I, _I, _P, _P, _P]}


def _check_inputs(verts, mask, block):
    if verts.device.type != "cuda" or mask.device != verts.device:
        raise ValueError(f"verts and mask must share one CUDA device, got "
                         f"{verts.device} and {mask.device}")
    if verts.dtype != torch.float32 or mask.dtype != torch.bool:
        raise ValueError(f"need float32 verts and bool mask, got {verts.dtype}, {mask.dtype}")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"block must be a multiple of 32 in [32, 1024], got {block}")


def _tiles(mp: int, block: int) -> int:
    nb = mp // block
    ntiles = nb * (nb + 1) // 2
    if mp >= 2 ** 31 or ntiles >= 2 ** 31:
        raise ValueError(f"{mp} vertices exceed the kernel's grid")
    return ntiles


def max_diameters_sq(verts: torch.Tensor, mask: torch.Tensor, *,
                     block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """(4,) float32 squared maxima [3D, xy(Slice), xz(Row), yz(Column)].

    ``verts``: (M, 3) float32, ``mask``: (M,) bool, at least one valid.  The
    batch of one of :func:`max_diameters_sq_batch`.
    """
    return max_diameters_sq_batch(verts[None], mask[None], block=block)[0]


def max_diameters(verts, mask, *, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """(4,) float32 diameters [3D, Slice(xy), Row(xz), Column(yz)]."""
    return torch.sqrt(max_diameters_sq(verts, mask, block=block))


def max_diameters_sq_batch(verts: torch.Tensor, masks: torch.Tensor, *,
                           block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """(B, 4) float32 squared maxima, row b those of ``verts[b]``.

    ``verts``: (B, M, 3) float32, ``masks``: (B, M) bool, each case with at
    least one valid slot.  A CUDA tensor launches the kernel (or raises);
    only a CPU tensor takes the plain version.
    """
    global LAUNCHES
    if verts.device.type == "cpu":
        return _ref.max_diameters_sq_batch(verts, masks, block)
    _check_inputs(verts, masks, block)
    batch = verts.shape[0]
    if not 1 <= batch < 2 ** 16:
        raise ValueError(f"batch of {batch} vertex lists is outside the kernel's grid")
    v = _ref.diameter_input_batch(verts, masks, block)
    mp = v.shape[2]
    ntiles = _tiles(mp, block)
    partials = torch.empty(4 * ntiles * batch, dtype=torch.float32, device=v.device)
    out = torch.empty((batch, 4), dtype=torch.float32, device=v.device)
    lib = _build.load("diameter", _SIGNATURES)
    with torch.cuda.device(v.device):
        err = lib.max_diameters_sq_launch(
            v.data_ptr(), batch, mp, block, partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "max_diameters_sq")
    LAUNCHES += 1
    return out


def max_diameters_batch(verts, masks, *, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """(B, 4) float32 diameters [3D, Slice(xy), Row(xz), Column(yz)]."""
    return torch.sqrt(max_diameters_sq_batch(verts, masks, block=block))
