"""Stable segmented survivor compaction (pass 1 of the batched pipeline).

Replaces ``repro.kernels.compact.compact_batch_pallas`` and its TPU kernel
``_compact_kernel``: the survivors of each case's keep mask are scattered
into the first slots of a static ``cap``-slot vertex bucket, batched over
a stack of same-cap cases, so pass 1 hands pass 2b already-bucketed
``(verts, vmask)`` device stacks and the vertex data never leaves the
card.  The kernel (``csrc/compact.cu``) says what bounds it and how the
design answers that; the plain version is
:func:`repro_torch.kernels.ref.compact_batch`.  Both compute:

* survivors keep their order in slots ``0..n-1``;
* slots from ``min(n, cap)`` on hold zeros and a False mask;
* survivors past ``cap`` are dropped;
* ``n`` is the total survivor count, counted before the drop.

The output is a copy of input bits, so kernel and plain version agree
bitwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

FLAGS_PER_THREAD = 16  # one 16-byte vector of keep flags a thread
TILE_GRAIN = 32 * FLAGS_PER_THREAD  # a tile is whole warps of threads
MAX_TILE = 1024 * FLAGS_PER_THREAD  # 1024 threads a block
DEFAULT_BLOCK = 4096  # keep flags a CUDA block (one tile), 256 threads
# The kernel's revision: an autotune record measured against another one
# is swept again (runtime/autotune.py).  2: tiles of a case on blocks of
# their own, a count pass and a scatter pass.
REVISION = 2
LAUNCHES = 0  # compact_batch calls that launched the kernel (its two passes)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"compact_batch_launch": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P],
               "compact_floor_launch": [_I, _I, _I, _P]}


def valid_block(block) -> bool:
    """Whether the kernel takes ``block`` flags a tile."""
    return block % TILE_GRAIN == 0 and 0 < block <= MAX_TILE


def tiles(m: int, block: int) -> int:
    """Tiles (CUDA blocks) of one case's ``m`` keep flags: at least one,
    which writes the pad slots and the count of an empty list."""
    return max(1, -(-int(m) // int(block)))


def compact_batch(verts: torch.Tensor, keep: torch.Tensor, cap: int, *,
                  block: int = DEFAULT_BLOCK):
    """``(out, mask, n)``: (B, cap, 3) float32, (B, cap) bool, (B,) int32.

    ``verts``: (B, M, 3) float32, ``keep``: (B, M) bool.  A CUDA tensor
    launches the kernel (or raises); only a CPU tensor takes the plain
    version.  ``block`` is the keep flags one CUDA block takes (a multiple
    of :data:`TILE_GRAIN` up to :data:`MAX_TILE`); it never changes a bit.
    """
    global LAUNCHES
    if verts.device.type == "cpu":
        return _ref.compact_batch(verts, keep, cap)
    if verts.device.type != "cuda" or keep.device != verts.device:
        raise ValueError(f"verts and keep must share one CUDA device, got "
                         f"{verts.device} and {keep.device}")
    if verts.dtype != torch.float32 or keep.dtype != torch.bool:
        raise ValueError(f"need float32 verts and bool keep, got {verts.dtype}, {keep.dtype}")
    if (verts.ndim != 3 or verts.shape[2] != 3 or keep.shape != verts.shape[:2]
            or not verts.is_contiguous() or not keep.is_contiguous()):
        raise ValueError(f"need contiguous verts (B, M, 3) and keep (B, M), got "
                         f"{tuple(verts.shape)} and {tuple(keep.shape)}")
    if not valid_block(block):
        raise ValueError(f"block must be a multiple of {TILE_GRAIN} in "
                         f"[{TILE_GRAIN}, {MAX_TILE}], got {block}")
    batch, m = keep.shape
    if (not 1 <= batch or not 1 <= cap < 2 ** 31 or 3 * m + block >= 2 ** 31
            or batch * tiles(m, block) >= 2 ** 31):
        raise ValueError(f"batch {batch}, M {m}, cap {cap} outside the kernel's range")
    out = torch.empty((batch, cap, 3), dtype=torch.float32, device=verts.device)
    mask = torch.empty((batch, cap), dtype=torch.bool, device=verts.device)
    n = torch.empty(batch, dtype=torch.int32, device=verts.device)
    tile_counts = torch.empty((batch, tiles(m, block)), dtype=torch.int32, device=verts.device)
    lib = _build.load("compact", _SIGNATURES)
    with torch.cuda.device(verts.device):
        err = lib.compact_batch_launch(
            verts.data_ptr(), keep.data_ptr(), batch, m, int(cap), out.data_ptr(),
            mask.data_ptr(), n.data_ptr(), tile_counts.data_ptr(), block,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "compact_batch")
    LAUNCHES += 1
    return out, mask, n


def launch_floor(batch: int, m: int, *, block: int = DEFAULT_BLOCK):
    """A call that launches an empty kernel once on the grid
    :func:`compact_batch` would use for ``(batch, m)`` keep flags: twice
    its device time is the launch floor of the kernel's two passes.  For
    measurement; it counts no launch."""
    if not valid_block(block):
        raise ValueError(f"block must be a multiple of {TILE_GRAIN} in "
                         f"[{TILE_GRAIN}, {MAX_TILE}], got {block}")
    lib = _build.load("compact", _SIGNATURES)

    def call():
        _build.check(lib, lib.compact_floor_launch(batch, m, block,
                                                   torch.cuda.current_stream().cuda_stream),
                     "compact launch floor")
    return call
