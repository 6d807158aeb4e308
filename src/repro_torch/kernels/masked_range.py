"""Masked intensity range of a stack of cases: CUDA kernel wrapper.

The first-order and GLCM kernels quantise each case's masked voxels
between its masked ``(lo, hi)``; the batched executor takes the range once
per shape pool and shares it between both families.  The reference
computes it outside any Pallas kernel (``repro.kernels.ref.intensity_range``
under ``jax.vmap``), so this kernel (``csrc/masked_range.cu``) is the
port's own, with :func:`repro_torch.kernels.ref.intensity_range` as its
plain version.  It reads each mask value once as part of a 16-byte vector,
and the image only in the 16-byte groups that hold a masked voxel; a
second small launch folds each case's per-block partials.  Min and max are
exact in any order, so the kernel's ``(lo, hi)`` equal the plain version's
by value (a tie of -0.0 and +0.0 at an extremum may take either sign); a
masked NaN gives NaN and an unmasked one is ignored, as there.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

CHUNK = 8192  # voxels one CUDA block reads (csrc/masked_range.cu kChunk)
LAUNCHES = 0  # kernel launches by masked_range_batch on CUDA tensors

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"masked_range_launch": [_P, _P, _I, _L, _I, _P, _P, _P],
               "masked_range_floor_launch": [_I, _I, _P]}


def masked_range_batch(images: torch.Tensor, masks: torch.Tensor):
    """``(lo, hi)``, two ``(B,)`` float32 tensors: each case's min and max
    over its voxels whose mask is > 0, ``(0, 0)`` where there is none.

    ``images``/``masks``: contiguous (B, X, Y, Z) float32 stacks of one
    shape (``ref.check_volumes``).  A CUDA tensor launches the kernel (or
    raises); only a CPU tensor takes the plain version.  The result stays
    on the device: no host sync.
    """
    global LAUNCHES
    batch = images.shape[0]
    if images.device.type == "cpu":
        return _ref.intensity_range(images.reshape(batch, -1), masks.reshape(batch, -1), dim=1)
    _ref.check_volumes(images, masks)
    voxels = images[0].numel()
    chunks = -(-voxels // CHUNK)
    partials = torch.empty(3 * batch * chunks, dtype=torch.float32, device=images.device)
    out = torch.empty((2, batch), dtype=torch.float32, device=images.device)
    lib = _build.load("masked_range", _SIGNATURES)
    with torch.cuda.device(images.device):
        err = lib.masked_range_launch(images.data_ptr(), masks.data_ptr(), batch, voxels, chunks,
                                      partials.data_ptr(), out.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "masked_range_batch")
    LAUNCHES += 1
    return out[0], out[1]


def launch_floor(batch: int, voxels: int):
    """A call that launches an empty kernel on each of the two grids
    :func:`masked_range_batch` would use for ``batch`` cases of ``voxels``
    voxels: its device time is the kernel's launch floor.  For
    measurement; it counts no launch."""
    lib = _build.load("masked_range", _SIGNATURES)
    chunks = -(-voxels // CHUNK)

    def call():
        _build.check(lib, lib.masked_range_floor_launch(batch, chunks,
                                                        torch.cuda.current_stream().cuda_stream),
                     "masked range launch floor")
    return call
