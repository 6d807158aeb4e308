"""Marching-cubes mesh volume and surface area: CUDA kernel wrappers.

:func:`mc_volume_area` replaces
``repro.kernels.marching_cubes.mc_volume_area_pallas`` and its TPU kernel
``_mc_kernel``; :func:`mc_volume_area_batch` replaces
``mc_volume_area_batch_pallas`` (that kernel under ``lax.map``), the
batched pipeline's pass 2a.  One kernel (``csrc/marching_cubes.cu``)
serves both: a launch runs a stack of same-shape volumes, and the
single-case entry is its batch of one.  It runs one thread per cell over
each volume in place; the source says what bounds it and how the design
answers that.  The plain versions are
:func:`repro_torch.kernels.ref.mc_volume_area` and
:func:`repro_torch.kernels.ref.mc_volume_area_batch`.

The triangle table reaches the kernel as a generated header,
``csrc/mc_tri_table.cuh``; :func:`write_tri_table_header` rewrites it from
``core/mc_tables.py`` and a test holds the two equal.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import mc_tables as mct
from repro_torch.core.dispatcher import to_device
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

DEFAULT_BLOCK = 256  # threads per block
_BLOCKS_PER_SM = 8  # grid cap: one resident wave of 256-thread blocks
LAUNCHES = 0  # kernel launches on CUDA tensors, single-case and batched

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"mc_volume_area_launch": [_P, _I, _I, _I, _I, _F, _P, _P, _I, _I, _P, _P]}
TABLE_HEADER = _build.CSRC / "mc_tri_table.cuh"


def mc_volume_area(vol: torch.Tensor, iso: float = 0.5, spacing=(1.0, 1.0, 1.0), *,
                   block: int = DEFAULT_BLOCK):
    """``(|sum of signed volumes|, sum of areas)`` of ``vol``'s isosurface.

    Returns two 0-dim float32 tensors on ``vol``'s device: the batch of one
    of :func:`mc_volume_area_batch`.  ``spacing`` is host metadata.
    """
    sp = torch.as_tensor(spacing, dtype=torch.float32).cpu().numpy().reshape(1, 3)
    out = mc_volume_area_batch(vol[None], iso, sp, block=block)[0]
    return out[0], out[1]


def _grid(shape, device, block: int) -> int:
    """Blocks per case: one thread per cell, capped at one resident wave.
    It depends on the volume's shape alone, so each case's grid-stride
    order, and result, is the same alone or in a stack."""
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"block must be a multiple of 32 in [32, 1024], got {block}")
    ncells = max(shape[0] - 1, 0) * max(shape[1] - 1, 0) * max(shape[2] - 1, 0)
    if ncells >= 2 ** 31:
        raise ValueError(f"volume {tuple(shape)} has more than 2^31 cells")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-ncells // block), _BLOCKS_PER_SM * sms))


def mc_volume_area_batch(vols: torch.Tensor, iso: float = 0.5, spacings=None, *,
                         block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """(B, 2) float32 rows ``(|sum of signed volumes|, sum of areas)``.

    ``vols``: (B, nx, ny, nz) float32, one shape bucket; ``spacings``:
    (B, 3) host metadata (numpy or a CPU tensor; default ones).  A CUDA
    tensor launches the kernel (or raises); only a CPU tensor takes the
    plain version.  Each case's origin is computed on the host exactly as
    :func:`repro_torch.kernels.ref.centred_origin` does, and the (B, 6)
    geometry reaches the card by a copy queued without a host sync.
    """
    global LAUNCHES
    if vols.device.type == "cpu":
        return _ref.mc_volume_area_batch(vols, iso, spacings)
    if vols.device.type != "cuda":
        raise ValueError(f"unsupported device {vols.device}")
    if vols.dtype != torch.float32 or vols.ndim != 4 or not vols.is_contiguous():
        raise ValueError("vols must be a contiguous 4-D float32 tensor, got "
                         f"{vols.dtype} {tuple(vols.shape)}")
    batch = vols.shape[0]
    if not 1 <= batch < 2 ** 16:
        raise ValueError(f"batch of {batch} volumes is outside the kernel's grid")
    if isinstance(spacings, torch.Tensor) and spacings.device.type != "cpu":
        raise ValueError("spacings are host metadata: a device tensor would "
                         "cost a device-to-host sync")
    sp = (np.ones((batch, 3), np.float32) if spacings is None
          else np.asarray(spacings, np.float32).reshape(batch, 3))
    shape = tuple(vols.shape[1:])
    geo = np.concatenate([sp, np.stack([_ref.centred_origin(shape, s) for s in sp])], axis=1)
    nblocks = _grid(shape, vols.device, block)
    geo_dev = to_device(geo, vols.device)
    partials = torch.empty(2 * nblocks * batch, dtype=torch.float32, device=vols.device)
    out = torch.empty((batch, 2), dtype=torch.float32, device=vols.device)
    lib = _build.load("marching_cubes", _SIGNATURES)
    with torch.cuda.device(vols.device):
        err = lib.mc_volume_area_launch(
            vols.data_ptr(), batch, *shape, float(iso), geo_dev.data_ptr(),
            partials.data_ptr(), nblocks, block, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "mc_volume_area")
    LAUNCHES += 1
    return out


def tri_table_source() -> str:
    """The ``csrc/mc_tri_table.cuh`` header text for ``mc_tables.TRI_TABLE``."""
    rows = ",\n".join(
        "    " + ", ".join(f"{int(x):2d}" for x in row) for row in mct.TRI_TABLE
    )
    return (
        "// Generated by repro_torch.kernels.marching_cubes.write_tri_table_header\n"
        "// from repro_torch/core/mc_tables.py TRI_TABLE: for each of the 256 cube\n"
        f"// cases, {mct.MAX_TRIS} triangles x 3 edge ids, -1 padded.  Do not edit.\n"
        "#pragma once\n\n"
        f"__device__ const signed char kTriTable[256 * {3 * mct.MAX_TRIS}] = {{\n"
        f"{rows}}};\n"
    )


def write_tri_table_header() -> Path:
    """Rewrite ``csrc/mc_tri_table.cuh`` from ``core/mc_tables.py``."""
    TABLE_HEADER.write_text(tri_table_source())
    return TABLE_HEADER
