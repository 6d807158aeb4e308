"""Marching-cubes mesh volume and surface area: CUDA kernel wrapper.

Replaces ``repro.kernels.marching_cubes.mc_volume_area_pallas`` and its TPU
kernel ``_mc_kernel``.  The kernel (``csrc/marching_cubes.cu``) runs one
thread per cell over the volume in place; its source says what bounds it
and how the design answers that.  The plain version is
:func:`repro_torch.kernels.ref.mc_volume_area`.

The triangle table reaches the kernel as a generated header,
``csrc/mc_tri_table.cuh``; :func:`write_tri_table_header` rewrites it from
``core/mc_tables.py`` and a test holds the two equal.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import mc_tables as mct
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

DEFAULT_BLOCK = 256  # threads per block
_BLOCKS_PER_SM = 8  # grid cap: one resident wave of 256-thread blocks
LAUNCHES = 0  # kernel launches by mc_volume_area on CUDA tensors

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mc_volume_area_launch": [_P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _I, _I, _P, _P],
}
TABLE_HEADER = _build.CSRC / "mc_tri_table.cuh"


def mc_volume_area(vol: torch.Tensor, iso: float = 0.5, spacing=(1.0, 1.0, 1.0), *,
                   block: int = DEFAULT_BLOCK):
    """``(|sum of signed volumes|, sum of areas)`` of ``vol``'s isosurface.

    Returns two 0-dim float32 tensors on ``vol``'s device.  A CUDA tensor
    launches the kernel (or raises); only a CPU tensor takes the plain
    version.
    """
    global LAUNCHES
    if vol.device.type == "cpu":
        return _ref.mc_volume_area(vol, iso, spacing)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    if vol.dtype != torch.float32 or vol.ndim != 3 or not vol.is_contiguous():
        raise ValueError("vol must be a contiguous 3-D float32 tensor, got "
                         f"{vol.dtype} {tuple(vol.shape)}")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"block must be a multiple of 32 in [32, 1024], got {block}")
    nx, ny, nz = vol.shape
    ncells = max(nx - 1, 0) * max(ny - 1, 0) * max(nz - 1, 0)
    if ncells >= 2 ** 31:
        raise ValueError(f"volume {tuple(vol.shape)} has more than 2^31 cells")
    sp = torch.as_tensor(spacing, dtype=torch.float32).cpu().numpy().reshape(3)
    org = _ref.centred_origin(vol.shape, sp)
    sms = torch.cuda.get_device_properties(vol.device).multi_processor_count
    nblocks = max(1, min(-(-ncells // block), _BLOCKS_PER_SM * sms))
    partials = torch.empty(2 * nblocks, dtype=torch.float32, device=vol.device)
    out = torch.empty(2, dtype=torch.float32, device=vol.device)
    lib = _build.load("marching_cubes", _SIGNATURES)
    with torch.cuda.device(vol.device):
        err = lib.mc_volume_area_launch(
            vol.data_ptr(), nx, ny, nz, float(iso), *map(float, sp), *map(float, org),
            partials.data_ptr(), nblocks, block, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "mc_volume_area")
    LAUNCHES += 1
    return out[0], out[1]


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
