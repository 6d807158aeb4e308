"""Marching-cubes mesh volume and surface area: CUDA kernel wrappers.

:func:`mc_volume_area` replaces
``repro.kernels.marching_cubes.mc_volume_area_pallas`` and its TPU kernel
``_mc_kernel``; :func:`mc_volume_area_batch` replaces
``mc_volume_area_batch_pallas`` (that kernel under ``lax.map``), the
batched pipeline's pass 2a; :func:`mc_slab_partials` and
:func:`mc_partials_finalize` replace ``mc_brick_partials_pallas`` (the
kernel with ``z_scal``) and ``mc_partials_finalize``, the tiled path's
per-window partials and their one reduction.  One kernel
(``csrc/marching_cubes.cu``) serves all of them over one partial layout:
z-granules of ``chunk_z`` cell planes (default :data:`DEFAULT_CHUNK_Z`),
one partial per (granule, x-y tile) -- per (sub-slab, tile) for
granules deeper than :data:`TILE`'s 32 planes -- each reduced in an order
fixed by its own cells: the volume's x-y extent, ``chunk_z`` and the tile
set the layout, and ``block`` (threads a block) changes no bit.  A
whole-volume launch runs a stack of same-shape volumes
(the single-case entry is its batch of one) and ends in the finalize; a
window launch returns its granules' partials unreduced, so the tiled
engine's assembled grid finalizes to the in-core bits.  The source says
what bounds the kernel and how the design answers that.  The plain
versions are :func:`repro_torch.kernels.ref.mc_volume_area`,
:func:`~repro_torch.kernels.ref.mc_volume_area_batch`,
:func:`~repro_torch.kernels.ref.mc_slab_partials` and
:func:`~repro_torch.kernels.ref.mc_partials_fold`.

The triangle table and the edge table reach the kernel as generated
headers, ``csrc/mc_tri_table.cuh`` and ``csrc/mc_edge_table.cuh``;
:func:`write_tri_table_header` and :func:`write_edge_table_header` rewrite
them from ``core/mc_tables.py`` and tests hold them equal.
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

DEFAULT_BLOCK = 128  # threads a block: sets no bit; fastest in experiments/torch_kernel_blocks.py
DEFAULT_CHUNK_Z = _ref.MC_CHUNK_Z  # cell planes per z-granule of the partial layout
# cell columns of a tile along x, y and the cell planes an item spans at
# most: csrc/marching_cubes.cu kTX, kTY, kPZ
TILE = (8, 8, 32)
LAUNCHES = 0  # whole-volume launches (mc_volume_area_launch), single-case and batched
SLAB_LAUNCHES = 0  # z-window launches (mc_slab_partials_launch), the tiled path
FINALIZE_LAUNCHES = 0  # finalize launches of assembled window partials

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mc_volume_area_launch": [_P, _I, _I, _I, _I, _I, _F, _P, _I, _I, _I, _P, _P, _P],
    "mc_slab_partials_launch": [_P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _I, _I, _I, _P, _P],
    "mc_finalize_launch": [_P, _P, _I, _P, _P],
}
TABLE_HEADER = _build.CSRC / "mc_tri_table.cuh"
EDGE_HEADER = _build.CSRC / "mc_edge_table.cuh"


def mc_volume_area(vol: torch.Tensor, iso: float = 0.5, spacing=(1.0, 1.0, 1.0), *,
                   block: int = DEFAULT_BLOCK, chunk_z: int = DEFAULT_CHUNK_Z):
    """``(|sum of signed volumes|, sum of areas)`` of ``vol``'s isosurface.

    Returns two 0-dim float32 tensors on ``vol``'s device: the batch of one
    of :func:`mc_volume_area_batch`.  ``spacing`` is host metadata.
    """
    sp = torch.as_tensor(spacing, dtype=torch.float32).cpu().numpy().reshape(1, 3)
    out = mc_volume_area_batch(vol[None], iso, sp, block=block, chunk_z=chunk_z)[0]
    return out[0], out[1]


def layout(shape, chunk_z: int = DEFAULT_CHUNK_Z, block: int = DEFAULT_BLOCK):
    """``(granules, parts per granule)`` of the partial layout of an
    ``(nx, ny, nz)`` volume (see ``csrc/marching_cubes.cu``).

    A granule holds ``chunk_z`` cell planes; its partials are one per x-y
    tile of ``TILE[0] x TILE[1]`` cell columns, times ``ceil(chunk_z /
    TILE[2])`` z sub-slabs.  Both counts depend on the shape,
    ``chunk_z`` and :data:`TILE` alone (``block``, the threads of a block,
    is only checked), so a case's partials are the same bits alone, in a
    stack or cut into z-windows.
    """
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"block must be a multiple of 32 in [32, 1024], got {block}")
    if chunk_z < 1:
        raise ValueError(f"chunk_z must be positive, got {chunk_z}")
    cx, cy, cz = (max(int(n) - 1, 0) for n in shape)
    tiles = max(1, -(-cx // TILE[0])) * max(1, -(-cy // TILE[1]))
    ngran = max(1, -(-cz // chunk_z))
    ppg = -(-chunk_z // TILE[2]) * tiles
    if ngran * ppg >= 2 ** 31:
        raise ValueError(f"{ngran} x {ppg} partials of {tuple(shape)} exceed the kernel's range")
    return ngran, ppg


def _geometry(shape, spacings, batch):
    """(B, 6) host rows [spacing, centred origin of ``shape``] per case."""
    sp = (np.ones((batch, 3), np.float32) if spacings is None
          else np.asarray(spacings, np.float32).reshape(batch, 3))
    return np.concatenate([sp, np.stack([_ref.centred_origin(shape, s) for s in sp])], axis=1)


def _check_stack(vols: torch.Tensor, spacings) -> None:
    if vols.device.type != "cuda":
        raise ValueError(f"unsupported device {vols.device}")
    if vols.dtype != torch.float32 or vols.ndim != 4 or not vols.is_contiguous():
        raise ValueError("vols must be a contiguous 4-D float32 tensor, got "
                         f"{vols.dtype} {tuple(vols.shape)}")
    if not 1 <= vols.shape[0] < 2 ** 16:
        raise ValueError(f"batch of {vols.shape[0]} volumes is outside the kernel's grid")
    if isinstance(spacings, torch.Tensor) and spacings.device.type != "cpu":
        raise ValueError("spacings are host metadata: a device tensor would "
                         "cost a device-to-host sync")


def mc_volume_area_batch(vols: torch.Tensor, iso: float = 0.5, spacings=None, *,
                         block: int = DEFAULT_BLOCK,
                         chunk_z: int = DEFAULT_CHUNK_Z) -> torch.Tensor:
    """(B, 2) float32 rows ``(|sum of signed volumes|, sum of areas)``.

    ``vols``: (B, nx, ny, nz) float32, one shape bucket; ``spacings``:
    (B, 3) host metadata (numpy or a CPU tensor; default ones).  A CUDA
    tensor launches the kernel (or raises); only a CPU tensor takes the
    plain version.  Each case's origin is computed on the host exactly as
    :func:`repro_torch.kernels.ref.centred_origin` does, and the (B, 6)
    geometry reaches the card by a copy queued without a host sync.
    ``chunk_z`` is the z-granule of the partial layout, which the tiled
    path shares.
    """
    global LAUNCHES
    if vols.device.type == "cpu":
        return _ref.mc_volume_area_batch(vols, iso, spacings, chunk_z=chunk_z)
    _check_stack(vols, spacings)
    batch, shape = vols.shape[0], tuple(vols.shape[1:])
    ngran, ppg = layout(shape, chunk_z, block)
    if batch * ngran * ppg >= 2 ** 31:
        raise ValueError(f"{batch} x {ngran * ppg} partials exceed the kernel's range")
    geo_dev = to_device(_geometry(shape, spacings, batch), vols.device)
    partials = torch.empty((batch, 2, ngran, ppg), dtype=torch.float32, device=vols.device)
    out = torch.empty((batch, 2), dtype=torch.float32, device=vols.device)
    lib = _build.load("marching_cubes", _SIGNATURES)
    with torch.cuda.device(vols.device):
        err = lib.mc_volume_area_launch(
            vols.data_ptr(), batch, *shape, chunk_z, float(iso), geo_dev.data_ptr(), ngran,
            ppg, block, partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "mc_volume_area")
    LAUNCHES += 1
    return out


def mc_slab_partials(slab: torch.Tensor, iso: float = 0.5, spacing=(1.0, 1.0, 1.0), *,
                     full_shape, k0: int = 0, chunk_z: int = DEFAULT_CHUNK_Z,
                     block: int = DEFAULT_BLOCK):
    """Unreduced ``(vol_p, area_p)`` partials of one z-window of a volume.

    Replaces ``repro.kernels.marching_cubes.mc_brick_partials_pallas``.
    ``slab``: (nx, ny, w * chunk_z + 1) float32, the planes of granules
    ``k0 .. k0 + w - 1`` of a volume of ``full_shape`` (its centred origin
    and last cell plane; cells past that plane count as empty).  On a CUDA
    tensor each partial is ``(w, parts per granule)`` (:func:`layout`),
    the rows of the whole volume's partials for those granules, bitwise;
    on a CPU tensor the plain version gives ``(w,)`` per-granule sums.
    Assemble every
    window's rows into the whole granule grid (zeros for skipped windows)
    and reduce it with :func:`mc_partials_finalize`.
    """
    global SLAB_LAUNCHES
    if slab.ndim != 3 or (slab.shape[2] - 1) % chunk_z or slab.shape[2] < 2:
        raise ValueError(f"window {tuple(slab.shape)} is not a whole number of "
                         f"chunk_z={chunk_z} granules plus the closing plane")
    if len(full_shape) != 3 or tuple(slab.shape[:2]) != tuple(full_shape[:2]):
        raise ValueError(f"window {tuple(slab.shape)} does not match the volume "
                         f"{tuple(full_shape)} in x and y")
    if slab.device.type == "cpu":
        return _ref.mc_slab_partials(slab, iso, spacing, full_shape=full_shape, k0=k0,
                                     chunk_z=chunk_z)
    _check_stack(slab[None], spacing)
    shape = tuple(slab.shape)
    ngran = (shape[2] - 1) // chunk_z
    _, ppg = layout(shape, chunk_z, block)
    geo_dev = to_device(_geometry(tuple(full_shape), np.asarray(spacing, np.float32), 1),
                        slab.device)
    partials = torch.empty((2, ngran, ppg), dtype=torch.float32, device=slab.device)
    lib = _build.load("marching_cubes", _SIGNATURES)
    with torch.cuda.device(slab.device):
        err = lib.mc_slab_partials_launch(
            slab.data_ptr(), 1, *shape, chunk_z, int(k0) * chunk_z, int(full_shape[2]) - 1,
            float(iso), geo_dev.data_ptr(), ngran, ppg, block, partials.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "mc_slab_partials")
    SLAB_LAUNCHES += 1
    return partials[0], partials[1]


def mc_partials_finalize(vol_p: torch.Tensor, area_p: torch.Tensor):
    """``(|sum vol_p|, sum area_p)`` as two 0-dim float32 tensors.

    Replaces ``repro.kernels.marching_cubes.mc_partials_finalize``: the
    fixed-order reduction that ends the in-core kernel, over a whole
    assembled granule grid, read in place (the two grids need not be one
    tensor).  A CPU tensor takes the plain fold
    (:func:`repro_torch.kernels.ref.mc_partials_fold`).
    """
    global FINALIZE_LAUNCHES
    if vol_p.device.type == "cpu":
        return _ref.mc_partials_fold(vol_p, area_p)
    if vol_p.shape != area_p.shape or vol_p.device != area_p.device:
        raise ValueError(f"partials {tuple(vol_p.shape)} and {tuple(area_p.shape)} differ")
    nparts = vol_p.numel()
    if not 1 <= nparts < 2 ** 31:
        raise ValueError(f"{nparts} partials are outside the finalize kernel's range")
    vol_p, area_p = (p.to(torch.float32).contiguous() for p in (vol_p, area_p))
    out = torch.empty(2, dtype=torch.float32, device=vol_p.device)
    lib = _build.load("marching_cubes", _SIGNATURES)
    with torch.cuda.device(vol_p.device):
        err = lib.mc_finalize_launch(vol_p.data_ptr(), area_p.data_ptr(), nparts,
                                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "mc_partials_finalize")
    FINALIZE_LAUNCHES += 1
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
        f"__device__ __align__(16) const signed char kTriTable[256 * {3 * mct.MAX_TRIS}] = {{\n"
        f"{rows}}};\n"
    )


def write_tri_table_header() -> Path:
    """Rewrite ``csrc/mc_tri_table.cuh`` from ``core/mc_tables.py``."""
    TABLE_HEADER.write_text(tri_table_source())
    return TABLE_HEADER


def edge_code() -> int:
    """Edge ``e``'s 5 bits at bit ``5 * e``: its axis (bits 0-1) and its
    anchor's offset from the cell origin, x (bit 2), y (bit 3), z (bit 4)."""
    code = 0
    for e, (axis, (ox, oy, oz)) in enumerate(zip(mct.EDGE_CELL_AXIS.tolist(),
                                                 mct.EDGE_CELL_OFFSET.tolist())):
        code |= (axis | ox << 2 | oy << 3 | oz << 4) << (5 * e)
    return code


def edge_table_source() -> str:
    """The ``csrc/mc_edge_table.cuh`` header text: :func:`edge_code` for
    ``mc_tables.EDGE_CELL_AXIS`` / ``EDGE_CELL_OFFSET``, each edge's corner
    pair (``EDGES`` in ``CORNERS`` order) in its comment."""
    rows = "\n".join(
        f"//   {e:2d}  {'xyz'[a]}     ({o[0]},{o[1]},{o[2]})  {c0}-{c1}"
        for e, (a, o, (c0, c1)) in enumerate(zip(mct.EDGE_CELL_AXIS.tolist(),
                                                 mct.EDGE_CELL_OFFSET.tolist(),
                                                 mct.EDGES.tolist())))
    return (
        "// Generated by repro_torch.kernels.marching_cubes.write_edge_table_header\n"
        "// from repro_torch/core/mc_tables.py EDGE_CELL_AXIS and EDGE_CELL_OFFSET:\n"
        "// cube edge e's 5 bits at bit 5 * e, its axis (bits 0-1) and its anchor's\n"
        "// offset from the cell origin, x (bit 2), y (bit 3), z (bit 4).  The edge\n"
        "// joins the anchor and the grid point one step along the axis, corners\n"
        "// c0 and c1 of mc_tables.EDGES.  Do not edit.\n"
        "//    e  axis  offset   corners\n"
        f"{rows}\n"
        "#pragma once\n\n"
        f"constexpr unsigned long long kEdgeCode = 0x{edge_code():016x}ULL;\n"
    )


def write_edge_table_header() -> Path:
    """Rewrite ``csrc/mc_edge_table.cuh`` from ``core/mc_tables.py``."""
    EDGE_HEADER.write_text(edge_table_source())
    return EDGE_HEADER
