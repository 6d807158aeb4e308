"""Device-resolved entry points of the shape and intensity paths.

Counterpart of ``repro.kernels.ops`` for the single-case, batched and
tiled shape paths and the intensity families.  Each kernel entry takes
``device`` (default ``'cuda'``, see ``repro_torch.core.dispatcher``),
moves its inputs there and calls the kernel wrapper, which launches the
CUDA kernel for a CUDA tensor and the plain version for a CPU tensor.
The diameter entries take ``variant`` (any of ``diameter.VARIANTS``, or
``'auto'``), the compaction and intensity entries ``block``; ``'auto'``
resolves through ``core/dispatcher`` to the measured autotune cache on
the card (``runtime/autotune``) and to the fixed defaults on the CPU.
Marching cubes runs at its fixed defaults: its block sets the order of
its partial sums.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dispatcher
from repro_torch.core.dispatcher import resolve_device, to_device
from repro_torch.core.plan import vertex_bucket  # noqa: F401  (re-export)
from repro_torch.kernels import compact as _compact
from repro_torch.kernels import diameter as _diam
from repro_torch.kernels import firstorder as _fo
from repro_torch.kernels import glcm as _glcm
from repro_torch.kernels import marching_cubes as _mc
from repro_torch.kernels import prune as _prune
from repro_torch.kernels import ref as _ref


def mc_volume_area(vol, iso=0.5, spacing=(1.0, 1.0, 1.0), *, device=None,
                   block=_mc.DEFAULT_BLOCK, chunk_z=_mc.DEFAULT_CHUNK_Z):
    """(mesh_volume, surface_area) of the isosurface of ``vol``."""
    vol = to_device(vol, resolve_device(device), torch.float32)
    return _mc.mc_volume_area(vol.contiguous(), iso, spacing, block=block, chunk_z=chunk_z)


def max_diameters(verts, mask, *, device=None, block=None, variant=_diam.DEFAULT_VARIANT):
    """(4,) [3D, Slice(xy), Row(xz), Column(yz)] max diameters.

    ``variant='auto'`` takes the tuned (variant, block) of this vertex
    bucket at depth 1; ``block`` (default: the tuned or default block)
    always wins.
    """
    dev = resolve_device(device)
    verts = to_device(verts, dev, torch.float32)
    mask = to_device(mask, dev).bool()
    variant, block = dispatcher.diameter_config(dev, verts.shape[0], variant, block)
    return _diam.max_diameters(verts, mask, block=block, variant=variant)


def mc_volume_area_batch(vols, iso=0.5, spacings=None, *, device=None,
                         block=_mc.DEFAULT_BLOCK, chunk_z=_mc.DEFAULT_CHUNK_Z):
    """Batched :func:`mc_volume_area` over one shape bucket (pass 2a).

    ``vols``: (B, nx, ny, nz) bucket-padded masks, ``spacings``: (B, 3)
    host metadata -> (B, 2) [volume, area] rows on the device.
    """
    vols = to_device(vols, resolve_device(device), torch.float32)
    return _mc.mc_volume_area_batch(vols.contiguous(), iso, spacings, block=block,
                                    chunk_z=chunk_z)


def mc_tile_partials(slab, iso=0.5, spacing=(1.0, 1.0, 1.0), *, device=None, k0=0,
                     chunk_z=_mc.DEFAULT_CHUNK_Z, full_shape, block=_mc.DEFAULT_BLOCK):
    """Tile accumulator: unreduced MC partials of one halo-closed z-window.

    The tiled engine's per-tile entry (``core/tiled.py``).  ``slab`` spans
    granules ``k0 ..`` of a volume of ``full_shape`` plus the closing plane
    (``w * chunk_z + 1`` deep).  Returns ``(vol_p, area_p)``, the whole
    volume's partials of those granules (``kernels/marching_cubes.
    mc_slab_partials``); the caller assembles every window's partials in
    granule order and reduces once with :func:`mc_tile_finalize`, which
    gives the in-core bits.
    """
    slab = to_device(slab, resolve_device(device), torch.float32)
    return _mc.mc_slab_partials(slab.contiguous(), iso, spacing, full_shape=full_shape,
                                k0=k0, chunk_z=chunk_z, block=block)


def mc_tile_finalize(vol_partials, area_partials):
    """Fold assembled tile partials into ``(volume, area)``, two 0-dim
    tensors on their device: the in-core path's own final reduction."""
    return _mc.mc_partials_finalize(vol_partials, area_partials)


def max_diameters_batch(verts, masks, *, device=None, block=None,
                        variant=_diam.DEFAULT_VARIANT):
    """(B, 4) [3D, Slice(xy), Row(xz), Column(yz)] max diameters of a
    (B, M, 3) stack (pass 2b); ``variant`` and ``block`` as in
    :func:`max_diameters`, tuned at depth B."""
    dev = resolve_device(device)
    verts = to_device(verts, dev, torch.float32)
    masks = to_device(masks, dev).bool()
    variant, block = dispatcher.diameter_config(dev, verts.shape[1], variant, block,
                                                batch=verts.shape[0])
    return _diam.max_diameters_batch(verts, masks, block=block, variant=variant)


def compact_survivors_batch(verts, keep, cap: int, *, device=None, block="auto"):
    """Batched segmented compaction of keep-mask survivors (pass 1).

    ``verts``: (B, M, 3), ``keep``: (B, M) -> ``(out, mask, n)`` device
    tensors: ``out`` (B, cap, 3), ``mask`` (B, cap) bool, ``n`` (B,) int32
    total survivor counts.  Bitwise the host path's ``np.nonzero`` gather
    and zero pad.  ``block='auto'`` takes the tuned tile of this input
    bucket at depth B.
    """
    dev = resolve_device(device)
    verts = to_device(verts, dev, torch.float32).contiguous()
    keep = to_device(keep, dev).bool().contiguous()
    block = dispatcher.compact_config(dev, verts.shape[1], block, batch=verts.shape[0])
    return _compact.compact_batch(verts, keep, cap, block=block)


def _volumes(images, masks, device):
    dev = resolve_device(device)
    return (to_device(images, dev, torch.float32).contiguous(),
            to_device(masks, dev, torch.float32).contiguous())


def firstorder_packed_batch(images, masks, *, device=None, n_bins=_fo.N_BINS,
                            block="auto", value_range=None):
    """Batched packed first-order stats over bucket-padded stacks.

    ``images``/``masks``: (B, nx, ny, nz) -> (B, packed_width) device rows
    ``[count, sum, sum_sq, hist, lo, hi, bin_width]`` (see
    ``kernels/firstorder``); the feature row derives on the host via
    ``firstorder.features_from_packed_np``.  A case's row is the same bits
    at any batch depth and any ``block`` (``'auto'``: the tuned block of
    this volume bucket at depth B).
    """
    images, masks = _volumes(images, masks, device)
    block = dispatcher.firstorder_config(images.device, images.shape[1:], block,
                                         batch=images.shape[0])
    return _fo.firstorder_packed_batch(images, masks, n_bins=n_bins, block=block,
                                       value_range=value_range)


def glcm_matrix_batch(images, masks, *, device=None, n_bins=_glcm.N_BINS,
                      block="auto", value_range=None):
    """Batched symmetric GLCM count matrices: (B, n_bins, n_bins) float32.

    Integer-valued counts, exact at any batch depth and ``block``; the
    Haralick row derives on the host via
    ``glcm.glcm_features_from_matrix_np``.  ``block`` as in
    :func:`firstorder_packed_batch`.
    """
    images, masks = _volumes(images, masks, device)
    block = dispatcher.glcm_config(images.device, images.shape[1:], block,
                                   batch=images.shape[0])
    return _glcm.glcm_matrix_batch(images, masks, n_bins=n_bins, block=block,
                                   value_range=value_range)


def _rebucket_pruned(orig_verts, orig_mask, v2, m2, info):
    """Pad a pruned candidate list back up to its M' vertex bucket."""
    if not info.pruned:
        return v2, m2, info
    cap = vertex_bucket(info.m_kept)
    if cap >= info.m_total:
        # the survivor bucket (>= 512 floor) is no smaller than the input,
        # so re-bucketing would not shrink the padded pair sweep -- keep
        # the originals and report the stage as a no-op
        return (
            torch.as_tensor(orig_verts, dtype=torch.float32).cpu().numpy(),
            torch.as_tensor(orig_mask).bool().cpu().numpy(),
            dataclasses.replace(info, m_kept=info.m_valid, pruned=False),
        )
    pad = cap - len(v2)
    if pad > 0:
        v2 = np.pad(v2, ((0, pad), (0, 0)))
        m2 = np.pad(m2, (0, pad))
    return v2, m2, info


def prune_candidates(verts, mask, k_dirs: int = 16, fetch=None):
    """Exact candidate pruning + re-bucketing for the pair sweep.

    The keep mask runs on the vertices' device; compaction and
    re-bucketing run on the host, as in the reference.  Returns numpy
    ``(verts', mask', info)``; on degenerate inputs the originals come back
    unchanged.  ``fetch`` copies a tensor to a host numpy array (default
    ``.cpu().numpy()``); the tiled engine passes its executor's counted
    fetch.
    """
    verts_np, mask_np, (v2, m2, info) = _prune.prune_on_host(verts, mask, k_dirs, fetch)
    return _rebucket_pruned(verts_np, mask_np, v2, m2, info)


def prune_candidates_batch(verts, masks, k_dirs: int = 16, *, device=None):
    """Batched :func:`prune_candidates` for a (B, M, 3) stack of cases.

    ``verts``/``masks`` are host arrays.  The keep-mask bound runs once
    over the whole stack on ``device``; compaction and re-bucketing run
    per case on the host, because the pruned counts M' are ragged.
    Returns a list of B numpy ``(verts', mask', info)`` triples.  The
    batched pipeline's ``device_compact=False`` path; the default path pairs
    :func:`repro_torch.kernels.prune.keep_mask_batch` with
    :func:`compact_survivors_batch` instead.
    """
    verts_np = np.asarray(verts, np.float32)
    masks_np = np.asarray(masks).astype(bool)
    pruned = _prune.prune_vertices_batch(verts_np, masks_np, k_dirs=k_dirs,
                                         device=resolve_device(device))
    return [
        _rebucket_pruned(v, m, v2, m2, info)
        for v, m, (v2, m2, info) in zip(verts_np, masks_np, pruned)
    ]


def vertex_fields(vol, iso=0.5, spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0),
                  index_offset=None):
    """Dense dedup vertex fields (elementwise, on ``vol``'s device)."""
    return _ref.vertex_fields(vol, iso, spacing, origin, index_offset=index_offset)


def count_vertices(fields):
    return _ref.count_vertices(fields)


def compact_vertices(fields, max_vertices):
    return _ref.compact_vertices(fields, max_vertices)
