"""Device-resolved entry points of the shape path.

Counterpart of ``repro.kernels.ops`` for the single-case slice.  Each
kernel entry takes ``device`` (default ``'cuda'``, see
``repro_torch.core.dispatcher``), moves its inputs there and calls the
kernel wrapper, which launches the CUDA kernel for a CUDA tensor and the
plain version for a CPU tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dispatcher import resolve_device
from repro_torch.core.plan import vertex_bucket  # noqa: F401  (re-export)
from repro_torch.kernels import diameter as _diam
from repro_torch.kernels import marching_cubes as _mc
from repro_torch.kernels import prune as _prune
from repro_torch.kernels import ref as _ref


def mc_volume_area(vol, iso=0.5, spacing=(1.0, 1.0, 1.0), *, device=None,
                   block=_mc.DEFAULT_BLOCK):
    """(mesh_volume, surface_area) of the isosurface of ``vol``."""
    vol = torch.as_tensor(vol, dtype=torch.float32, device=resolve_device(device))
    return _mc.mc_volume_area(vol.contiguous(), iso, spacing, block=block)


def max_diameters(verts, mask, *, device=None, block=_diam.DEFAULT_BLOCK):
    """(4,) [3D, Slice(xy), Row(xz), Column(yz)] max diameters."""
    dev = resolve_device(device)
    verts = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, device=dev).bool()
    return _diam.max_diameters(verts, mask, block=block)


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


def prune_candidates(verts, mask, k_dirs: int = 16):
    """Exact candidate pruning + re-bucketing for the pair sweep.

    The keep mask runs on the vertices' device; compaction and
    re-bucketing run on the host, as in the reference.  Returns numpy
    ``(verts', mask', info)``; on degenerate inputs the originals come back
    unchanged.
    """
    v2, m2, info = _prune.prune_vertices(verts, mask, k_dirs=k_dirs)
    return _rebucket_pruned(verts, mask, v2, m2, info)


def vertex_fields(vol, iso=0.5, spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0),
                  index_offset=None):
    """Dense dedup vertex fields (elementwise, on ``vol``'s device)."""
    return _ref.vertex_fields(vol, iso, spacing, origin, index_offset=index_offset)


def count_vertices(fields):
    return _ref.count_vertices(fields)


def compact_vertices(fields, max_vertices):
    return _ref.compact_vertices(fields, max_vertices)
