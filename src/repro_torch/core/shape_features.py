"""PyRadiomics-compatible 3D shape feature extraction on PyTorch and CUDA.

Counterpart of ``repro.core.shape_features`` with the same user-facing API:

    from repro_torch.core.shape_features import ShapeFeatureExtractor
    ext = ShapeFeatureExtractor()          # the card; device='cpu' on request
    res = ext.execute(image, mask, spacing=(1.0, 1.0, 1.0))
    res['MeshVolume'], res['SurfaceArea'], res['Maximum3DDiameter'], ...

Feature names and definitions follow the PyRadiomics shape(3D) class:
MeshVolume, VoxelVolume, SurfaceArea, SurfaceVolumeRatio, Sphericity,
Compactness1, Compactness2, SphericalDisproportion, Maximum3DDiameter,
Maximum2DDiameterSlice (x-y plane), Maximum2DDiameterColumn (y-z plane),
Maximum2DDiameterRow (x-z plane), MajorAxisLength, MinorAxisLength,
LeastAxisLength, Elongation, Flatness.

Axis convention: volumes are indexed (x, y, z) with ``spacing`` in the same
order.  (PyRadiomics uses (z, y, x) numpy order; the plane features map as
Slice = in-plane (x, y), Column = (y, z), Row = (x, z).)

The two expensive stages (marching cubes and the O(M^2) diameter sweep)
run as hand-written CUDA kernels on the card; ``device='cpu'`` runs their
plain PyTorch versions instead.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.dispatcher import resolve_device
from repro_torch.kernels import diameter as _diam
from repro_torch.kernels import marching_cubes as _mc
from repro_torch.kernels import ops


@dataclasses.dataclass
class StageTimes:
    """Wall-clock breakdown mirroring the paper's Table 2 columns."""

    preprocess_ms: float = 0.0  # crop/pad/mask ('File reading' analogue)
    transfer_ms: float = 0.0  # host->device ('D. tran.')
    mesh_ms: float = 0.0  # marching-cubes volume+area ('M.C.')
    diameter_ms: float = 0.0  # vertex fields, pruning and pair sweep ('Diam.')

    @property
    def total_ms(self) -> float:
        return self.preprocess_ms + self.transfer_ms + self.mesh_ms + self.diameter_ms


def crop_to_roi(image: np.ndarray, mask: np.ndarray, pad: int = 1):
    """Crop image/mask to the ROI bounding box and zero-pad by ``pad``.

    PyRadiomics crops to the bounding box before feature extraction; the
    1-voxel zero pad closes the isosurface at the volume boundary.
    Host-side numpy: the 'data loading' stage of the paper's breakdown.
    """
    idx = np.nonzero(mask)
    if len(idx[0]) == 0:
        raise ValueError("mask is empty")
    lo = [int(i.min()) for i in idx]
    hi = [int(i.max()) + 1 for i in idx]
    sl = tuple(slice(l, h) for l, h in zip(lo, hi))
    m = np.ascontiguousarray(mask[sl]).astype(np.float32)
    im = np.ascontiguousarray(image[sl]).astype(np.float32)
    m = np.pad(m, pad)
    im = np.pad(im, pad)
    return im, m, lo


def _voxel_stats(mask: torch.Tensor, spacing: torch.Tensor):
    """Voxel-count volume and PCA eigenvalues (physical coordinates).

    The covariance is summed on ``mask``'s device; its 3x3 eigenvalues are
    taken on the host in float32, so the card and the CPU share that step.
    """
    n = mask.sum()
    voxel_volume = n * spacing.prod()
    grids = torch.meshgrid(
        *(torch.arange(s, dtype=torch.float32, device=mask.device) for s in mask.shape),
        indexing="ij",
    )
    coords = torch.stack(grids, dim=-1) * spacing  # physical
    w = mask[..., None]
    norm = n.clamp(min=1.0)
    mean = (coords * w).sum(dim=(0, 1, 2)) / norm
    d = ((coords - mean) * w).reshape(-1, 3)
    cov = (d.T @ d) / norm
    eig = torch.linalg.eigvalsh(cov.cpu()).clamp(min=0.0)  # ascending
    return voxel_volume, eig


class ShapeFeatureExtractor:
    """Drop-in 3D shape feature extractor on the card.

    ``device`` defaults to ``'cuda'`` and raises ``RuntimeError`` when no
    CUDA device exists; ``device='cpu'`` runs the plain PyTorch versions.
    ``diameter_variant`` is ``'auto'`` (the default) or any of
    ``kernels.diameter.VARIANTS``: ``'auto'`` takes the measured-best
    (variant, block) of the case's vertex bucket at depth 1 from the
    autotune cache on the card (``runtime/autotune``; ``'seqacc'`` at the default block
    on the CPU), and ``diam_block`` overrides the block.  ``mc_block='auto'``
    is the marching-cubes kernel's fixed default block, which is not tuned.
    ``prune=True`` runs the exact candidate pruning stage before the pair
    sweep; on the card the diameters are bitwise the same either way.
    """

    def __init__(self, device=None, diameter_variant: str = "auto", mc_block="auto",
                 diam_block: int | None = None, prune: bool = True):
        self.device = resolve_device(device)
        if diameter_variant != "auto":
            _diam.check_variant(diameter_variant)
        self.diameter_variant = diameter_variant
        self.mc_block = _mc.DEFAULT_BLOCK if mc_block == "auto" else int(mc_block)
        self.diam_block = diam_block
        self.prune = prune
        self.last_prune_info = None  # PruneInfo of the most recent case

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- staged API ---------------------------------------------------------
    def mesh_features(self, mask_padded, spacing):
        return ops.mc_volume_area(mask_padded, 0.5, spacing, device=self.device,
                                  block=self.mc_block)

    def diameter_features(self, mask_padded, spacing):
        fields = ops.vertex_fields(mask_padded, 0.5, spacing)
        n = int(ops.count_vertices(fields))
        cap = ops.vertex_bucket(n)
        verts, vmask, _ = ops.compact_vertices(fields, cap)
        self.last_prune_info = None
        if self.prune:
            verts, vmask, self.last_prune_info = ops.prune_candidates(verts, vmask)
        d = ops.max_diameters(verts, vmask, device=self.device, block=self.diam_block,
                              variant=self.diameter_variant)
        return d, n

    # -- public API ---------------------------------------------------------
    def execute(
        self,
        image: np.ndarray,
        mask: np.ndarray,
        spacing=(1.0, 1.0, 1.0),
        with_times: bool = False,
    ) -> Mapping[str, float]:
        times = StageTimes()
        sp = np.asarray(spacing, np.float32)

        t0 = time.perf_counter()
        _, m, _ = crop_to_roi(image, mask)
        times.preprocess_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        m_dev = torch.from_numpy(m).to(self.device)
        sp_dev = torch.from_numpy(sp).to(self.device)
        self._sync()
        times.transfer_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        mesh_volume, surface_area = self.mesh_features(m_dev, sp_dev)
        self._sync()
        times.mesh_ms = (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        diam, n_verts = self.diameter_features(m_dev, sp_dev)
        self._sync()
        times.diameter_ms = (time.perf_counter() - t0) * 1e3

        voxel_volume, eig = _voxel_stats(m_dev, sp_dev)

        V = float(mesh_volume)
        A = float(surface_area)
        d3, dxy, dxz, dyz = diam.tolist()
        e0, e1, e2 = eig.tolist()  # ascending: least, minor, major
        pi = float(np.pi)
        feats = {
            "MeshVolume": V,
            "VoxelVolume": float(voxel_volume),
            "SurfaceArea": A,
            "SurfaceVolumeRatio": A / V if V > 0 else float("nan"),
            "Sphericity": (36.0 * pi * V * V) ** (1.0 / 3.0) / A if A > 0 else float("nan"),
            "Compactness1": V / (pi ** 0.5 * A ** 1.5) if A > 0 else float("nan"),
            "Compactness2": 36.0 * pi * V * V / (A ** 3) if A > 0 else float("nan"),
            "SphericalDisproportion": A / (36.0 * pi * V * V) ** (1.0 / 3.0) if V > 0 else float("nan"),
            "Maximum3DDiameter": d3,
            "Maximum2DDiameterSlice": dxy,
            "Maximum2DDiameterRow": dxz,
            "Maximum2DDiameterColumn": dyz,
            "MajorAxisLength": 4.0 * e2 ** 0.5,
            "MinorAxisLength": 4.0 * e1 ** 0.5,
            "LeastAxisLength": 4.0 * e0 ** 0.5,
            "Elongation": (e1 / e2) ** 0.5 if e2 > 0 else float("nan"),
            "Flatness": (e0 / e2) ** 0.5 if e2 > 0 else float("nan"),
            "_n_mesh_vertices": float(n_verts),
        }
        if with_times:
            return feats, times
        return feats
