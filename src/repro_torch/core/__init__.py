"""Core: feature extraction on the card, one case (shape), a batch (shape,
first-order, GLCM) or an out-of-core tiled case (shape, first-order).

Public API:
    ShapeFeatureExtractor   -- PyRadiomics-compatible single-case extractor
    BatchedExtractor        -- batched two-pass multi-case extractor, any families
    TiledExtractor          -- out-of-core tiled extraction (shape, first-order)
    TiledCase               -- a case served as z-slabs (``data/tiles``)
    StageTimes              -- per-stage wall-clock breakdown (paper Table 2)
    crop_to_roi             -- host-side ROI crop + pad
    resolve_device          -- 'cuda' by default, 'cpu' on request, no fallback
"""
from repro_torch.core.dispatcher import resolve_device
from repro_torch.core.shape_features import ShapeFeatureExtractor, StageTimes, crop_to_roi
from repro_torch.core.pipeline import BatchedExtractor
from repro_torch.core.tiled import TiledExtractor
from repro_torch.data.tiles import TiledCase

__all__ = ["BatchedExtractor", "ShapeFeatureExtractor", "StageTimes", "TiledCase",
           "TiledExtractor", "crop_to_roi", "resolve_device"]
