"""Core: feature extraction on the card, one case (shape) or a batch (shape,
first-order, GLCM).

Public API:
    ShapeFeatureExtractor   -- PyRadiomics-compatible single-case extractor
    BatchedExtractor        -- batched two-pass multi-case extractor, any families
    StageTimes              -- per-stage wall-clock breakdown (paper Table 2)
    crop_to_roi             -- host-side ROI crop + pad
    resolve_device          -- 'cuda' by default, 'cpu' on request, no fallback
"""
from repro_torch.core.dispatcher import resolve_device
from repro_torch.core.shape_features import ShapeFeatureExtractor, StageTimes, crop_to_roi
from repro_torch.core.pipeline import BatchedExtractor

__all__ = ["BatchedExtractor", "ShapeFeatureExtractor", "StageTimes", "crop_to_roi",
           "resolve_device"]
