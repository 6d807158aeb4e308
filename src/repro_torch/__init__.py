"""repro_torch: PyRadiomics-cuda's feature extraction on PyTorch and CUDA.

A port of the JAX package ``repro`` to an NVIDIA H100, laid out like it
(``core/``, ``kernels/``, ``data/``), that imports neither JAX nor ``repro``.
It runs single-case shape extraction (``ShapeFeatureExtractor``) and the
batched two-pass cohort path (``BatchedExtractor``) with the shape,
first-order and GLCM feature families.  The TPU kernels on those paths
(marching cubes, the diameter sweep, segmented compaction, the batched
forms of the first two, first-order stats and GLCM) are replaced by CUDA
C++ kernels written for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use;
beside each sits its plain PyTorch version.  Entry points run on the
card unless the caller passes ``device='cpu'``, and raise when there is no
card.

The system has no learned weights.  The only state carried across from the
reference is the marching-cubes tables and the case data, and the port
regenerates both with its own copies of the numpy generators
(``core/mc_tables.py``, ``data/synthetic.py``); tests hold every table and
``make_case`` array-equal to the reference's.  No other conversion function
is needed.
"""
from repro_torch.core import (
    BatchedExtractor,
    ShapeFeatureExtractor,
    StageTimes,
    crop_to_roi,
    resolve_device,
)

__all__ = ["BatchedExtractor", "ShapeFeatureExtractor", "StageTimes", "crop_to_roi",
           "resolve_device"]
