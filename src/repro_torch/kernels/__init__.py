"""Kernels of the shape and intensity paths: hand-written CUDA for the card,
plain PyTorch beside.

    marching_cubes -- csrc/marching_cubes.cu wrappers (mesh volume + area)
    diameter       -- csrc/diameter.cu wrappers (4-combo farthest pair, every variant)
    compact        -- csrc/compact.cu wrapper (segmented survivor compaction)
    firstorder     -- csrc/firstorder.cu wrapper (packed first-order stats)
    glcm           -- csrc/glcm.cu wrapper (symmetric co-occurrence counts)
    masked_range   -- csrc/masked_range.cu wrapper (each case's masked intensity range)
    prune          -- exact candidate pruning (plain PyTorch on the device)
    ref            -- the plain PyTorch versions and the path's plain ops
    ops            -- device-resolved entry points
    _build         -- nvcc build + ctypes loader
"""
