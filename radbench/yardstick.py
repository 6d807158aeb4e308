"""The yardstick of the roofline shares: peaks, kernel names, work counts.

A frozen copy of the operation and byte arithmetic of the port's
``runtime/roofline.py`` ``*_work`` functions, so the share reads the same
work whatever implements a kernel and later changes to the program cannot
move it.  Work is counted from the valid entries each launch is handed,
not its padded slots: each input byte read once and each output byte
written once, and the operations these inputs need.

A share is ``least time / device time``: the least time is the larger of
operations / the published FP32 peak and bytes / the published bandwidth
of one H100 SXM (NVIDIA's data sheet, at 700 W), over the window's
totals, which is never more than the sum of each launch's own bound; the
device time is the kernel's, summed by name from the trace.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12  # FP32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3

# the names of each kernel's functions, as they appear in the trace's names
KERNEL_PREFIXES = {
    "marching_cubes": ("mc_partials_kernel", "mc_finalize_kernel"),
    "diameter": ("diameter_sweep_kernel", "diameter_tile_kernel", "diameter_gram_kernel",
                 "diameter_finalize_kernel"),
    "compact": ("compact_count_kernel", "compact_scatter_kernel", "compact_empty_kernel"),
    "masked_range": ("range_partials_kernel", "range_fold_kernel", "range_empty_kernel"),
    "firstorder": ("fo_partials_kernel", "fo_fold_kernel"),
    "glcm": ("glcm_tile_kernel", "glcm_sum_kernel"),
}

# FP32 operations, counted from the kernels' sources (runtime/roofline.py)
MC_OPS_PER_CELL = 8
MC_OPS_PER_TRIANGLE = 75
DIAM_OPS_PER_PAIR = 14
QUANT_OPS = 5
FO_OPS_PER_MASKED = 3 + QUANT_OPS
GLCM_OPS_PER_PAIR = 1 + QUANT_OPS
RANGE_OPS_PER_MASKED = 2


def kernel_of(name: str) -> str | None:
    """The kernel (a key of ``KERNEL_PREFIXES``) a trace name belongs to,
    demangled (``void diameter_sweep_kernel<4, true>(...)``) or mangled
    (``_Z21diameter_sweep_kernel...``)."""
    for kernel, prefixes in KERNEL_PREFIXES.items():
        if any(p in name for p in prefixes):
            return kernel
    return None


def mc_work(voxels: int, cells: int, triangles: int, cases: int) -> tuple[float, float]:
    """Marching cubes: each voxel read once, a (volume, area) pair written a
    case; the compares of every cell and the arithmetic of every triangle."""
    return (float(MC_OPS_PER_CELL * cells + MC_OPS_PER_TRIANGLE * triangles),
            float(4 * voxels + 8 * cases))


def diameter_work(valid: int, lists: int, pairs: int) -> tuple[float, float]:
    """The four-combo pair sweep: 13 bytes a valid slot (float32 xyz and a
    mask byte), 16 a result; 14 FP32 operations a pair of valid vertices."""
    return float(DIAM_OPS_PER_PAIR * pairs), float(13 * valid + 16 * lists)


def compact_work(flags: int, survivors: int, lists: int) -> tuple[float, float]:
    """Stable compaction: every keep flag it is handed (the flags are its
    input: each is read to place the survivors), each survivor read (12
    bytes) and written with its mask byte (13), the counts.  No arithmetic."""
    return 0.0, float(flags + 25 * survivors + 4 * lists)


def masked_range_work(voxels: int, masked: int, cases: int) -> tuple[float, float]:
    """The masked ``(lo, hi)``: every mask value, the image at the masked
    voxels, the range written."""
    return (float(voxels + RANGE_OPS_PER_MASKED * masked),
            float(4 * voxels + 4 * masked + 8 * cases))


def intensity_work(family: str, cases: int, voxels: int, masked: int, pairs: int,
                   n_bins: int) -> tuple[float, float]:
    """First-order or GLCM: the float32 mask at every voxel, the image at
    the masked voxels, the range, the output rows; the operations of the
    masked voxels and of the in-mask neighbour pairs."""
    in_bytes = 4 * voxels + 4 * masked + 8 * cases
    if family == "firstorder":
        packed = 3 + n_bins + 3
        return float(voxels + FO_OPS_PER_MASKED * masked), float(in_bytes + 4 * cases * packed)
    if family == "glcm":
        return (float(voxels + QUANT_OPS * masked + GLCM_OPS_PER_PAIR * pairs),
                float(in_bytes + 4 * cases * n_bins * n_bins))
    raise ValueError(f"unknown intensity family {family!r}")


def least_seconds(work: tuple[float, float]) -> tuple[float, str]:
    """``(seconds, bound)`` of ``(operations, bytes)``: the larger time and
    which of the two it is."""
    ops, nbytes = work
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
