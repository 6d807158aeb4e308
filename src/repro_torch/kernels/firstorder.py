"""First-order intensity statistics of the batched extractor: CUDA kernel wrapper.

Replaces ``repro.kernels.firstorder.firstorder_packed_batch_pallas`` and
its TPU kernel ``_fo_kernel``.  Nine features over the masked voxels of an
intensity volume (mean, std, min, max, P10, median, P90, energy, entropy)
reduce to one packed row per case,
``[count, sum, sum_sq, hist[n_bins], lo, hi, bin_width]``; the features
derive from it on the host (:func:`features_from_packed_np`), so batched
and single-case rows can only differ if the packed rows do.

The addition order is part of the contract, as in the reference: the
flattened, zero-padded volume is cut into canonical chunks of
:data:`CANON_CHUNK` voxels, each chunk's sums are a fixed pairwise tree
(halve the chunk ten times: ``y[:h] + y[h:]``), and the chunk rows are
left-folded in chunk order from zeros.  A chunk's count and histogram
are integer counts, exact in any order; the fold over chunks is not:
float32 holds every integer only up to 2^24, so above 2^24 masked voxels
the float left fold of the counts rounds, and the kernel keeps the
float fold in chunk order for every column, counts included, to round
where the plain version and the reference do.  The kernel
(``csrc/firstorder.cu``) and the plain version
(:func:`firstorder_packed_batch_ref`) both do exactly that, so they agree
bitwise, and the result depends on no block size: a zero chunk adds
exact zeros.  Against the reference, whose chunk sums are
``jnp.sum`` in an order XLA picks, count, histogram and range are exact
and the two sums agree to float32 rounding.

:func:`fold_packed_chunks` is the tiled path's entry to the same kernel:
the stack of mask-touched chunks of a frame, in ascending chunk order,
with the census's range.  An untouched chunk's row is exact zeros and the
fold is a left fold in chunk order, so folding only the touched chunks
gives the in-core row bitwise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import masked_range as _range

N_BINS = 32          # default fixed-bin-count discretisation
CANON_CHUNK = 1024   # canonical accumulation granule (see module docstring)
DEFAULT_BLOCK = 2048  # voxels per CUDA block: canonical chunks, one warp each
# The kernel's revision: an autotune record measured against another one
# is swept again (runtime/autotune.py).  1: one warp a chunk and a staged
# fold.
REVISION = 1
LAUNCHES = 0  # kernel launches by firstorder_packed_batch on CUDA tensors
FOLD_LAUNCHES = 0  # kernel launches by fold_packed_chunks on CUDA tensors

FEATURES = ("Mean", "StdDev", "Minimum", "Maximum", "Percentile10",
            "Median", "Percentile90", "Energy", "Entropy")
N_FEATURES = len(FEATURES)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"firstorder_packed_launch": [_P, _P, _P, _P, _I, _L, _I, _I, _P, _P, _P]}


def stats_width(n_bins: int = N_BINS) -> int:
    """Width of the accumulated stats vector: [count, sum, sum_sq, hist]."""
    return 3 + n_bins


def packed_width(n_bins: int = N_BINS) -> int:
    """Width of the per-case device row: stats ++ [lo, hi, bin_width]."""
    return stats_width(n_bins) + 3


def _padded_len(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _flatten_batch(images, masks, n_bins: int, multiple: int, value_range=None):
    """Flatten, mask and quantise a ``(B, *vol)`` stack, zero-padded to a
    multiple of ``multiple``.

    Returns ``(x, m, q, lo, hi, width)``: the first three ``(B, Lp)``
    (masked-out values zeroed, pads zero), the last three ``(B,)``.
    ``value_range`` is the stack's ``(lo, hi)`` where the caller has it.
    """
    imgs = torch.as_tensor(images, dtype=torch.float32)
    B = imgs.shape[0]
    imgs = imgs.reshape(B, -1)
    m = (torch.as_tensor(masks, device=imgs.device).reshape(B, -1) > 0).to(torch.float32)
    lo, hi = value_range if value_range is not None else _ref.intensity_range(imgs, m, dim=1)
    q, width = _ref.quantize_intensity(imgs, m, lo[:, None], hi[:, None], n_bins)
    x = torch.where(m > 0, imgs, torch.zeros_like(imgs))
    pad = (0, _padded_len(imgs.shape[1], multiple) - imgs.shape[1])
    return (torch.nn.functional.pad(x, pad), torch.nn.functional.pad(m, pad),
            torch.nn.functional.pad(q, pad), lo, hi, width[:, 0])


def features_from_packed_np(packed, n_bins: int = N_BINS) -> np.ndarray:
    """``(..., N_FEATURES)`` rows from packed stats, on the host in numpy.

    The port's copy of the reference's derivation, shared by every device
    and batch depth.  An empty case (count 0) yields an all-zero row; a
    constant-intensity case has ``bin_width == 0``, so every bin centre
    collapses to ``lo`` and std and entropy are exactly 0.
    """
    p = np.asarray(packed, np.float32)
    n, s1, s2 = p[..., 0], p[..., 1], p[..., 2]
    hist = p[..., 3:3 + n_bins]
    lo, hi = p[..., 3 + n_bins], p[..., 4 + n_bins]
    width = p[..., 5 + n_bins]
    nsafe = np.maximum(n, 1.0)
    mean = s1 / nsafe
    var = np.maximum(s2 / nsafe - mean * mean, 0.0)
    prob = hist / nsafe[..., None]
    entropy = -np.sum(
        np.where(prob > 0,
                 prob * np.log2(np.where(prob > 0, prob, 1.0)), 0.0),
        axis=-1,
    )
    centers = (lo[..., None]
               + (np.arange(n_bins, dtype=np.float32) + 0.5)
               * width[..., None])
    cum = np.cumsum(hist, axis=-1)

    def pct(frac):
        # first bin whose cumulative count reaches the frac-quantile rank
        idx = np.argmax(cum >= np.float32(frac) * n[..., None], axis=-1)
        return np.take_along_axis(centers, idx[..., None], axis=-1)[..., 0]

    row = np.stack([
        mean, np.sqrt(var), lo, hi,
        pct(0.1), pct(0.5), pct(0.9), s2, entropy,
    ], axis=-1)
    return np.where(n[..., None] > 0, row, 0.0).astype(np.float32)


def _chunk_tree(y: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) by the canonical pairwise tree."""
    while y.shape[-1] > 1:
        h = y.shape[-1] // 2
        y = y[..., :h] + y[..., h:]
    return y[..., 0]


def firstorder_packed_batch_ref(images, masks, n_bins: int = N_BINS,
                                value_range=None) -> torch.Tensor:
    """Plain version of the kernel: ``(B, packed_width)`` float32 rows.

    Per canonical chunk: the masked-voxel count, the tree sums of ``x``
    and ``x * x`` and the histogram; then the left fold over chunks.
    """
    x, m, q, lo, hi, width = _flatten_batch(images, masks, n_bins, CANON_CHUNK, value_range)
    B, Lp = x.shape
    nc = Lp // CANON_CHUNK
    xs = x.reshape(B, nc, CANON_CHUNK)
    inside = m.reshape(B, nc, CANON_CHUNK) > 0
    chunk_id = torch.arange(B * nc, device=x.device).reshape(B, nc, 1)
    bins = (chunk_id * n_bins + q.reshape(B, nc, CANON_CHUNK).long())[inside]
    hist = torch.bincount(bins, minlength=B * nc * n_bins).reshape(B, nc, n_bins)
    parts = torch.cat([inside.sum(-1, keepdim=True).to(torch.float32),
                       _chunk_tree(xs)[..., None], _chunk_tree(xs * xs)[..., None],
                       hist.to(torch.float32)], dim=-1)
    acc = torch.zeros((B, stats_width(n_bins)), dtype=torch.float32, device=x.device)
    for c in range(nc):
        acc = acc + parts[:, c]
    return torch.cat([acc, lo[:, None], hi[:, None], width[:, None]], dim=1)


def _launch(images: torch.Tensor, masks: torch.Tensor, n_bins: int, block: int,
            value_range) -> torch.Tensor:
    """The kernel's launch over a checked (B, X, Y, Z) stack on the card."""
    _ref.check_volumes(images, masks)
    batch = images.shape[0]
    voxels = images[0].numel()
    lo, hi = value_range if value_range is not None else _range.masked_range_batch(images, masks)
    nc = _padded_len(-(-voxels // CANON_CHUNK), 4)  # the kernel's rows: 16-byte tiles
    partials = torch.empty((batch, nc, stats_width(n_bins)), dtype=torch.float32,
                           device=images.device)
    out = torch.empty((batch, packed_width(n_bins)), dtype=torch.float32,
                      device=images.device)
    lib = _build.load("firstorder", _SIGNATURES)
    with torch.cuda.device(images.device):
        err = lib.firstorder_packed_launch(
            images.data_ptr(), masks.data_ptr(), lo.data_ptr(), hi.data_ptr(), batch,
            voxels, n_bins, block // CANON_CHUNK, partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "firstorder_packed_batch")
    return out


def firstorder_packed_batch(images: torch.Tensor, masks: torch.Tensor, *,
                            n_bins: int = N_BINS, block: int = DEFAULT_BLOCK,
                            value_range=None) -> torch.Tensor:
    """``(B, packed_width)`` float32 packed first-order stats of a stack.

    ``images``/``masks``: (B, X, Y, Z) float32, one shape bucket.  A CUDA
    tensor launches the kernel (or raises); only a CPU tensor takes the
    plain version.  ``block`` (a multiple of :data:`CANON_CHUNK`) is the
    voxels one CUDA block owns, one warp a chunk (at most 8 warps a
    block); it never changes a bit of the result.
    ``value_range`` is the masked ``(lo, hi)`` of ``ref.intensity_range``
    over each case, two ``(B,)`` tensors, where the caller has it (the
    executor takes it once for both families); else it is taken here
    (``masked_range.masked_range_batch``).
    """
    global LAUNCHES
    if block % CANON_CHUNK or block <= 0:
        raise ValueError(f"firstorder block must be a positive multiple of "
                         f"CANON_CHUNK={CANON_CHUNK}, got {block}")
    _ref.check_bins(n_bins)
    if images.device.type == "cpu":
        return firstorder_packed_batch_ref(images, masks, n_bins, value_range)
    out = _launch(images, masks, n_bins, block, value_range)
    LAUNCHES += 1
    return out


def fold_packed_chunks(x: torch.Tensor, m: torch.Tensor, lo, hi,
                       n_bins: int = N_BINS) -> torch.Tensor:
    """``(packed_width,)`` packed stats from a stack of touched chunks.

    Replaces ``repro.kernels.firstorder.fold_packed_chunks`` (the tiled
    path's fold).  ``x``/``m``: (nt, CANON_CHUNK) float32 masked values and
    mask lanes of the mask-touched canonical chunks of a frame, in
    ascending global chunk order; ``lo``/``hi`` the masked intensity range
    (exact min and max, so a streamed census has the same bits).  Each
    chunk's row is the in-core row of that chunk and the fold is the
    in-core left fold, so the result equals the in-core row of the whole
    frame bitwise.  A CUDA tensor runs the first-order kernel
    (``csrc/firstorder.cu``) on the stack, one case of ``nt`` chunks; a CPU
    tensor its plain version.
    """
    global FOLD_LAUNCHES
    _ref.check_bins(n_bins)
    if x.ndim != 2 or x.shape[1] != CANON_CHUNK or m.shape != x.shape or not len(x):
        raise ValueError(f"need (nt, {CANON_CHUNK}) chunk stacks, got {tuple(x.shape)} "
                         f"and {tuple(m.shape)}")
    stack = (1, x.shape[0], 1, CANON_CHUNK)  # one case whose flattening is the stack
    rng = tuple(torch.as_tensor(v, dtype=torch.float32, device=x.device).reshape(1)
                for v in (lo, hi))
    if x.device.type == "cpu":
        return firstorder_packed_batch_ref(x.reshape(stack), m.reshape(stack), n_bins, rng)[0]
    out = _launch(x.contiguous().reshape(stack), m.contiguous().reshape(stack), n_bins,
                  DEFAULT_BLOCK, rng)
    FOLD_LAUNCHES += 1
    return out[0]
