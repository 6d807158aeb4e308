"""GLCM texture family of the batched extractor: CUDA kernel wrapper.

Replaces ``repro.kernels.glcm.glcm_matrix_batch_pallas`` and its TPU
kernel ``_glcm_kernel``.  The gray-level co-occurrence matrix counts the
ordered pairs ``(q(v), q(v + offset))`` of quantised intensities at the
three distance-1 axial offsets (:data:`OFFSETS`), over pairs whose voxels
are both in the mask, and is symmetrised to ``g + g^T``.  The TPU kernel
scattered with one-hot matrix products over concatenated pair arrays;
the card's kernel (``csrc/glcm.cu``) quantises each tile of a case once
into shared memory (:func:`tiling`), counts its pairs there with integer
atomics into replicated histograms, writes one partial row a tile, and
sums the rows in a second launch.  Every count is an integer, exact
in any order and, below 2^24, in float32 (see :func:`glcm_matrix_batch`
for when that holds), so kernel, plain version
(:func:`glcm_matrix_batch_ref`) and reference agree exactly, and so do
the Haralick rows derived from them on the host
(:func:`glcm_features_from_matrix_np`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import masked_range as _range

N_BINS = 32
DEFAULT_BLOCK = 4  # CUDA blocks an SM the launch aims at (:func:`tiling`)
MAX_BLOCK = 64
TILE_BYTES = 16384  # shared int8 bins of a tile, halo included (csrc/glcm.cu)
MIN_TILE_VOXELS = 4096  # the fewest voxels a tile aims at
# The kernel's revision: an autotune record measured against another one
# is swept again (runtime/autotune.py).  2: quantise-once tiles in shared
# memory, private histograms, a partial row a tile and a summing launch.
REVISION = 2
LAUNCHES = 0  # glcm_matrix_batch calls that launched the kernel (its two passes)
#: distance-1 axial co-occurrence offsets along (X, Y, Z) of a (B, X, Y, Z)
#: stack (symmetrised afterwards, so the opposite directions are covered)
OFFSETS = ((1, 0, 0), (0, 1, 0), (0, 0, 1))

FEATURES = ("Contrast", "Correlation", "Idm", "JointEnergy")
N_FEATURES = len(FEATURES)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"glcm_matrix_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                                      _P]}


def valid_block(block) -> bool:
    """Whether the kernel takes ``block`` (CUDA blocks an SM) as its knob."""
    return block == int(block) and 1 <= block <= MAX_BLOCK


def tiling(shape, batch: int, block: int, sms: int) -> tuple[int, int, int]:
    """The kernel's tile ``(d, ry, rz)``: x-planes, y-rows and z-columns a
    CUDA block owns in one case of ``shape`` (its halo aside).

    The launch aims at ``block`` CUDA blocks on each of ``sms`` SMs over
    ``batch`` cases, tiles of at least :data:`MIN_TILE_VOXELS`, as near
    square in (x, y) as the volume allows, with whole z-rows unless a
    row's halo tile would pass :data:`TILE_BYTES`; then the tile shrinks
    until ``(d + 1)(ry + 1)(rz + 1)``, clipped to the volume, fits in it.
    Every tiling counts the same pairs (``tests/test_torch_tile_models.py``).
    """
    nx, ny, nz = (int(s) for s in shape)
    rz = min(nz, TILE_BYTES // 4 - 1)  # a z-split only past 4095 columns
    target = max(1, -(-int(block) * int(sms) // int(batch)))  # tiles a case
    area = max(1, max(MIN_TILE_VOXELS, -(-nx * ny * nz // target)) // rz)  # d x ry
    ry = max(1, min(ny, math.isqrt(area)))
    d = max(1, min(nx, area // ry))
    while min(d + 1, nx) * min(ry + 1, ny) * min(rz + 1, nz) > TILE_BYTES:
        if d >= ry:
            d -= 1
        else:
            ry -= 1
    return d, ry, rz


def tile_count(shape, d: int, ry: int, rz: int) -> int:
    """Tiles (CUDA blocks) of one case under the tiling ``(d, ry, rz)``."""
    nx, ny, nz = (int(s) for s in shape)
    return -(-nx // d) * -(-ny // ry) * -(-nz // rz)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pair_arrays(q, m):
    """Flatten one case's co-occurrence pairs: ``(q1, q2, valid)``.

    ``q`` is the float32 bin-id volume, ``m`` the float32 mask; each
    offset in :data:`OFFSETS` contributes the overlapping slab of
    (voxel, neighbour) pairs.  The plain version's input (the kernel reads
    the neighbours in place).
    """
    q1s, q2s, vs = [], [], []
    for off in OFFSETS:
        a = tuple(slice(None, -o) if o else slice(None) for o in off)
        b = tuple(slice(o, None) for o in off)
        q1s.append(q[a].reshape(-1))
        q2s.append(q[b].reshape(-1))
        vs.append((m[a] * m[b]).reshape(-1))
    return torch.cat(q1s), torch.cat(q2s), torch.cat(vs)


def _quantize_batch(images, masks, n_bins: int, value_range=None):
    imgs = torch.as_tensor(images, dtype=torch.float32)
    m = (torch.as_tensor(masks, device=imgs.device) > 0).to(torch.float32)
    B = imgs.shape[0]
    lo, hi = (value_range if value_range is not None else
              _ref.intensity_range(imgs.reshape(B, -1), m.reshape(B, -1), dim=1))
    bcast = (B,) + (1,) * (imgs.ndim - 1)
    q, _ = _ref.quantize_intensity(imgs, m, lo.reshape(bcast), hi.reshape(bcast), n_bins)
    return q, m


def glcm_features_from_matrix_np(mat, n_bins: int = N_BINS) -> np.ndarray:
    """``(..., N_FEATURES)`` Haralick rows from symmetric count matrices.

    The port's copy of the reference's host derivation, in numpy.
    ``correlation`` of a zero-variance (single gray level) matrix is 1.0,
    as in PyRadiomics; a matrix with no pairs yields an all-zero row.
    """
    mat = np.asarray(mat, np.float32)
    total = np.sum(mat, axis=(-2, -1))
    P = mat / np.maximum(total, 1.0)[..., None, None]
    i = np.arange(n_bins, dtype=np.float32)[:, None]
    j = np.arange(n_bins, dtype=np.float32)[None, :]
    diff2 = (i - j) * (i - j)
    contrast = np.sum(diff2 * P, axis=(-2, -1))
    idm = np.sum(P / (1.0 + diff2), axis=(-2, -1))
    energy = np.sum(P * P, axis=(-2, -1))
    # marginal stats (symmetric matrix: px == py)
    px = np.sum(P, axis=-1)
    levels = np.arange(n_bins, dtype=np.float32)
    mu = np.sum(levels * px, axis=-1)
    sig2 = np.sum(
        (levels - mu[..., None]) * (levels - mu[..., None]) * px, axis=-1
    )
    corr = np.where(
        sig2 > 0,
        (np.sum(i * j * P, axis=(-2, -1)) - mu * mu)
        / np.where(sig2 > 0, sig2, 1.0),
        1.0,
    )
    row = np.stack([contrast, corr, idm, energy], axis=-1)
    return np.where(total[..., None] > 0, row, 0.0).astype(np.float32)


def glcm_matrix_batch_ref(images, masks, n_bins: int = N_BINS,
                          value_range=None) -> torch.Tensor:
    """Plain version of the kernel: ``(B, n_bins, n_bins)`` float32
    symmetric counts, per case a ``bincount`` over :func:`pair_arrays`."""
    q, m = _quantize_batch(images, masks, n_bins, value_range)
    out = []
    for qb, mb in zip(q, m):
        q1, q2, v = pair_arrays(qb, mb)
        idx = (q1.long() * n_bins + q2.long())[v > 0]
        g = torch.bincount(idx, minlength=n_bins * n_bins).reshape(n_bins, n_bins)
        out.append(g + g.T)
    return torch.stack(out).to(torch.float32)


def glcm_matrix_batch(images: torch.Tensor, masks: torch.Tensor, *,
                      n_bins: int = N_BINS, block: int = DEFAULT_BLOCK,
                      value_range=None) -> torch.Tensor:
    """``(B, n_bins, n_bins)`` float32 symmetric co-occurrence counts.

    ``images``/``masks``: (B, X, Y, Z) float32, one shape bucket.  A CUDA
    tensor launches the kernel (or raises); only a CPU tensor takes the
    plain version.  ``block`` (1 to :data:`MAX_BLOCK`) is the CUDA blocks
    an SM the launch aims at, which sizes the tiles (:func:`tiling`); it
    never changes the result.
    ``value_range`` is the masked ``(lo, hi)`` of ``ref.intensity_range``
    over each case where the caller has it; else it is taken here
    (``masked_range.masked_range_batch``).

    The float32 counts are exact while each is below 2^24, as in the
    reference; a symmetrised count is at most twice the case's pairs,
    three per masked voxel, so that holds for fewer than 2^24 / 6
    (2,796,202) masked voxels per case.  Above that the kernel and the
    plain version round each exact integer count to float32 once, the
    reference's float32 scatter may round at every step: the two can
    then differ.
    """
    global LAUNCHES
    if not valid_block(block):
        raise ValueError(f"glcm block must be an integer in [1, {MAX_BLOCK}], got {block}")
    _ref.check_bins(n_bins)
    if images.device.type == "cpu":
        return glcm_matrix_batch_ref(images, masks, n_bins, value_range)
    _ref.check_volumes(images, masks)
    batch, nx, ny, nz = images.shape
    if 6 * nx * ny * nz >= 2 ** 31:
        raise ValueError(f"volumes of {nx * ny * nz} voxels are outside the kernel's 32-bit "
                         f"counts")
    d, ry, rz = tiling((nx, ny, nz), batch, int(block), _sm_count(images.device.index))
    tiles = tile_count((nx, ny, nz), d, ry, rz)
    if batch * tiles >= 2 ** 31:
        raise ValueError(f"{batch} x {tiles} tiles are outside the kernel's grid")
    lo, hi = value_range if value_range is not None else _range.masked_range_batch(images, masks)
    partials = torch.empty((batch, tiles, n_bins * n_bins), dtype=torch.int32,
                           device=images.device)
    out = torch.empty((batch, n_bins, n_bins), dtype=torch.float32, device=images.device)
    lib = _build.load("glcm", _SIGNATURES)
    with torch.cuda.device(images.device):
        err = lib.glcm_matrix_launch(
            images.data_ptr(), masks.data_ptr(), lo.data_ptr(), hi.data_ptr(), batch,
            nx, ny, nz, n_bins, d, ry, rz, partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "glcm_matrix_batch")
    LAUNCHES += 1
    return out
