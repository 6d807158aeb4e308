"""Synthetic KiTS19-like cases made from a seed, on the device.

The arithmetic of the port's ``make_case`` (``repro_torch/data/synthetic``),
copied here so the yardstick cannot move with the program: a union of two
to four overlapping ellipsoids with a low-frequency wobble on the boundary,
inside a CT-like float32 image (N(40, 15) background, +60 inside the ROI).
The random scalars of a dimension's cases are Latin-hypercube stratified
(each scalar's draws over the dimension's ``per_dim`` cases fall one in
each of ``per_dim`` equal strata).  The scalars that set a case's size
and extent, its blob count and its blobs' centres and radii, are drawn
from a fixed seed (``SIZE_SEED``), so every run's pool holds the same set
of sizes; the run's seed draws the rest (the wobble of each surface, the
image noise) and the order the traffic sends the cases in.  The volumes are computed on ``device``
with a ``torch.Generator`` there, then handed to the program as the numpy
``(image, mask, spacing)`` a user passes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the 20 image dimensions (x, y, z) of Table 2 of arXiv:2510.02894 (KiTS19 crops)
TABLE2_DIMS = (
    (231, 104, 264), (28, 30, 59), (322, 126, 219), (51, 62, 135), (230, 109, 163),
    (50, 45, 44), (237, 122, 135), (39, 35, 31), (254, 70, 36), (35, 37, 10),
    (167, 94, 285), (51, 53, 121), (308, 102, 36), (41, 43, 13), (265, 101, 39),
    (39, 43, 12), (288, 177, 54), (127, 154, 41), (241, 95, 47), (39, 33, 11),
)

MAX_BLOBS = 4
# scalars a case draws: the blob count, the common centre (3), and per blob
# the centre offset (3), the radii (3), three wobble frequencies and three phases
N_SCALARS = 1 + 3 + MAX_BLOBS * 12
# the size scalars: the blob count, the common centre, and each blob's
# centre offset and three radii
SIZE_SLOTS = [0, 1, 2, 3] + [4 + 12 * b + k for b in range(MAX_BLOBS) for k in range(6)]
SIZE_SEED = 0


@dataclasses.dataclass
class Case:
    name: str
    dims: tuple
    image: np.ndarray  # float32 (x, y, z)
    mask: np.ndarray  # bool (x, y, z)
    spacing: np.ndarray  # float32 (3,)
    bbox: tuple  # the ROI bounding box's extent (x, y, z), in voxels

    @property
    def triple(self):
        """The ``(image, mask, spacing)`` a user hands the program."""
        return self.image, self.mask, self.spacing


def mix_seed(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a salt."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(salt) * 0xBF58476D1CE4E5B9) % (1 << 63)


def stratified_scalars(seed: int, n_dims: int, per_dim: int) -> torch.Tensor:
    """``(n_dims, per_dim, N_SCALARS)`` float64 uniforms in [0, 1): for each
    dimension and scalar, one draw in each of ``per_dim`` strata, in a
    random order."""
    g = torch.Generator().manual_seed(mix_seed(seed, 1))
    order = torch.rand((n_dims, N_SCALARS, per_dim), generator=g).argsort(-1)
    jitter = torch.rand((n_dims, N_SCALARS, per_dim), generator=g, dtype=torch.float64)
    u = (order.to(torch.float64) + jitter) / per_dim
    return u.transpose(1, 2).contiguous()


def case_volumes(shape, u: torch.Tensor, noise_gen: torch.Generator, device):
    """``(image, mask)`` device tensors of one case from its scalars ``u``."""
    nx, ny, nz = (int(s) for s in shape)
    dims = torch.tensor([nx, ny, nz], dtype=torch.float64)
    g = [torch.arange(n, dtype=torch.float32, device=device) for n in (nx, ny, nz)]
    gx, gy, gz = g[0][:, None, None], g[1][None, :, None], g[2][None, None, :]
    n_blobs = 2 + min(2, int(u[0] * 3))
    center0 = dims * (0.35 + 0.3 * u[1:4])
    mask = torch.zeros((nx, ny, nz), dtype=torch.bool, device=device)
    for b in range(n_blobs):
        v = u[4 + 12 * b: 16 + 12 * b]
        c = center0 + (v[0:3] - 0.5) * dims * 0.25
        r = torch.clamp(dims * (0.12 + 0.18 * v[3:6]), min=2.5)
        freq = 0.1 + 0.25 * v[6:9]
        phase = v[9:12] * 7.0
        c, r, freq, phase = ([float(x) for x in t] for t in (c, r, freq, phase))
        d2 = (((gx - c[0]) / r[0]) ** 2 + ((gy - c[1]) / r[1]) ** 2
              + ((gz - c[2]) / r[2]) ** 2)
        wob = (0.15 * torch.sin(gx * freq[0] + phase[0]) * torch.sin(gy * freq[1] + phase[1])
               * torch.sin(gz * freq[2] + phase[2]))
        mask |= d2 + wob < 1.0
    if not bool(mask.any()):  # degenerate shapes (tiny volumes): central voxel
        mask[nx // 2, ny // 2, nz // 2] = True
    image = torch.randn((nx, ny, nz), generator=noise_gen, device=device) * 15.0 + 40.0
    image = image + mask.to(torch.float32) * 60.0
    return image, mask


def bbox_extent(mask: torch.Tensor) -> tuple:
    """The extent (x, y, z) of the bounding box of a non-empty mask."""
    out = []
    for axis in range(3):
        idx = mask.any(dim=tuple(a for a in range(3) if a != axis)).nonzero()[:, 0]
        out.append(int(idx[-1] - idx[0]) + 1)
    return tuple(out)


def build_pool(seed: int, dims=TABLE2_DIMS, per_dim: int = 4, spacing=(1.0, 1.0, 1.0),
               device="cuda") -> list[Case]:
    """``per_dim`` distinct cases of each dimension, in dimension order."""
    device = torch.device(device)
    u = stratified_scalars(seed, len(dims), per_dim)
    u[:, :, SIZE_SLOTS] = stratified_scalars(SIZE_SEED, len(dims), per_dim)[:, :, SIZE_SLOTS]
    noise = torch.Generator(device=device).manual_seed(mix_seed(seed, 2))
    sp = np.asarray(spacing, np.float32)
    pool = []
    for d, shape in enumerate(dims):
        for j in range(per_dim):
            image, mask = case_volumes(shape, u[d, j], noise, device)
            pool.append(Case(f"d{d:02d}-{j}", tuple(shape), image.cpu().numpy(),
                             mask.cpu().numpy(), sp.copy(), bbox_extent(mask)))
    return pool
