"""Synthetic CT volumes + ROI masks mimicking the paper's KITS19 test set.

The port's own copy of ``repro.data.synthetic`` (numpy only): the 20
Table-2 shapes, ``make_case``, the suite, the cohort stream
``stream_cases`` and the service's ``mixed_traffic_stream``.
``tests/test_torch_port_rules.py`` holds ``make_case`` array-equal to the
JAX package's for the same shape and seed, ``tests/test_torch_service.py``
the traffic stream, ``tests/test_torch_resilience.py`` ``stream_cases``.

The paper benchmarks on 20 KITS19 kidney/tumour cases spanning image sizes
50 kB - 9 MB and 2 700 - 236 588 mesh vertices (Table 2).  The dataset is not
shipped, so we generate deterministic synthetic cases with the *exact image
dimensions* of Table 2 and organic multi-ellipsoid ROIs that land in the
same vertex-count regime.
"""
from __future__ import annotations

import numpy as np

# (case id, image dims (x, y, z)) -- from paper Table 2.
TABLE2_CASES = [
    ("00000-1", (231, 104, 264)),
    ("00000-2", (28, 30, 59)),
    ("00001-1", (322, 126, 219)),
    ("00001-2", (51, 62, 135)),
    ("00002-1", (230, 109, 163)),
    ("00002-2", (50, 45, 44)),
    ("00003-1", (237, 122, 135)),
    ("00003-2", (39, 35, 31)),
    ("00004-1", (254, 70, 36)),
    ("00004-2", (35, 37, 10)),
    ("00005-1", (167, 94, 285)),
    ("00005-2", (51, 53, 121)),
    ("00006-1", (308, 102, 36)),
    ("00006-2", (41, 43, 13)),
    ("00007-1", (265, 101, 39)),
    ("00007-2", (39, 43, 12)),
    ("00008-1", (288, 177, 54)),
    ("00008-2", (127, 154, 41)),
    ("00009-1", (241, 95, 47)),
    ("00009-2", (39, 33, 11)),
]


def make_case(shape, seed=0, spacing=(1.0, 1.0, 1.0), n_blobs=None,
              roi_contrast=60.0):
    """Deterministic synthetic (image, mask, spacing) for one case.

    The ROI is a union of overlapping random ellipsoids with a low-frequency
    boundary perturbation, producing organic surfaces whose vertex counts
    scale with the volume like the kidney/tumour ROIs in KITS19.

    The image is a CT-like float32 intensity volume (soft-tissue
    N(40, 15) background, ``roi_contrast`` HU added inside the ROI);
    shape-only extraction ignores it.
    """
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    gx = np.arange(nx, dtype=np.float32)[:, None, None]
    gy = np.arange(ny, dtype=np.float32)[None, :, None]
    gz = np.arange(nz, dtype=np.float32)[None, None, :]

    if n_blobs is None:
        n_blobs = int(rng.integers(2, 5))
    mask = np.zeros(shape, dtype=bool)
    center0 = np.array([nx, ny, nz]) * (0.35 + 0.3 * rng.random(3))
    for _ in range(n_blobs):
        c = center0 + (rng.random(3) - 0.5) * np.array([nx, ny, nz]) * 0.25
        r = np.maximum(2.5, np.array([nx, ny, nz]) * (0.12 + 0.18 * rng.random(3)))
        d2 = ((gx - c[0]) / r[0]) ** 2 + ((gy - c[1]) / r[1]) ** 2 + ((gz - c[2]) / r[2]) ** 2
        # low-frequency wobble makes the surface organic (more vertices)
        wob = (
            0.15 * np.sin(gx * rng.uniform(0.1, 0.35) + rng.random() * 7)
            * np.sin(gy * rng.uniform(0.1, 0.35) + rng.random() * 7)
            * np.sin(gz * rng.uniform(0.1, 0.35) + rng.random() * 7)
        )
        mask |= d2 + wob < 1.0
    if not mask.any():  # degenerate shapes (tiny volumes): central voxel
        mask[nx // 2, ny // 2, nz // 2] = True

    # CT-like image: soft-tissue background + ROI contrast + noise
    image = rng.normal(40.0, 15.0, size=shape).astype(np.float32)
    image[mask] += np.float32(roi_contrast)
    return image, mask, np.asarray(spacing, np.float32)


def table2_suite(seed=0, spacing=(1.0, 1.0, 1.0)):
    """The full 20-case synthetic suite with Table-2 dimensions."""
    out = []
    for i, (name, shape) in enumerate(TABLE2_CASES):
        img, msk, sp = make_case(shape, seed=seed * 1000 + i, spacing=spacing)
        out.append((name, img, msk, sp))
    return out


def stream_cases(n, dims_pool=None, seed=0, spacing=(1.0, 1.0, 1.0), skip=()):
    """Lazy case stream for a cohort run (``extract_stream``,
    ``runtime/resilience.ResilientRunner``).

    Yields ``(name, image, mask, spacing)`` one case at a time, without
    materialising the cohort: a stream preps window k+1 while the card
    runs window k, so the producer is an iterator.  ``dims_pool``
    defaults to the first 8 Table-2 dimensions; ``skip`` names cases to
    leave out (a restart's done cases).

    Always yields exactly ``n`` surviving cases: a skipped name advances
    the index past it rather than shrinking the output, and each case's
    content stays keyed to its original index (``case-i`` is the same
    whether or not earlier names were skipped).
    """
    if dims_pool is None:
        dims_pool = [d for _, d in TABLE2_CASES if min(d) >= 10][:8]
    produced, i = 0, 0
    while produced < n:
        name = f"case-{i:05d}"
        if name in skip:
            i += 1
            continue
        img, msk, sp = make_case(dims_pool[i % len(dims_pool)], seed=seed + i,
                                 spacing=spacing)
        yield name, img, msk, sp
        produced += 1
        i += 1


def mixed_traffic_stream(n, seed=0, huge_every=16, small_dims=None,
                         huge_dims=(96, 96, 96), spacing=(1.0, 1.0, 1.0)):
    """Mixed service traffic: many small ROIs plus rare huge cases.

    Clinic-sized single studies interleaved with occasional
    research-cohort volumes: every ``huge_every``-th case uses
    ``huge_dims``, the rest cycle a pool of small dimensions
    (``huge_every=0``: none huge).  Yields ``(name, image, mask,
    spacing)``; drives ``launch/serve``.
    """
    if small_dims is None:
        small_dims = [(24, 28, 32), (32, 36, 40), (28, 40, 34), (36, 30, 26)]
    for i in range(n):
        huge = bool(huge_every) and (i % huge_every == huge_every - 1)
        dims = huge_dims if huge else small_dims[i % len(small_dims)]
        name = f"{'huge' if huge else 'small'}-{i:05d}"
        img, msk, sp = make_case(dims, seed=seed + i, spacing=spacing)
        yield name, img, msk, sp
