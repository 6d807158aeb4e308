"""Out-of-core tiled extraction smoke: ``python -m repro_torch.launch.tiled_smoke``.

Counterpart of ``repro.launch.tiled_smoke``, the executable half of the
tiled path's checks (``tests/test_torch_tiled.py`` is the other): runs one
small case through the tiled engine at a deliberately tiny staged-bytes
budget -- many single-granule tiles, every prune level -- and holds each
row bitwise against the in-core ``extract_one`` oracle (the port's tiled
rows equal ``extract_one``'s at every prune level, ``'bounds'`` too);
then streams a 128^3 analytic sphere that the budget could never
materialise, and holds its staged-bytes peak under the budget.

    PYTHONPATH=src python -m repro_torch.launch.tiled_smoke                # the card
    PYTHONPATH=src python -m repro_torch.launch.tiled_smoke --device cpu

Any parity break, budget breach or degenerate row is a nonzero exit.
"""
from __future__ import annotations

import argparse
import sys
import time
import warnings

import numpy as np

from repro_torch.core.pipeline import BatchedExtractor
from repro_torch.core.tiled import TiledExtractor
from repro_torch.data.tiles import FnSlabSource, TiledCase

SPHERE_N = 128  # the out-of-core sphere's edge (8 MiB materialised)
SPHERE_BUDGET = 1 << 20  # its staged-bytes budget


def blobby_case(shape=(36, 40, 150), seed=7):
    """Two spheres far apart along z, with a seeded normal image."""
    rng = np.random.default_rng(seed)
    X, Y, Z = shape
    mask = np.zeros(shape, np.float32)
    xs, ys, zs = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z), indexing="ij")
    for cx, cy, cz, r in ((18, 20, 22, 11), (16, 19, 128, 9)):
        d2 = ((xs - cx) / r) ** 2 + ((ys - cy) / r) ** 2 + ((zs - cz) / r) ** 2
        mask[d2 < 1.0] = 1.0
    image = rng.normal(size=shape).astype(np.float32)
    spacing = np.asarray([1.0, 1.1, 0.9], np.float32)
    return image, mask, spacing


def sphere_slab(z0: int, z1: int, n: int = SPHERE_N) -> np.ndarray:
    """Planes ``z0:z1`` of an analytic sphere of radius 0.42 n."""
    ax = ((np.arange(n) - n / 2) / (n * 0.42)) ** 2
    az = ((np.arange(z0, z1) - n / 2) / (n * 0.42)) ** 2
    r2 = ax[:, None, None] + ax[None, :, None] + az[None, None, :]
    return (r2 < 1.0).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:N' or 'cpu'")
    ap.add_argument("--budget-kb", type=int, default=192,
                    help="staged-bytes budget of the parity case (tiny: many tiles)")
    args = ap.parse_args(argv)
    budget = args.budget_kb * 1024
    t_start = time.perf_counter()

    image, mask, spacing = blobby_case()
    bx = BatchedExtractor(device=args.device, families=("shape", "firstorder"))
    oracle = bx.extract_one(image, mask, spacing)
    case = TiledCase(mask, image=image, spacing=spacing)
    for level in ("none", "occupancy", "bounds"):
        tx = TiledExtractor(bx.executor, budget_bytes=budget, tile_prune=level)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # the minimal tile's warning
            res = tx.extract(case)
        s = res.stats
        bitwise = np.array_equal(oracle, res.row)
        print(f"tiled_smoke {level:9s}: tiles={s['tiles']} skipped={s['tiles_skipped']} "
              f"bounds_pruned={s['tiles_bounds_pruned']} bitwise={bitwise}")
        if not bitwise:
            print(f"tiled_smoke FAIL: {level} parity broke (oracle={oracle!r} "
                  f"tiled={res.row!r})", file=sys.stderr)
            return 1

    # out of core: the sphere exists only as an analytic slab function;
    # mc_chunk=4 makes a granule 5 staged planes, so two tiles of this frame
    # fit the 1 MiB budget, 8x below the volume
    ooc = TiledCase(FnSlabSource(sphere_slab, (SPHERE_N,) * 3))
    tx = TiledExtractor(BatchedExtractor(device=args.device, mc_chunk=4).executor,
                        budget_bytes=SPHERE_BUDGET, tile_prune="bounds")
    res = tx.extract(ooc)
    peak = res.stats["staged_bytes_peak"]
    print(f"tiled_smoke out_of_core: {SPHERE_N}^3 volume ({4 * SPHERE_N ** 3 >> 20} MiB) "
          f"through {res.stats['tiles']} tiles, staged peak {peak / 2**10:.0f} KiB of a "
          f"{SPHERE_BUDGET >> 10} KiB budget, mesh volume {res.row[0]:.1f}")
    if peak > SPHERE_BUDGET:
        print(f"tiled_smoke FAIL: staged peak {peak} B over the {SPHERE_BUDGET} B budget",
              file=sys.stderr)
        return 1
    if not np.isfinite(res.row).all() or res.row[0] <= 0:
        print("tiled_smoke FAIL: degenerate out-of-core row", file=sys.stderr)
        return 1
    print(f"tiled_smoke OK in {time.perf_counter() - t_start:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
