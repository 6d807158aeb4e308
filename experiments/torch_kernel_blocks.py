#!/usr/bin/env python3
"""Times this checkout's MC, first-order, GLCM and compaction kernels by block.

    python3 experiments/torch_kernel_blocks.py [--reps 20]

On the inputs of ``chip_smoke.py`` phase 5c: marching cubes at case
00001-1 of ``table2_suite(seed=0)`` cropped to its ROI (228 x 84 x 141)
and at the largest pass-2a stack of the 60-case cohort (seeds 0-2),
threads a block 32-1024 (its bits the same at each: checked); first-order
at that stack's images and masks, blocks of 1024-16384 voxels, and GLCM
there at 1-64 blocks an SM (each bitwise the same: checked); compaction at
the largest launch of a batched run over the cohort, tiles of 512-16384
keep flags (bitwise the same: checked), beside its launch floor (an empty
kernel on the same grid; the kernel's two passes pay it twice).  Per
launch the median ms per call (CUDA events) and the device time of each
kernel from a ``torch.profiler`` trace, beside the card's ``nvidia-smi``
name and power limit; one JSON line.  Needs a CUDA card.
"""
import argparse
import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
MC_BLOCKS = (32, 64, 96, 128, 192, 256, 512, 1024)
FO_BLOCKS = (1024, 2048, 4096, 8192, 16384)
GLCM_BLOCKS = (1, 2, 4, 8, 16, 64)
COMPACT_TILES = (512, 1024, 2048, 4096, 8192, 16384)


def load_smoke():
    """This checkout's ``chip_smoke`` module (its helpers, its ``sys.path``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_blocks: no CUDA device")
    cs = load_smoke()
    from repro_torch.core import plan
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cohort = [c for seed in (0, 1, 2) for c in cs.table2_suite(seed=seed)]
    groups = {}
    for _, img, msk, sp in cohort:
        im, m, _ = cs.crop_to_roi(img, msk)
        b = plan.shape_bucket(tuple(s - 2 for s in m.shape))
        groups.setdefault(b, []).append((im, m, sp))
    bucket, members = max(groups.items(), key=lambda kv: np.prod(kv[0]) * len(kv[1]))

    def pad(a):
        return np.pad(a, [(0, b - s) for b, s in zip(bucket, a.shape)])

    imgs = torch.from_numpy(np.stack([pad(im) for im, _, _ in members])).to(dev)
    msks = torch.from_numpy(np.stack([pad(m) for _, m, _ in members])).to(dev)
    sps = np.stack([sp for _, _, sp in members]).astype(np.float32)
    _, msk1, sp1 = next(c[1:] for c in cohort if c[0] == "00001-1")
    _, single, _ = cs.crop_to_roi(msk1, msk1)
    vol1 = torch.from_numpy(single).to(dev)
    flat = (len(imgs), -1)
    rng = ref.intensity_range(imgs.reshape(flat), msks.reshape(flat), dim=1)

    def measure(fn, names):
        split = cs.device_split(fn)
        return {"ms": cs.time_ms(fn, reps=args.reps),
                "device_us": {n: round(sum(us for k, us in split.items() if n in k), 3)
                              for n in names}}

    out = {"card": smi, "mc_single": {"shape": list(single.shape)},
           "mc_stack": {"shape": list(msks.shape)}, "firstorder": {"shape": list(imgs.shape)}}
    mc_names = ("mc_partials_kernel", "mc_finalize_kernel")
    for key, fn in (("mc_single", lambda b: torch.stack(cs.mc.mc_volume_area(vol1, 0.5, sp1,
                                                                            block=b))),
                    ("mc_stack", lambda b: cs.mc.mc_volume_area_batch(msks, 0.5, sps, block=b))):
        base = fn(cs.mc.DEFAULT_BLOCK)
        for b in MC_BLOCKS:
            cs.check(torch.equal(fn(b), base), f"{key}: block {b} changed a bit")
            out[key][b] = measure(lambda: fn(b), mc_names)
    fo_names = ("fo_partials_kernel", "fo_fold_kernel")
    base = cs.fo.firstorder_packed_batch(imgs, msks, value_range=rng)
    for b in FO_BLOCKS:
        fn = lambda: cs.fo.firstorder_packed_batch(imgs, msks, block=b, value_range=rng)  # noqa: E731
        cs.check(torch.equal(fn(), base), f"first-order: block {b} changed a bit")
        out["firstorder"][b] = measure(fn, fo_names)
    out["glcm"] = {"shape": list(imgs.shape)}
    base = cs.gl.glcm_matrix_batch(imgs, msks, value_range=rng)
    for b in GLCM_BLOCKS:
        fn = lambda: cs.gl.glcm_matrix_batch(imgs, msks, block=b, value_range=rng)  # noqa: E731
        cs.check(torch.equal(fn(), base), f"GLCM: block {b} changed a bit")
        out["glcm"][b] = measure(fn, ("glcm_tile_kernel", "glcm_sum_kernel"))
    with cs.Recorder(cs.cp, "compact_batch") as rec:
        cs.BatchedExtractor().run([c[1:] for c in cohort])
    verts, keep, cap = max(rec.calls, key=lambda c: c[0].numel())
    out["compact"] = {"shape": list(keep.shape), "cap": cap}
    base = cs.ref.compact_batch(verts, keep, cap)
    for b in COMPACT_TILES:
        fn = lambda: cs.cp.compact_batch(verts, keep, cap, block=b)  # noqa: E731
        cs.check(all(torch.equal(x, y) for x, y in zip(fn(), base)),
                 f"compaction: tile {b} changed a bit")
        out["compact"][b] = measure(fn, ("compact_count_kernel", "compact_scatter_kernel"))
        out["compact"][b]["floor"] = measure(cs.cp.launch_floor(*keep.shape, block=b),
                                             ("compact_empty_kernel",))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
