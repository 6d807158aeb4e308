#!/usr/bin/env python3
"""Times the port's in-core marching-cubes kernel of one checkout on the card.

    python3 scripts/torch_mc_ab.py --root .             # this checkout
    python3 scripts/torch_mc_ab.py --root /path/to/other/checkout

Loads ``chip_smoke.py`` of the checkout at ``--root`` (so two trees, e.g. a
commit and its parent unpacked with ``git archive``, can be compared in one
machine, one process each, in turns) and times with that file's own
``time_ms`` and ``device_trace``, on that tree's ``repro_torch``.  Two
launches: the single-case call on case 00001-1 of ``table2_suite(seed=0)``
cropped to its ROI (228 x 84 x 141), and the batched call on the largest
shape-bucket stack of the 60-case cohort (seeds 0-2), the stacks pass 2a
launches.  Prints one JSON line: per launch the median ms per call (CUDA
events, 20 calls after warm-up) and the device time of its kernels from a
``torch.profiler`` trace (mean of 10 calls), beside the card's
``nvidia-smi`` name and power limit.  Needs a CUDA card.
"""
import argparse
import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

MC_KERNELS = ("mc_partials_kernel", "mc_finalize_kernel")


def load_smoke(root: Path):
    """The checkout's ``chip_smoke`` module (it puts its own ``src`` first
    on ``sys.path`` and imports that tree's ``repro_torch``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout that holds chip_smoke.py and src/")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_mc_ab: no CUDA device")
    root = Path(args.root).resolve()
    cs = load_smoke(root)
    from repro_torch.core import plan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cohort = [c for seed in (0, 1, 2) for c in cs.table2_suite(seed=seed)]
    groups = {}
    for _, _, msk, sp in cohort:
        _, m, _ = cs.crop_to_roi(msk, msk)
        b = plan.shape_bucket(tuple(s - 2 for s in m.shape))
        groups.setdefault(b, []).append((m, sp))
    _, msk1, sp1 = next(c[1:] for c in cohort if c[0] == "00001-1")  # seed 0's
    _, single, _ = cs.crop_to_roi(msk1, msk1)
    bucket, members = max(groups.items(), key=lambda kv: np.prod(kv[0]) * len(kv[1]))
    stack = np.stack([np.pad(m, [(0, b - s) for b, s in zip(bucket, m.shape)])
                      for m, _ in members])
    sps = np.stack([sp for _, sp in members]).astype(np.float32)
    vol1 = torch.from_numpy(single).to(dev)
    vols = torch.from_numpy(stack).to(dev)
    out = {"src": args.label or str(root), "card": smi,
           "single": {"shape": list(single.shape)},
           "batched": {"shape": list(stack.shape)}}
    for key, fn in (("single", lambda: cs.mc.mc_volume_area(vol1, 0.5, sp1)),
                    ("batched", lambda: cs.mc.mc_volume_area_batch(vols, 0.5, sps))):
        fn()
        torch.cuda.synchronize()
        per_kernel, _ = cs.device_trace(fn, reps=10)
        out[key].update(ms=cs.time_ms(fn), device_us=sum(
            us for k, us in per_kernel.items() if any(n in k for n in MC_KERNELS)))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
