#!/usr/bin/env python3
"""Which probe fill makes the tuner pick the static targets' fastest sweep.

    python3 experiments/torch_static_probe.py [--fills 4,16,32,64]

A static schedule's pass-2b lists hold the pruning survivors of a bucket
twice their target's size, mostly empty.  This records every static-target
diameter launch of ``BatchedExtractor(schedule='static', prep='hint')``
over the 60-case cohort (``table2_suite`` seeds 0-2, the launches
``chip_smoke.py`` phase 10c times), then, on each launch's own lists, the
device time of every candidate ``(variant, block)`` of the tuner
(``autotune._time_launches``: CUDA events behind a spin, median of rounds)
and the winner the tuner's sweep picks at the launch's key for each probe
policy: ``M`` the 3/4-full probe of an ordinary bucket (``probe_extent``)
and ``1/F`` lists valid over a ``1/F`` share of the target.  Prints, per
launch, the lists' extents, the fastest candidate on the real lists,
``seqacc`` at the default block, and each policy's winner with its time on
the real lists; then each policy's total against ``seqacc`` at the default
block, beside the card's ``nvidia-smi`` name and power limit, and one JSON
line.  Needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import BatchedExtractor  # noqa: E402
from repro_torch.data.synthetic import table2_suite  # noqa: E402
from repro_torch.kernels import diameter as dm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.runtime import autotune  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fills", default="4,16,32,64",
                    help="probe fills to try, each F a 1/F share of the target's slots")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_static_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    # the compaction's lookups sweep into a cache file of this run's own
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tempfile.mkdtemp(), "autotune.json")
    cases = [(img, msk, sp) for seed in (0, 1, 2) for _, img, msk, sp in table2_suite(seed)]
    ext = BatchedExtractor(schedule="static", prep="hint", variant="seqacc")
    ex = ext.executor
    launches, real = [], ex._diam_launch

    def record(key, verts, vmasks):
        if isinstance(key, tuple):
            launches.append((key[1], verts.clone(), vmasks.clone()))
        return real(key, verts, vmasks)

    ex._diam_launch = record
    ext.run(cases)
    torch.cuda.synchronize()
    fills = [int(f) for f in args.fills.split(",")]
    policies = ["M"] + [f"1/{f}" for f in fills]
    base = autotune.DiameterConfig(dm.DEFAULT_VARIANT, dm.DEFAULT_BLOCK)
    totals = dict.fromkeys(policies + ["best", "seqacc/default"], 0.0)
    rows = []
    for target, verts, masks in launches:
        depth = verts.shape[0]
        configs = [autotune.DiameterConfig(v, b) for v in autotune.DEFAULT_VARIANTS
                   for b in autotune._usable(autotune.DEFAULT_BLOCKS, target)]
        if base not in configs:
            configs.append(base)
        on_real = autotune._time_launches({c: dm.batch_launcher(verts, masks, block=c.block,
                                                                 variant=c.variant)
                                            for c in configs})
        best = min(on_real, key=on_real.get)
        picks = {}
        for pol in policies:
            extent = None if pol == "M" else max(2, target // int(pol[2:]))
            win, _ = autotune.sweep_diameter(target, dev, batch=autotune.batch_bucket(depth),
                                             extent=extent)
            picks[pol] = win
            totals[pol] += on_real[win]
        totals["best"] += on_real[best]
        totals["seqacc/default"] += on_real[base]
        ext_list = ref.list_extent(masks).tolist()
        row = {"target": target, "depth": depth, "extents": ext_list,
               "best": f"{best.variant}/{best.block}", "best_us": on_real[best] * 1e6,
               "seqacc_default_us": on_real[base] * 1e6,
               **{pol: [f"{w.variant}/{w.block}", on_real[w] * 1e6] for pol, w in picks.items()}}
        rows.append(row)
        print(f"T{target}/B{depth} extents {ext_list}: best {row['best']} "
              f"{row['best_us']:.2f} us, seqacc/{dm.DEFAULT_BLOCK} "
              f"{row['seqacc_default_us']:.2f} us; "
              + "; ".join(f"{pol} -> {w} {us:.2f} us" for pol, (w, us) in
                          ((p, row[p]) for p in policies)), flush=True)
    print(f"card: {smi}")
    print("totals over the static launches (us): "
          + ", ".join(f"{k} {v * 1e6:.2f} ({v / totals['seqacc/default']:.3f}x seqacc/"
                      f"{dm.DEFAULT_BLOCK})" for k, v in totals.items()))
    print(json.dumps({"card": smi, "launches": rows,
                      "totals_us": {k: v * 1e6 for k, v in totals.items()}}))


if __name__ == "__main__":
    main()
