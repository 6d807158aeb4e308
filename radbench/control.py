"""The control of the check: the plain reference in bfloat16 in the
program's place, which the check has to find not correct.

    python3 radbench/control.py --workload <cell> --seeds <a,b,c>

For each seed, the cell's pool at its own size, each case's features by
the reference in bfloat16 (the precision below the configurations'
float32) judged against the float64 reference by the cell's numbers;
prints each number's worst reading beside its limit.  Runs on the card
when there is one, else on the CPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(pool, families, n_bins, device) -> dict:
    """The check's numbers of the bfloat16 reference over ``pool``."""
    import torch

    from radbench import check

    want = check.reference_rows(pool, families, n_bins, device)
    got = check.reference_rows(pool, families, n_bins, device, dtype=torch.bfloat16)
    return check.worst([check.gaps(g, w, n_bins) for g, w in zip(got, want)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from radbench import boot

    boot.prepare()

    import torch

    from radbench import cases as caselib
    from radbench import harness

    spec = harness.Spec.load(args.workload, ROOT)
    cfg, mix = spec.config, spec.mix
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        pool = caselib.build_pool(seed, tuple(map(tuple, cfg["dims"])), int(mix["per_dim"]),
                                  tuple(cfg["spacing"]), device)
        numbers = control_numbers(pool, tuple(cfg["families"]), cfg["n_bins"], device)
        shown = ", ".join(f"{k} {v!r} (limit {cfg['limits'][k]!r})" for k, v in numbers.items())
        fails = [k for k, v in numbers.items() if v > cfg["limits"][k]]
        print(f"control {args.workload} seed {seed}: {shown}; fails {fails}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
