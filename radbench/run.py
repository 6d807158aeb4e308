"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 radbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits nonzero, printing no result, without a CUDA device (or with fewer
than the cell asks for), and when JAX or the JAX package was loaded in
this process.  Build and tuning caches stay inside the checkout: the
kernels' nvcc builds in ``build/repro_torch/`` (the program's own), the
autotune cache in ``radbench/.cache/autotune.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from radbench import boot

    boot.prepare()
    import torch

    from radbench import harness

    spec = harness.Spec.load(args.workload, ROOT)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"radbench: cell {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    torch.set_num_threads(boot.THREADS)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                              log=log)
    found = harness.jax_loaded()
    if found:
        log(f"radbench: JAX or the JAX package was loaded in this process: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
