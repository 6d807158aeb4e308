"""Find the service's knee: the open loop of a cell at a ladder of rates.

    python3 radbench/sweep.py --workload kits19-radiomics.serve \
        --traffic serve-poisson --seed <n> --seconds 10 --rates 10,20,30,40

The cell's configuration under an open-loop mix (``--traffic``, default
``serve-poisson``).  One process, one set-up; for each rate (requests a second) a window of the
cell's traffic at that rate, after the previous window's requests have all
come back.  Prints, per rate, the requests, p50 and p95 from due time to
rows, the median of the last quarter of requests over that of the first
(a backlog that grows through the window reads well over 1), the mean
cases a fused window, and the generator's worst lateness.  The knee is the
highest rate whose p95 stays within the mix's limit and whose backlog does
not grow; the mix's ``rate_per_s`` is set below it, by hand.
"""
from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--traffic", default="serve-poisson")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from radbench import boot

    boot.prepare()
    import torch

    from radbench import cases as caselib
    from radbench import drivers, harness, readers, traffic

    if not torch.cuda.is_available():
        print("radbench: the sweep needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(boot.THREADS)
    spec = harness.Spec.load(args.workload, ROOT)
    cfg, mix = spec.config, traffic.load(args.traffic, ROOT / "radbench")
    pool = caselib.build_pool(args.seed, tuple(map(tuple, cfg["dims"])), int(mix["per_dim"]),
                              tuple(cfg["spacing"]), "cuda")
    drv = drivers.load(mix["entry"])(cfg, mix, pool, torch.device("cuda"), args.seed)
    try:
        drv.setup()
        for rate in (float(r) for r in args.rates.split(",")):
            drv.rate = rate
            n, elapsed = drv.window(args.seconds)
            lat = drv.latencies_s()
            q = max(1, len(lat) // 4)
            drift = statistics.median(lat[-q:]) / statistics.median(lat[:q])
            wc = drv.counters["window_cases"]
            print(f"rate {rate:g}/s: {n} requests in {elapsed:.2f} s, "
                  f"p50 {1e3 * readers.percentile(lat, 0.5):.1f} ms, "
                  f"p95 {1e3 * readers.percentile(lat, 0.95):.1f} ms, "
                  f"last/first quarter median {drift:.2f}, "
                  f"cases a window {sum(wc) / max(1, len(wc)):.2f} over {len(wc)}, "
                  f"generator late by at most {1e3 * max(drv.counters['late_s']):.1f} ms, "
                  f"failed {drv.failed()}", flush=True)
    finally:
        drv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
