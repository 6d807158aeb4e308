"""Radiomics service CLI: ``python -m repro_torch.launch.serve``.

Starts the persistent extraction service (``serve/service``) on a device
and drives it with mixed multi-tenant traffic (many small ROIs and rare
huge cases: ``data/synthetic.mixed_traffic_stream``) from concurrent
client threads, then prints the p50/p99 request latency, the cases per
second and the service's window-fusion census.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke            # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

``--deadline-ms`` gives every request a deadline (an expired request
completes with a ``DeadlineExceeded`` error row instead of taking a window
slot); ``--queue-mb`` bounds the admission byte budget.  Exits 1 if any
row carries an error other than an expired deadline, and raises if the
service's driver failed.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.core.pipeline import BatchedExtractor
from repro_torch.data.synthetic import mixed_traffic_stream


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="drive the radiomics extraction service with mixed multi-tenant traffic")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:N' or 'cpu'")
    ap.add_argument("--families", default=None)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8, help="requests per client")
    ap.add_argument("--batch", type=int, default=1, help="cases per request")
    ap.add_argument("--huge-every", type=int, default=16,
                    help="every Nth case is a huge ROI (0: none)")
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--queue-mb", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="a tiny run")
    args = ap.parse_args(argv)
    if args.smoke:
        args.clients, args.requests, args.huge_every = 2, 3, 5

    bx = BatchedExtractor(device=args.device, prep="hint", schedule="static",
                          families=args.families)
    n_cases = args.clients * args.requests * args.batch
    cases = list(mixed_traffic_stream(n_cases, seed=args.seed, huge_every=args.huge_every))

    latencies: list = []
    error_rows: list = []
    lock = threading.Lock()

    def client(cidx: int, svc):
        mine = cases[cidx::args.clients]
        for r in range(args.requests):
            chunk = mine[r * args.batch:(r + 1) * args.batch]
            if not chunk:
                break
            fut = svc.submit([(img, msk, sp) for _, img, msk, sp in chunk],
                             tenant=f"client-{cidx}",
                             deadline_s=(None if args.deadline_ms is None
                                         else args.deadline_ms / 1e3))
            res = fut.result(timeout=600)
            with lock:
                latencies.append(res.latency_s)
                error_rows.extend(res.errors.values())

    with bx.serve(max_queue_bytes=(None if args.queue_mb is None
                                   else args.queue_mb * 2**20)) as svc:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c, svc)) for c in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        stats = svc.stats()

    lat = np.asarray(latencies)
    served = stats["served_cases"]
    fused = stats["window_cases"]
    cross = sum(1 for t in stats["window_tenants"] if t > 1)
    print(f"[serve] device={bx.device} families={bx.families} clients={args.clients} "
          f"requests/client={args.requests} batch={args.batch}")
    print(f"[serve] {served} cases in {dt:.2f}s ({served / dt:.1f} cases/s), "
          f"{stats['windows']} windows (mean fused {np.mean(fused):.1f}, {cross} cross-tenant)")
    print(f"[serve] request latency p50 {np.percentile(lat, 50) * 1e3:.1f} ms, "
          f"p99 {np.percentile(lat, 99) * 1e3:.1f} ms (max {lat.max() * 1e3:.1f} ms)")
    if stats["expired_cases"]:
        print(f"[serve] {stats['expired_cases']} cases expired at deadline "
              f"{args.deadline_ms} ms")
    faults = [e for e in error_rows if not e.startswith("DeadlineExceeded")]
    if faults:
        print(f"[serve] {len(faults)} error rows: {faults[:4]}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
