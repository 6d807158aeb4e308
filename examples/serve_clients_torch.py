"""Radiomics as a service on the PyTorch port: two tenants sharing one card.

The twin of ``examples/serve_clients.py`` on ``repro_torch``.  Two
independent clients submit cases at once to one ``ExtractionService``
(``BatchedExtractor.serve``), whose driver thread fuses their cases into
shared windows on the card:

  * the **viewer** tenant submits single cases with a deadline: a case the
    queue cannot reach in time comes back at once as a deadline error row,
    and never occupies a window slot;
  * the **cohort** tenant submits batches with no deadline and rides
    along, filling out the viewer's windows (the cost model closes a
    window early when the oldest pending deadline is at risk);
  * admission is bounded by the estimated bytes queued on the host
    (``--queue-mb``): a cohort that outruns the card blocks in ``submit``;
  * every cohort row equals ``BatchedExtractor.run``'s for the same case,
    bitwise (checked at the end).

    PYTHONPATH=src python examples/serve_clients_torch.py
    PYTHONPATH=src python examples/serve_clients_torch.py --device cpu \\
        --viewer-cases 4 --cohort-cases 8 --deadline-ms 2000

It runs on the card by default and raises without one unless ``--device
cpu``.
"""
import argparse
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data.synthetic import mixed_traffic_stream, stream_cases  # noqa: E402

# clinic-sized cohort shapes: the Table-2 pool's 300-voxel giants take
# minutes a case on the CPU's plain versions
COHORT_DIMS = [(40, 44, 36), (48, 48, 48), (36, 52, 40), (44, 40, 48)]


def main(argv=None):
    """Runs both tenants to the end; returns the service's census with each
    tenant's rows and deadline errors and the wall seconds."""
    ap = argparse.ArgumentParser(
        description="two tenants (a deadline viewer and a batch cohort) sharing one "
                    "extraction service on the card")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:N' or 'cpu'")
    ap.add_argument("--viewer-cases", type=int, default=6)
    ap.add_argument("--cohort-cases", type=int, default=12)
    ap.add_argument("--cohort-batch", type=int, default=4)
    ap.add_argument("--deadline-ms", type=float, default=5000.0)
    ap.add_argument("--queue-mb", type=float, default=64.0)
    args = ap.parse_args(argv)

    bx = BatchedExtractor(device=args.device, prep="hint", schedule="static")
    viewer_cases = [(i, m, s) for _, i, m, s in
                    mixed_traffic_stream(args.viewer_cases, huge_every=0)]
    cohort_cases = [(i, m, s) for _, i, m, s in
                    stream_cases(args.cohort_cases, seed=7, dims_pool=COHORT_DIMS)]

    def viewer(svc, out):
        for i, case in enumerate(viewer_cases):
            t0 = time.perf_counter()
            res = svc.submit_case(case, tenant="viewer",
                                  deadline_s=args.deadline_ms / 1e3).result(timeout=600)
            dt = (time.perf_counter() - t0) * 1e3
            verdict = ("EXPIRED" if res.errors
                       else f"MeshVolume={float(res.rows[0][0]):.1f}")
            print(f"[viewer] case {i}: {dt:7.1f} ms  {verdict}")
            out.append(res)

    def cohort(svc, out):
        for lo in range(0, len(cohort_cases), args.cohort_batch):
            res = svc.submit(cohort_cases[lo:lo + args.cohort_batch],
                             tenant="cohort").result(timeout=600)
            print(f"[cohort] batch {lo // args.cohort_batch}: "
                  f"{len(res.rows)} rows, errors={len(res.errors)}")
            out.append(res)

    v_out, c_out = [], []
    with bx.serve(max_queue_bytes=args.queue_mb * 2**20) as svc:
        threads = [threading.Thread(target=viewer, args=(svc, v_out)),
                   threading.Thread(target=cohort, args=(svc, c_out))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        stats = svc.stats()

    # parity: the cohort's served rows == the batch pipeline's, bitwise
    ref, _ = bx.run(cohort_cases)
    got = [np.asarray(r) for res in c_out for r in res.rows]
    if len(got) != len(cohort_cases):
        raise AssertionError(f"the cohort got {len(got)} rows for {len(cohort_cases)} cases")
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b)

    cross = sum(1 for t in stats["window_tenants"] if t > 1)
    print(f"\n[serve] {stats['served_cases']} cases in {wall:.2f}s "
          f"({stats['served_cases'] / wall:.1f} cases/s), "
          f"{stats['windows']} windows ({cross} cross-tenant), "
          f"{stats['expired_cases']} expired, parity OK")
    return dict(stats, wall_s=wall,
                viewer_rows=sum(len(r.rows) for r in v_out),
                viewer_errors=sum(len(r.errors) for r in v_out),
                cohort_rows=len(got), cohort_errors=sum(len(r.errors) for r in c_out))


if __name__ == "__main__":
    main()
