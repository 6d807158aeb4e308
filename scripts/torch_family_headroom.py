"""Largest gaps between the port's intensity-family rows and the JAX
package's, on the full-size Table-2 cohort, on the CPU.

Runs ``BatchedExtractor(families=("firstorder", "glcm"))`` of both
packages over ``table2_suite`` seeds 0, 1 and 2 (60 cases): the port
(``repro_torch``) on ``device='cpu'``, which runs the plain versions of its
kernels (the kernels equal them bitwise on the card), and the JAX package
(``repro``) on ``backend='ref'``.  For each feature column it prints the
largest relative gap over the cases, the tolerance the parity tests hold
that column to, and the headroom (tolerance / gap).  For StdDev it also
prints the largest cancellation factor ``mean^2 / var``: std is
``sqrt(s2/n - mean^2)``, so a relative error in the sums reaches the
variance multiplied by about that factor.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_family_headroom.py \
        [--seeds 0 1 2] [--json out.json]

Each seed runs as one window of 20 cases; the largest shape bucket is
(2, 160, 96, 160), and a seed needs a few GiB of host memory.  The shape
family is left out: it does not feed these columns, and the port's shape
rows are held against the JAX package by the tests.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro.core.pipeline import BatchedExtractor as JaxExtractor  # noqa: E402
from repro.data.synthetic import table2_suite  # noqa: E402
from repro_torch.core.pipeline import BatchedExtractor as TorchExtractor  # noqa: E402
from repro_torch.kernels import firstorder as fo  # noqa: E402
from repro_torch.kernels import glcm as gl  # noqa: E402

FAMILIES = ("firstorder", "glcm")
# the tolerance the parity tests (tests/test_torch_families.py) hold each column to
TOLERANCE = {"Mean": 1e-4, "StdDev": 1e-4, "Minimum": 0.0, "Maximum": 0.0,
             "Percentile10": 0.0, "Median": 0.0, "Percentile90": 0.0, "Energy": 1e-4,
             "Entropy": 1e-4, **{name: 0.0 for name in gl.FEATURES}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--json", help="also write the per-column gaps to this file")
    args = ap.parse_args(argv)

    port = TorchExtractor(device="cpu", families=FAMILIES)
    jax_ref = JaxExtractor(backend="ref", families=FAMILIES)
    ours, theirs = [], []
    for seed in args.seeds:
        cases = [(img, msk, sp) for _, img, msk, sp in table2_suite(seed=seed)]
        t0 = time.perf_counter()
        rows, stats = port.run(cases)
        t1 = time.perf_counter()
        jrows, jstats = jax_ref.run(cases)
        t2 = time.perf_counter()
        if stats["host_fetches"] != jstats["host_fetches"]:
            raise AssertionError(f"seed {seed}: host fetches {stats['host_fetches']} != "
                                 f"the JAX package's {jstats['host_fetches']}")
        ours.append(np.stack(rows))
        theirs.append(np.stack(jrows))
        print(f"seed {seed}: port {t1 - t0:.1f} s, JAX ref {t2 - t1:.1f} s, host_fetches "
              f"{stats['host_fetches']}", flush=True)
    a, b = np.concatenate(ours), np.concatenate(theirs)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise AssertionError("non-finite rows")
    names = list(fo.FEATURES) + list(gl.FEATURES)
    rel = np.abs(a - b) / np.maximum(np.abs(b), np.finfo(np.float32).tiny)
    mean, std = b[:, 0].astype(np.float64), b[:, 1].astype(np.float64)
    cancel = float(np.max(mean * mean / np.maximum(std * std, 1e-300)))
    out = {"cases": len(a), "seeds": args.seeds, "columns": {}}
    print(f"{len(a)} cases; column: largest relative gap (case), tolerance, headroom")
    for j, name in enumerate(names):
        gap, case = float(rel[:, j].max()), int(rel[:, j].argmax())
        tol = TOLERANCE[name]
        headroom = tol / gap if gap > 0 else float("inf")
        out["columns"][name] = {"max_rel_gap": gap, "case": case, "tolerance": tol,
                                "headroom": headroom, "bitwise": bool(np.array_equal(
                                    a[:, j], b[:, j]))}
        print(f"  {name}: {gap:.3e} (case {case}), tolerance {tol:g}, headroom "
              f"{'exact' if gap == 0 else f'{headroom:.1f}x'}")
        if gap > tol:
            raise AssertionError(f"{name}: gap {gap} above its tolerance {tol}")
    out["std_cancellation_max"] = cancel
    print(f"  StdDev: largest mean^2 / var {cancel:.3e}")
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
