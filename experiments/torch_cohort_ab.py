#!/usr/bin/env python3
"""Times the port's cohort paths of one checkout on the card.

    python3 experiments/torch_cohort_ab.py --root .     # this checkout
    python3 experiments/torch_cohort_ab.py --root /path/to/other/checkout

It imports the ``repro_torch`` of the checkout it is given, never its own.

Loads ``chip_smoke.py`` of the checkout at ``--root`` (so two trees, e.g. a
commit and its parent unpacked with ``git archive``, can be compared on one
machine, one process each, in turns) and runs that tree's ``repro_torch``
over the 60-case cohort (``table2_suite`` seeds 0-2): the single-case loop
(``ShapeFeatureExtractor``), ``BatchedExtractor().run`` and the
three-family run.  The autotune cache is a fresh temporary file, warmed by
one untimed pass of each path (a tree without an autotuner ignores it);
its seconds are ``warm_s``, those of its sweeps ``sweep_s``.  Then
``--rounds`` rounds, each path once per round, host clock around a
call that ends in a synchronise.  Prints one JSON line: per path the
cases/s of each round, and the microseconds of one warm ``diameter``
configuration lookup (``dispatcher.diameter_config`` on a cached key,
where the tree has it), with the card's ``nvidia-smi``
name and power limit, the ``seqacc`` diameter kernel's ms per call
and device time at 00001-1's unpruned list (chip_smoke.py phase 3's
launch, at the tree's default block), and the ``diameter_ms`` stage time
of five single-case ``execute`` calls of 00001-1 with ``prune=False`` on
``'auto'`` (``unpruned_diameter_ms``).  Needs a CUDA card.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch


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
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernel-only", action="store_true",
                    help="time only the seqacc kernel, not the cohort paths")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_cohort_ab: no CUDA device")
    fd, cache_file = tempfile.mkstemp(prefix="repro_autotune_", suffix=".json")
    os.close(fd)
    os.unlink(cache_file)
    os.environ["REPRO_AUTOTUNE_CACHE"] = cache_file
    os.environ.pop("REPRO_AUTOTUNE", None)
    cs = load_smoke(Path(args.root).resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cases = [c[1:] for seed in (0, 1, 2) for c in cs.table2_suite(seed=seed)]
    single = cs.ShapeFeatureExtractor()
    paths = {
        "single": lambda: [single.execute(*c) for c in cases],
        "batched": cs.BatchedExtractor().run,
        "families": cs.BatchedExtractor(families=cs.FAMS).run,
    }
    if args.kernel_only:
        paths = {}
    t0 = time.perf_counter()
    for name, fn in paths.items():  # warm: builds, pinned buffers, autotune sweeps
        fn() if name == "single" else fn(cases)
    torch.cuda.synchronize()
    out = {"src": args.label or str(args.root), "card": smi, "cases": len(cases),
           "warm_s": time.perf_counter() - t0}
    autotune = sys.modules.get("repro_torch.runtime.autotune")
    out["sweep_s"] = dict(getattr(autotune, "SWEEP_SECONDS", {})) or None
    for _ in range(args.rounds if paths else 0):
        for name, fn in paths.items():
            t0 = time.perf_counter()
            fn() if name == "single" else fn(cases)
            torch.cuda.synchronize()
            out.setdefault(name, []).append(len(cases) / (time.perf_counter() - t0))
    try:
        from repro_torch.core import dispatcher
        n = 1000
        dispatcher.diameter_config(torch.device("cuda"), 1024, "auto", batch=5)  # a hit below
        t0 = time.perf_counter()
        for _ in range(n):
            dispatcher.diameter_config(torch.device("cuda"), 1024, "auto", batch=5)
        out["lookup_us"] = (time.perf_counter() - t0) / n * 1e6
    except AttributeError:  # a tree without the autotuner resolves nothing
        out["lookup_us"] = None
    # the seqacc diameter kernel at 00001-1's unpruned list, as phase 3 times it
    img, msk, sp = next(c[1:] for c in cs.table2_suite(seed=0) if c[0] == "00001-1")
    _, big, _ = cs.crop_to_roi(img, msk)
    f = cs.ref.vertex_fields(torch.from_numpy(big).cuda(), 0.5, sp)
    verts, vmask, _ = cs.ref.compact_vertices(f, cs.ops.vertex_bucket(int(cs.ref.count_vertices(f))))
    fn = lambda: cs.dm.max_diameters_sq(verts, vmask)  # noqa: E731
    per_kernel, _ = cs.device_trace(fn, reps=10)
    out["seqacc_00001_1"] = {"ms": cs.time_ms(fn), "device_us": sum(
        us for k, us in per_kernel.items() if "diameter_" in k)}
    unpruned = cs.ShapeFeatureExtractor(prune=False)
    unpruned.execute(img, msk, sp)  # warm: its bucket's lookup (a sweep on a cold cache)
    out["unpruned_diameter_ms"] = [unpruned.execute(img, msk, sp, with_times=True)[1].diameter_ms
                                   for _ in range(5)]
    if os.path.exists(cache_file):
        os.unlink(cache_file)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
