"""Cohort extraction on the PyTorch port: resilient, resumable, on the card.

The twin of ``examples/cluster_pipeline.py``, with the same flags, over
``repro_torch``: what a cluster job runs to extract a cohort that may
outlive the process.

  * cases flow through as an iterator (``stream_cases``); the runner
    submits window k+1 before it drains window k, so host prep overlaps
    the card's work;
  * each finished case lands in a :class:`RunManifest`, append-only JSONL
    keyed by a content hash of its mask and spacing, so a killed job
    resumes where it stopped, even with cases renamed or reordered, and
    redoes at most one window;
  * a poisoned case (a NaN mask, a dead loader) becomes an ``error``
    record instead of killing the run, and ``--retries`` re-submits a
    window whose collect hits a transient fault, after a backoff (an
    error of the card is not retried: it poisons the CUDA context);
  * ``SIGTERM`` (a preemption notice) is caught by the runner: the
    in-flight window drains and commits, the open buffer is dropped, and
    the same command run again resumes (``SIGKILL`` may tear the last
    line, which the resume repairs);
  * each window's plan census prints as it drains: shape and cap buckets,
    pad waste, the resolved schedule, the collect time, a straggler flag.

It runs on the CUDA card and raises when there is none; ``--cpu`` runs
the plain PyTorch versions of the kernels.

    PYTHONPATH=src python examples/cluster_pipeline_torch.py --cpu --cases 24
    PYTHONPATH=src python examples/cluster_pipeline_torch.py --cases 200 \\
        --window 20 --schedule static --prep hint      # on the card
"""
import argparse
import os
import tempfile

from repro_torch.core.pipeline import BatchedExtractor
from repro_torch.data.synthetic import stream_cases
from repro_torch.runtime.resilience import ResilientRunner, RetryPolicy, RunManifest


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=16)
    ap.add_argument("--window", type=int, default=8,
                    help="cases per stream window (a kill redoes at most one of these)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "repro_pipeline",
                                                  "features_torch.jsonl"))
    ap.add_argument("--variant", default="seqacc")
    ap.add_argument("--schedule", default="auto", choices=("auto", "static", "counted"),
                    help="pass-2b bucket schedule (auto: the cost model's per window; "
                         "static: a sync-free pass 1)")
    ap.add_argument("--prep", default="hint", choices=("hint", "count"),
                    help="pass-0 cap sizing (hint: from metadata, sync-free; count: "
                         "measured per case)")
    ap.add_argument("--retries", type=int, default=2,
                    help="per-window collect retries (0 disables)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    args = ap.parse_args()

    def census(widx, s):
        print(f"window {widx}: {s['cases']} cases, "
              f"{s['shape_buckets']} shape buckets, "
              f"{s['cap_buckets']} vertex buckets, "
              f"pad waste mask {s['mask_pad_waste']:.0%} / "
              f"verts {s['vertex_pad_waste']:.0%}, "
              f"schedule={s['schedule']}, {s['seconds']:.2f}s"
              + (f", QUARANTINED={s['quarantined']}" if s.get("quarantined") else "")
              + (", STRAGGLER" if s.get("straggler") else ""), flush=True)

    ext = BatchedExtractor(
        device="cpu" if args.cpu else "cuda",
        variant=args.variant, schedule=args.schedule, prep=args.prep,
        retry=RetryPolicy(max_retries=args.retries) if args.retries else None,
    )
    manifest = RunManifest(args.out)
    already = len(manifest.resume())
    if already:
        print(f"resuming: {already} cases already in the manifest", flush=True)

    runner = ResilientRunner(ext, manifest, window=args.window, stats_callback=census)
    # the runner skips done cases by content id, so a renamed or reordered
    # input cannot run a case twice
    rep = runner.run(stream_cases(args.cases))
    manifest.close()

    if rep.processed == 0 and rep.status == "complete":
        print(f"nothing to do ({rep.skipped} cases already extracted)")
        return
    log = ext.executor.transfer_log
    print(f"{rep.status}: {rep.processed} rows in {rep.seconds:.1f}s "
          f"({rep.cases_per_second:.2f} cases/s, {rep.windows} windows, "
          f"skipped {rep.skipped} done, quarantined {rep.quarantined}, "
          f"window retries {rep.window_retries}, "
          f"stragglers {len(rep.stragglers)}; "
          f"per-case host syncs: pass0={log.get('prep', 0)} "
          f"pass1={log.get('pass1', 0)})")
    print(f"manifest: {manifest.path}")
    if rep.status == "preempted":
        print("preempted -- run the same command again to resume")


if __name__ == "__main__":
    main()
