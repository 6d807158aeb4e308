#!/usr/bin/env python3
"""The Trainer's checkpoint host copy without a mesh, on the card, for one tree or two.

    python3 experiments/torch_checkpoint_host_copy.py [--parent DIR] [--rounds N]

Runs ``chip_smoke.py`` phase 14d's Trainer (qwen3-1.7b at full width, 2
layers, float32 parameters and moments, no mesh, 2 x 65 tokens a step)
for ``--rounds`` steps with a checkpoint after each, the write to disk
skipped.  A checkpoint's host copy is the time from the Trainer's
``_checkpoint_tree`` call to the ``CheckpointManager._write`` call: the
tree assembled in the reference's layout and copied to the host, by
whichever of the two the tree does it in.  With ``--parent`` (another
commit unpacked with ``git archive``) the two trees run in turns, each in
a process of its own: parent, this tree, this tree, parent.  Prints one
JSON line a run, then the card's ``nvidia-smi`` name and power limit.
Needs a CUDA card.
"""
import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(root: Path, rounds: int) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=2, dtype="float32")
    rng = np.random.default_rng(0)
    batches = iter([{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32)).to(dev)} for _ in range(rounds)])
    run = RunConfig(steps=rounds, checkpoint_every=1, warmup_steps=2, learning_rate=3e-4,
                    async_checkpoint=False)
    model = get_model(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    copies, marks = [], []
    with tempfile.TemporaryDirectory(prefix="repro_ckpt_copy_") as work:
        trainer = Trainer(model, run, batches, work)
        checkpoint_tree = trainer._checkpoint_tree

        def timed_tree(state):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return checkpoint_tree(state)

        def timed_write(step, host_tree, extras):  # the write itself skipped
            copies.append(time.perf_counter() - marks[-1])

        trainer._checkpoint_tree = timed_tree
        trainer.ckpt._write = timed_write
        trainer.train(steps=rounds)
    return {"tree": str(root), "rounds": rounds, "checkpoint_bytes": 12 * n_params + 4,
            "host_copy_s": copies, "median_s": statistics.median(copies)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another checkout, run in turns with this one")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(measure(args.child.resolve(), args.rounds)), flush=True)
        return 0
    order = [ROOT] if args.parent is None else [args.parent, ROOT, ROOT, args.parent]
    rc = 0
    for root in order:
        rc |= subprocess.run([sys.executable, __file__, "--child", str(root),
                              "--rounds", str(args.rounds)]).returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0] if smi.strip() else "nvidia-smi: no output")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
