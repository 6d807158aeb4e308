"""One slot's serving wall of qwen3-1.7b (full width and depth, bf16) on
the card, for each of several source trees: an A/B of the decoder's host
path between two checkouts of the port.

    python3 experiments/torch_decoder_body_ab.py --tree DIR_A --tree DIR_B ...

Each ``--tree`` (a checkout holding ``src/repro_torch``) runs in a
subprocess of its own, in the order given (give parent, change, change,
parent).  A run draws the seed-0 weights, then times, after one warm-up
each: the prefill fn over 4 prompts of 256 tokens (median of 5) and
greedy serve steps from a cache filled with those prompts (median of 5
rounds of 32 steps, ms a step).  It prints one JSON line a tree, and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

B, PROMPT, ROUNDS, STEPS = 4, 256, 5, 32


def run_one(tree: str) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch

    from repro_torch.models import registry
    from repro_torch.serve.serve_step import make_prefill_fn, make_serve_step

    dev = torch.device("cuda")
    cfg = registry.get_config("qwen3-1.7b")
    model = registry.get_model(cfg, device=dev, dtype=torch.bfloat16,
                               generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT))).to(dev)
    prefill = make_prefill_fn(model)
    walls = []
    for i in range(ROUNDS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(tokens)
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
    cache = model.init_cache(B, PROMPT + (ROUNDS + 1) * STEPS + 1, dtype=torch.bfloat16)
    with torch.inference_mode():
        for t in range(PROMPT):
            model.decode_step(cache, tokens[:, t:t + 1])
    step = make_serve_step(model)
    nxt, steps = tokens[:, -1:], []
    for i in range(ROUNDS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            nxt, _, cache = step(cache, nxt)
        torch.cuda.synchronize()
        if i:
            steps.append((time.perf_counter() - t0) * 1e3 / STEPS)
    return {"tree": tree, "prefill_ms": statistics.median(walls), "prefill_runs": walls,
            "step_ms": statistics.median(steps), "step_runs": steps}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.one)))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "nvidia-smi: no answer")
    for tree in args.tree:
        r = subprocess.run([sys.executable, __file__, "--tree", tree, "--one", tree],
                           capture_output=True, text=True, timeout=600,
                           env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        if r.returncode:
            sys.exit(f"{tree}: exit {r.returncode}\n{r.stderr[-2000:]}")
        print(r.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
