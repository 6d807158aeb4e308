#!/usr/bin/env python3
"""What the card's caching allocator holds beside a model laid out from a seed.

    python3 experiments/torch_allocator_slack.py

Why ``chip_smoke.py`` phase 18 gates the bytes requested from the
allocator (``requested_bytes.all.current``) against the slots' blocks,
and ``memory_allocated`` only within the allocator's slack.  Prints one
JSON line:

* ``transients``: ``memory_allocated`` left over, after each is freed,
  by a CUDA generator, a small and a large ``torch.randn`` drawn from it
  (the large one twice) and a copy between two large tensors: what a
  build from a seed might leave behind;
* ``build``: internvl2-26b at full width and depth in bf16 laid out over
  (1, 4) slots of the card from a ``meta`` model and seed 0 (phase 18b's
  build): the slots' block bytes against the growth of
  ``memory_allocated``, of the requested bytes and of the live
  allocations, the largest slack of one allocation (``size`` less
  ``requested_size`` in ``torch.cuda.memory_snapshot()``), how many hold
  more than 512 B of slack, and the live allocations that are not a
  slot's parameter (``extras``).

Then the card's ``nvidia-smi`` name and power limit.  Needs a CUDA card.
"""
import gc
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.mesh import grid_mesh  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.models.tensor_parallel import lay_out  # noqa: E402


def stats():
    s = torch.cuda.memory_stats()
    return (torch.cuda.memory_allocated(), s["requested_bytes.all.current"],
            s["allocation.all.current"])


def left_over(fn) -> int:
    """``memory_allocated`` after ``fn()`` and a collection, less before."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fn()
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - before


def active_blocks() -> list:
    """``(address, size, requested_size)`` of every live allocation."""
    out = []
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]  # a segment's blocks lie end to end from its address
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                out.append((addr, b["size"], b.get("requested_size", b["size"])))
            addr += b["size"]
    return out


def main() -> int:
    dev = torch.device("cuda", 0)
    gen = {}
    transients = {
        "generator": left_over(lambda: gen.setdefault("g", torch.Generator(device=dev)
                                                      .manual_seed(0))),
        "small randn": left_over(lambda: torch.randn(1000, generator=gen["g"], device=dev)),
        "big randn": left_over(lambda: torch.randn(48, 4096, 4096, generator=gen["g"],
                                                   device=dev)),
        "big randn again": left_over(lambda: torch.randn(48, 4096, 4096, generator=gen["g"],
                                                         device=dev)),
        "copy": left_over(lambda: torch.empty(4096, 4096, device=dev).copy_(
            torch.ones(4096, 4096, device=dev))),
    }
    cfg = get_config("internvl2-26b")
    gc.collect()
    torch.cuda.empty_cache()
    before = {a for a, _, _ in active_blocks()}
    held0, req0, n0 = stats()
    laid = lay_out(get_model(cfg, device="meta", dtype=torch.bfloat16), grid_mesh([dev] * 4, 4),
                   seed=0)
    gc.collect()
    torch.cuda.synchronize()
    held, req, n = (x - y for x, y in zip(stats(), (held0, req0, n0)))
    params = {p.data_ptr() for sl in laid.shards() for p in sl.parameters()}
    blocks = sum(p.numel() * p.element_size() for sl in laid.shards() for p in sl.parameters())
    new = [b for b in active_blocks() if b[0] not in before]
    slack = [size - want for _, size, want in new]
    print(json.dumps({
        "transients": transients,
        "build": {"model": f"{cfg.name} full width and depth, bf16, (1, 4) slots, seed 0",
                  "block_bytes": blocks, "n_params": len(params),
                  "memory_allocated_minus_blocks": held - blocks,
                  "requested_minus_blocks": req - blocks, "live_allocations": n,
                  "max_slack_one_allocation": max(slack, default=0),
                  "allocations_over_512_B_slack": sum(s > 512 for s in slack),
                  "extras": [(size, want) for a, size, want in new if a not in params]},
    }), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0] if smi.strip() else "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
