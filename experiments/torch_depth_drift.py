"""How far a random deep stack of the reference's init carries one rounding.

    PYTHONPATH=src python3 experiments/torch_depth_drift.py [--arch granite-3-2b]
        [--width 512] [--layers 2,10,20,40]

The architecture's config at ``--width`` (64-wide heads, its GQA ratio,
d_ff four times the width, its own vocabulary), drawn from seed 0 at each
depth, on the CPU: the forward and teacher-forced ``decode_step`` of 2
prompts of 16 tokens, once in float32 and once with float64 weights and
activations.  Printed per depth: max |decode - forward| in each dtype, max
|forward|, and max |float32 forward - float64 forward| (the float32
forward's own error).  Where the last grows with depth as the first does,
a full-depth decode can only be held to its forward layer by layer
(``chip_smoke.py`` phase 19a).  About 20 s at the defaults.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.models.registry import get_config, get_model  # noqa: E402


def run(cfg, tokens, dtype):
    """(forward logits, teacher-forced decode logits) of ``cfg`` in ``dtype``."""
    cfg = dataclasses.replace(cfg, dtype=str(dtype).split(".")[-1])
    model = get_model(cfg, device="cpu", dtype=dtype, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        fwd = model.forward(tokens)[0]
        cache = model.init_cache(tokens.shape[0], tokens.shape[1], dtype=dtype)
        dec = torch.stack([model.decode_step(cache, tokens[:, t:t + 1])[0][:, 0]
                           for t in range(tokens.shape[1])], dim=1)
    return fwd.double(), dec.double()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--layers", default="2,10,20,40")
    args = ap.parse_args()
    base = get_config(args.arch)
    heads = args.width // 64
    kv = max(1, heads // (base.n_heads // base.n_kv_heads))
    tokens = torch.from_numpy(np.random.default_rng(19).integers(0, base.vocab_size, (2, 16)))
    for n in (int(x) for x in args.layers.split(",")):
        cfg = dataclasses.replace(base, d_model=args.width, n_heads=heads, n_kv_heads=kv,
                                  head_dim=64, d_ff=4 * args.width, n_layers=n)
        f32, d32 = run(cfg, tokens, torch.float32)
        f64, d64 = run(cfg, tokens, torch.float64)
        print(f"{args.arch} width {args.width}, {n} layers: max|dec - fwd| float32 "
              f"{(d32 - f32).abs().max().item():.3e}, float64 {(d64 - f64).abs().max().item():.3e}; "
              f"max|fwd| {f32.abs().max().item():.3f}; max|fwd32 - fwd64| "
              f"{(f32 - f64).abs().max().item():.3e}", flush=True)


if __name__ == "__main__":
    main()
