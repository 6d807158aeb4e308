"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Builds a mesh where the reference does (more than one visible card under
``--device cuda``: ``make_host_mesh(--model-parallel)``), and drives the
fault-tolerant ``Trainer`` on synthetic data: on such a machine it trains
over every card, ``--model-parallel`` cards a model group (tensor
parallelism over the ``model`` axis, every family; a layout that would
split one of rwkv6's 64-column heads raises) and the rest over ``data``
(``--device cuda:0`` trains on one card).  On
one card, or with ``--device cpu``, ``--model-parallel N`` above 1 lays
the model out over N slots of that device.  With N above 1 the model is
built on ``meta`` and each slot draws only its blocks from the seed, so
no card holds a whole copy of it.

Training over every card is today slower than on one card: the host
holds it back (a thread a slot queues launches at half one slot's rate;
where that time goes is not yet measured).  On 4 NVIDIA H100 80GB HBM3
cards (700 W), qwen3-1.7b at 4 layers and 4 x 257 tokens took
1,325-1,679 ms a step over the 4 cards, 612-776 tokens/s, against
6,845-9,790 tokens/s on one card (``chip_smoke.py`` phase 15c;
``ROADMAP.md``, Queue 1 item 5.4).  Pass ``--device cuda:0`` where speed
matters.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --steps 10 --workdir /path/to/run1
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --steps 4 --device cpu

The default workdir is ``repro_torch_launch_train`` in the temporary
directory; a second run in the same workdir resumes from its checkpoint.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.dispatcher import resolve_device
from repro_torch.launch.mesh import grid_mesh, make_host_mesh
from repro_torch.models.encdec import enc_len_for
from repro_torch.models.registry import get_config, get_model, list_archs
from repro_torch.train.trainer import Trainer


def synthetic_data(cfg, batch: int, seq: int, seed: int = 0, device=None):
    """Synthetic token stream (plus modality-stub inputs where required):
    the reference's numpy stream, as tensors on ``device`` (default
    ``'cuda'``; raises without a card unless ``'cpu'``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        out = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)).to(dev)}
        if cfg.family in ("audio", "encdec"):
            out["frames"] = torch.from_numpy(
                rng.normal(size=(batch, enc_len_for(seq), cfg.d_model)).astype(np.float32)
            ).to(dev) * 0.1
        elif cfg.frontend_tokens:
            out["prefix"] = torch.from_numpy(
                rng.normal(size=(batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
            ).to(dev) * 0.1
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train an LLM-scaffold architecture")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    # over a model axis the Trainer draws each slot's blocks: no whole model on a card
    model = get_model(cfg, device="meta" if args.model_parallel > 1 else dev)
    multi = args.device == "cuda" and torch.cuda.device_count() > 1
    if multi:
        mesh = make_host_mesh(args.model_parallel)
    elif args.model_parallel > 1:
        mesh = grid_mesh([dev] * args.model_parallel, args.model_parallel)
    else:
        mesh = None
    run = RunConfig(steps=args.steps, microbatch=args.microbatch,
                    warmup_steps=max(2, args.steps // 10),
                    checkpoint_every=max(1, args.steps // 4))
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"[launch] arch={cfg.name} params~{cfg.n_params / 1e6:.1f}M "
          f"device={dev} devices={n_dev} mesh={mesh.shape if mesh else None}")
    trainer = Trainer(model, run, synthetic_data(cfg, args.batch, args.seq, device=dev),
                      args.workdir, mesh=mesh)
    _, _, last = trainer.train(steps=args.steps)
    print(f"[launch] done: {last}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
