"""End-to-end training on the PyTorch port: a ~100M-parameter LM.

The twin of ``examples/train_lm.py`` on ``repro_torch``: config system ->
model zoo -> AdamW (+WSD) -> train step (``torch.autograd``) ->
fault-tolerant Trainer (async atomic checkpoints, auto-resume, straggler
log, SIGTERM emergency save), on one device.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300            # the card
    PYTHONPATH=src python examples/train_lm_torch.py --arch granite-3-2b --smoke --device cpu

Kill it mid-run and start it again: it resumes from the latest committed
checkpoint.  ``--smoke`` shrinks the model for a fast sanity pass; without
a card, pass ``--device cpu``.
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core.dispatcher import resolve_device  # noqa: E402
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

# qwen3-family config scaled to ~100M params (d=512, L=8, untied embeddings)
M100 = dict(
    n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
    d_ff=1536, vocab_size=32_000, dtype="float32",
)


def synthetic_batches(vocab_size: int, batch: int, seq: int, device, seed: int = 0):
    """Deterministic synthetic LM stream with learnable n-gram structure
    (the reference example's numpy stream), as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab_size, size=(64, seq + 1))
    while True:
        rows = rng.integers(0, base.shape[0], size=batch)
        noise = rng.integers(0, vocab_size, size=(batch, seq + 1))
        keep = rng.random((batch, seq + 1)) < 0.9
        tokens = np.where(keep, base[rows], noise)
        yield {"tokens": torch.from_numpy(tokens[:, : seq + 1].astype(np.int32)).to(device)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + 5 steps (CI-speed sanity check)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    base = get_config(args.arch)
    if args.smoke:
        cfg = base.reduced()
        steps = 5
    else:
        cfg = base.reduced(**M100)
        steps = args.steps
    model = get_model(cfg, device=dev)
    print(f"arch={cfg.name} family={cfg.family} params~{cfg.n_params/1e6:.1f}M "
          f"steps={steps} device={dev}")

    run = RunConfig(
        steps=steps, learning_rate=3e-4, warmup_steps=max(2, steps // 20),
        schedule="wsd", checkpoint_every=max(1, steps // 4),
        async_checkpoint=True,
    )
    data = synthetic_batches(cfg.vocab_size, args.batch, args.seq, dev)
    trainer = Trainer(model, run, data, args.workdir)
    _, _, last = trainer.train(steps=steps)
    print(f"final: step={last['step']} loss={last['loss']:.4f} "
          f"median_step_s={trainer.straggler.median:.3f}")


if __name__ == "__main__":
    main()
