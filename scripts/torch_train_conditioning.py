"""How far float32 gradients of the LLM scaffold's random models lie from float64.

For each architecture at ``reduced(capacity_factor=8.0)``, on the weights
of the port's ``init`` (seed 0) and ``tests/test_torch_train.py``'s batch
(2 rows of 17 tokens, stub inputs 0.1 + 0.01 N(0, 1)), the train loss's
gradients (``make_loss_fn``) from the JAX package in float32 and from the
port in float32 and in float64.  Prints, for each architecture, each
float32 run's largest gap to the float64 run over the leaf's largest
|gradient| (the worst leaf), and the port's gap to the JAX package's, the
quantity ``tests/test_torch_train.py`` holds at ``GRAD_SHARE`` (2e-4).
``--frames normal`` feeds seamless the launcher's 0.1 N(0, 1) frames
instead.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_train_conditioning.py [--frames normal]

Runs on the CPU in about 40 s.
"""
import argparse
import dataclasses

import jax
import numpy as np
import torch

from repro.configs.base import RunConfig as JaxRunConfig
from repro.models import registry as jax_registry
from repro.train import train_step as jax_ts
from repro_torch.configs.base import RunConfig
from repro_torch.models import registry
from repro_torch.models.convert import grads_to_reference, params_from_reference, params_to_reference
from repro_torch.models.encdec import enc_len_for
from repro_torch.train.train_step import make_loss_fn

B, S = 2, 16


def batch_for(cfg, frames):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)}
    n = enc_len_for(S + 1) if cfg.n_encoder_layers else cfg.frontend_tokens
    if n:
        shape = (B, n, cfg.d_model)
        stub = (0.1 * rng.standard_normal(shape) if frames == "normal" and cfg.n_encoder_layers
                else 0.1 + 0.01 * rng.standard_normal(shape))
        out["frames" if cfg.n_encoder_layers else "prefix"] = stub.astype(np.float32)
    return out


def worst(a_leaves, b_leaves):
    """The largest |a - b| over the leaf's largest |b|, over the leaves."""
    return max(float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())
               for a, b in zip(a_leaves, b_leaves))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", choices=["stub", "normal"], default="stub")
    args = ap.parse_args()
    torch.set_num_threads(1)
    print(f"{'arch':24s} {'jax32-f64':>10s} {'port32-f64':>11s} {'port-jax':>9s}")
    for name in registry.list_archs():
        jcfg = jax_registry.get_config(name).reduced(capacity_factor=8.0)
        cfg = registry.get_config(name).reduced(capacity_factor=8.0)
        tree = params_to_reference(registry.get_model(cfg, device="cpu"))
        batch = batch_for(cfg, args.frames)
        fn = jax.value_and_grad(jax_ts.make_loss_fn(jax_registry.get_model(jcfg), JaxRunConfig()),
                                has_aux=True)
        _, jgrads = jax.jit(fn)(tree, batch)
        jleaves = [np.asarray(x) for x in jax.tree.leaves(jgrads)]
        port = {}
        for dt in (torch.float32, torch.float64):
            c = dataclasses.replace(cfg, dtype=str(dt).split(".")[1])
            model = params_from_reference(registry.get_model(c, device="cpu", dtype=dt), tree)
            tb = {k: torch.from_numpy(v.astype(np.float64) if dt == torch.float64
                                      and v.dtype == np.float32 else v)
                  for k, v in batch.items()}
            loss, _ = make_loss_fn(model, RunConfig())(tb)
            loss.backward()
            port[dt] = jax.tree.leaves(grads_to_reference(model))
        f64 = port[torch.float64]
        print(f"{name:24s} {worst(jleaves, f64):10.2e} {worst(port[torch.float32], f64):11.2e} "
              f"{worst(port[torch.float32], [x.astype(np.float64) for x in jleaves]):9.2e}")


if __name__ == "__main__":
    main()
