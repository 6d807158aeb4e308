"""How sharp the LLM scaffold's randomly initialised seamless model is.

Runs the JAX package's seamless-m4t-large-v2 at ``reduced(capacity_factor=
8.0)`` (weights from ``PRNGKey(0)``) jitted and unrolled without remat, and
the port's on the same weights, over stub frames of three kinds: unit
normal, 0.1 + 0.01 N(0, 1) (what ``tests/test_torch_models.py`` feeds) and
the reference tests' constant 0.1.  Prints the largest gap between the
reference's two compilations and between the port and the jitted
reference, against the tests' forward tolerance (1e-4 + 1e-4 |x|).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_models_conditioning.py

Runs on the CPU in about 15 s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import registry as jax_registry
from repro.models.encdec import EncDec as JaxEncDec
from repro_torch.models import registry
from repro_torch.models.convert import params_from_reference

NAME = "seamless-m4t-large-v2"
B, S, ENC = 2, 24, 128


def main():
    jcfg = jax_registry.get_config(NAME).reduced(capacity_factor=8.0)
    jmodel = jax_registry.get_model(jcfg)
    unrolled = JaxEncDec(dataclasses.replace(jcfg, remat=False, scan_layers=False))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    cfg = registry.get_config(NAME).reduced(capacity_factor=8.0)
    port = params_from_reference(registry.get_model(cfg, device="cpu"), tree)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    noise = np.random.default_rng(1).standard_normal((B, ENC, cfg.d_model))
    frames = {"N(0, 1)": noise, "0.1 + 0.01 N(0, 1)": 0.1 + 0.01 * noise,
              "0.1": np.full((B, ENC, cfg.d_model), 0.1)}
    fwd = jax.jit(jmodel.forward)
    for label, f in frames.items():
        f = f.astype(np.float32)
        jit = np.asarray(fwd(tree, jnp.asarray(tokens), jnp.asarray(f))[0])
        unr = np.asarray(unrolled.forward(tree, jnp.asarray(tokens), jnp.asarray(f))[0])
        with torch.no_grad():
            ours = port.forward(torch.from_numpy(tokens), torch.from_numpy(f))[0].numpy()
        tol = 1e-4 + 1e-4 * np.abs(jit)
        print(f"frames {label:20s} reference jit vs unrolled {np.abs(jit - unr).max():.3e}, "
              f"port vs jit {np.abs(ours - jit).max():.3e}; over the tolerance: reference "
              f"{bool((np.abs(jit - unr) > tol).any())}, port {bool((np.abs(ours - jit) > tol).any())}")


if __name__ == "__main__":
    main()
