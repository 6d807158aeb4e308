"""Serve step factory: one decode step + sampling against a KV/state cache.

Counterpart of the reference's ``serve/serve_step.py``.
``make_serve_step(model)`` returns

    (cache, tokens (B, 1)) -> (next_tokens (B, 1), logits, cache)

with greedy or temperature sampling; padded-vocab logit slots are masked.
The cache is written in place.  Sampling draws from an explicit
``torch.Generator`` on the model's device (Gumbel-max, as
``jax.random.categorical``; the draws cannot equal JAX's).  A model laid
out over a mesh (``models/tensor_parallel.LaidOutModel``) gathers the last
position's logits, B x ``vocab_padded``, onto the mesh's first slot, and
samples there: greedy and Gumbel draws are one slot's, and a tie goes to
the first maximum as on one device.  The prefill asks every decoder-only
model for the last position's logits alone (``last_only``).
"""
from __future__ import annotations

import torch


def make_serve_step(model, temperature: float = 0.0, generator: torch.Generator | None = None):
    cfg = model.cfg

    @torch.inference_mode()
    def serve_step(cache, tokens):
        logits, cache = model.decode_step(cache, tokens)
        x = logits[:, -1].float()
        valid = torch.arange(x.shape[-1], device=x.device) < cfg.vocab_size
        x = torch.where(valid[None, :], x, -1e30)
        if temperature > 0:
            u = torch.rand(x.shape, generator=generator, device=x.device)
            nxt = torch.argmax(x / temperature - torch.log(-torch.log(u)), dim=-1)
        else:
            nxt = torch.argmax(x, dim=-1)
        return nxt[:, None], logits, cache

    return serve_step


def make_prefill_fn(model):
    """Full-sequence forward for prefill: returns the last position's logits
    (``extra``: the frames of an encoder-decoder, the prefix embeddings of
    a model with a frontend)."""
    cfg = model.cfg

    @torch.inference_mode()
    def prefill(tokens, *extra):
        if cfg.family in ("audio", "encdec"):
            logits, _ = model.forward(tokens, extra[0])
        elif cfg.frontend_tokens:
            logits, _ = model.forward(tokens, prefix_embeds=extra[0], last_only=True)
        else:
            logits, _ = model.forward(tokens, last_only=True)
        return logits[:, -1:]

    return prefill
