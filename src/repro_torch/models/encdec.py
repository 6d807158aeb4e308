"""Encoder-decoder backbone (seamless-m4t-large-v2).

Counterpart of the reference's ``models/encdec.py``.  The modality frontend
is a stub: precomputed audio *frame embeddings* (B, S_enc, d) feed the
encoder directly.  The text decoder is a causal transformer with per-layer
cross-attention to the encoder output.

Encoder length = max(128, seq_len // 4), decoder length = seq_len.  Decode
caches the decoder self-attention KV plus the per-layer projected cross
K/V (``prefill_encoder``, once), all written in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.params import P, SpecModule, stack_spec
from repro_torch.parallel.sharding import Ax, constrain


def enc_len_for(seq_len: int) -> int:
    return max(128, seq_len // 4)


def _cross_spec(cfg):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    kvh = cfg.n_kv_heads
    return {
        "wq": P((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed")),
    }


def encdec_spec(cfg):
    """The reference's ``EncDec(cfg).spec()``: layers stacked."""
    enc_one = {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }
    dec_one = dict(enc_one)
    dec_one["ln_x"] = L.rmsnorm_spec(cfg.d_model)
    dec_one["cross"] = _cross_spec(cfg)
    return {
        "embed": L.embed_spec(cfg),
        "encoder": stack_spec(enc_one, cfg.n_encoder_layers),
        "decoder": stack_spec(dec_one, cfg.n_layers),
        "enc_norm": L.rmsnorm_spec(cfg.d_model),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
        "unembed": L.unembed_spec(cfg),
    }


def _cross_kv(params, enc_out):
    k = torch.einsum("bsd,dhk->bshk", enc_out, params["wk"].to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out, params["wv"].to(enc_out.dtype))
    return k, v


def _cross_attend(params, x, ck, cv):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    o = L.blockwise_attention(q, ck, cv, causal=False)
    return torch.einsum("bshk,hkd->bsd", o, params["wo"].to(x.dtype))


def _encoder_layer(lp, x, positions, cfg):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, kv = L.attention_qkv(lp["attn"], h, positions, cfg)
    o = L.blockwise_attention(q, kv.k, kv.v, causal=False)
    x = x + L.attention_out(lp["attn"], o, x.dtype)
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    x = x + L.mlp(lp["mlp"], h, cfg.mlp_act)
    return constrain(x, "batch", "seq", "embed_act")


def _decoder_layer(lp, x, enc_out, positions, cfg):
    """One teacher-forced decoder layer: self-attention, cross-attention to
    ``enc_out``, MLP."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + L.self_attention(lp["attn"], h, positions, cfg)
    h = L.rmsnorm(lp["ln_x"], x, cfg.norm_eps)
    ck, cv = _cross_kv(lp["cross"], enc_out)
    x = x + _cross_attend(lp["cross"], h, ck, cv)
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    x = x + L.mlp(lp["mlp"], h, cfg.mlp_act)
    return constrain(x, "batch", "seq", "embed_act")


class EncDec(SpecModule):
    """Parameters: ``embed``, ``encoder``, ``decoder`` (one
    :class:`ParamTree` a layer each), ``enc_norm``, ``final_norm``,
    ``unembed``; see :class:`SpecModule` for ``device``, ``dtype`` and
    ``generator``."""

    def __init__(self, cfg, device=None, dtype=torch.float32, generator=None):
        if cfg.n_encoder_layers <= 0:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs n_encoder_layers > 0")
        super().__init__(cfg, device, dtype, generator)

    build_spec = staticmethod(encdec_spec)

    def encode(self, frames):
        """frames: (B, S_enc, d) stub embeddings -> (B, S_enc, d)."""
        cfg = self.cfg
        x = frames.to(L.compute_dtype(cfg))
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        x = constrain(x, "batch", "seq", "embed_act")
        for lp in self.encoder:
            x = L.remat(cfg, _encoder_layer, lp, x, positions, cfg)
        return L.rmsnorm(self.enc_norm, x, cfg.norm_eps)

    def forward(self, tokens, frames):
        """Teacher-forced forward.  Returns (logits, aux)."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        x = L.embed(self.embed, tokens).to(L.compute_dtype(cfg))
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        x = constrain(x, "batch", "seq", "embed_act")
        for lp in self.decoder:
            x = L.remat(cfg, _decoder_layer, lp, x, enc_out, positions, cfg)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = L.unembed(self.unembed, x)
        return constrain(logits, "batch", "seq", "vocab"), 0.0

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, enc_len=None):
        """Zeroed caches (self-attention for ``max_len`` tokens, cross K/V for
        ``enc_len`` frames), on the model's device."""
        cfg = self.cfg
        dev = self.device
        kvh, hd = cfg.n_kv_heads, cfg.head_dim
        se = enc_len or enc_len_for(max_len)
        lkv = (cfg.n_layers, batch, max_len, kvh, hd)
        lx = (cfg.n_layers, batch, se, kvh, hd)
        return {
            "k": torch.zeros(lkv, dtype=dtype, device=dev),
            "v": torch.zeros(lkv, dtype=dtype, device=dev),
            "cross_k": torch.zeros(lx, dtype=dtype, device=dev),
            "cross_v": torch.zeros(lx, dtype=dtype, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int64, device=dev),
        }

    def cache_axes(self):
        kv = Ax(("layers", "cache_batch", "cache_seq", "kv_heads", "head_dim"))
        return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv, "pos": Ax(("cache_batch",))}

    def prefill_encoder(self, cache, frames):
        """Run the encoder once and write each decoder layer's projected
        cross K/V into the cache."""
        enc_out = self.encode(frames)
        for i, lp in enumerate(self.decoder):
            k, v = _cross_kv(lp["cross"], enc_out)
            cache["cross_k"][i].copy_(k)
            cache["cross_v"][i].copy_(v)
        return cache

    def decode_step(self, cache, tokens):
        """tokens: (B, 1) -> (logits (B, 1, V), cache), written in place."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens).to(L.compute_dtype(cfg))
        pos = cache["pos"]
        for i, lp in enumerate(self.decoder):
            h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            attn, _, _ = L.decode_attention(lp["attn"], h, cache["k"][i], cache["v"][i], pos,
                                            cfg)
            x = x + attn
            h = L.rmsnorm(lp["ln_x"], x, cfg.norm_eps)
            x = x + _cross_attend(lp["cross"], h, cache["cross_k"][i], cache["cross_v"][i])
            h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + L.mlp(lp["mlp"], h, cfg.mlp_act)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = L.unembed(self.unembed, x)
        pos.add_(1)
        return logits, cache
