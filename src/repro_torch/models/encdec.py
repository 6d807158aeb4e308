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
from repro_torch.models.transformer import (
    ONE,
    WHOLE,
    _attend,
    _ffn,
    block,
    decoder_layer,
    stretch,
)
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


def _cross_attend(params, x, ck, cv, sel=None):
    """Cross-attention of the query heads of ``params`` to the cross K/V
    (``sel`` picks the kv heads they read: ``layers.select_kv``)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    o = L.blockwise_attention(q, L.select_kv(ck, sel), L.select_kv(cv, sel), causal=False)
    return torch.einsum("bshk,hkd->bsd", o, params["wo"].to(x.dtype))


def _cross(params, x, enc_out, sel):
    return _cross_attend(params, x, *_cross_kv(params, enc_out), sel)


def encoder_layer(group, lps, xs, positions, cfg, split=WHOLE, kv_sel=(None,)):
    """One encoder layer over ``group``: ``transformer.decoder_layer``,
    non-causal and without a window."""
    return decoder_layer(group, lps, xs, positions, cfg, 0, split, kv_sel, causal=False)[0]


def cross_decoder_layer(group, lps, xs, enc_outs, positions, cfg, split=WHOLE, kv_sel=(None,),
                        caches=None, i=None):
    """One decoder layer over ``group`` (``lps``, ``xs`` one entry a slot):
    self-attention, cross-attention, MLP, each a block of work where its
    dimension splits.  Teacher-forced, the cross K/V are projected from
    ``enc_outs`` (the replicated encoder output, handed out to each layer's
    projection); a decode step (``caches`` one a slot, layer ``i`` written
    in place) reads them from the cache."""
    run = stretch(group, cfg)
    hs = group.each(lambda lp, x: run(L.rmsnorm, lp["ln1"], x, cfg.norm_eps), lps, xs)
    if caches is None:
        attn = block(group, split.heads,
                     lambda lp, h, pos, sel: run(_attend, lp["attn"], h, pos, cfg, 0, sel),
                     lps, hs, positions, kv_sel)
    else:
        attn = block(group, split.heads,
                     lambda lp, h, c, sel: L.decode_attention(
                         lp["attn"], h, c["k"][i], c["v"][i], c["pos"], cfg,
                         kv_select=sel)[0], lps, hs, caches, kv_sel)
    xs = group.each(lambda x, a: x + a, xs, attn)
    hs = group.each(lambda lp, x: run(L.rmsnorm, lp["ln_x"], x, cfg.norm_eps), lps, xs)
    if caches is None:
        es = group.handout(enc_outs) if split.heads else enc_outs
        cross = block(group, split.heads,
                      lambda lp, h, e, sel: run(_cross, lp["cross"], h, e, sel),
                      lps, hs, es, kv_sel)
    else:
        cross = block(group, split.heads,
                      lambda lp, h, c, sel: _cross_attend(lp["cross"], h, c["cross_k"][i],
                                                          c["cross_v"][i], sel),
                      lps, hs, caches, kv_sel)
    xs = group.each(lambda x, a: x + a, xs, cross)
    hs = group.each(lambda lp, x: run(L.rmsnorm, lp["ln2"], x, cfg.norm_eps), lps, xs)
    out, _ = _ffn(group, lps, hs, cfg, split)
    return group.each(lambda x, o: constrain(x + o, "batch", "seq", "embed_act"), xs, out)


def _encoder_layer(lp, x, positions, cfg):
    return encoder_layer(ONE, [lp], [x], [positions], cfg)[0]


def _decoder_layer(lp, x, enc_out, positions, cfg):
    """One teacher-forced decoder layer of a model that is not laid out."""
    return cross_decoder_layer(ONE, [lp], [x], [enc_out], [positions], cfg)[0]


class EncDec(SpecModule):
    """Parameters: ``embed``, ``encoder``, ``decoder`` (one
    :class:`ParamTree` a layer each), ``enc_norm``, ``final_norm``,
    ``unembed``; see :class:`SpecModule` for ``device``, ``dtype`` and
    ``generator``."""

    def __init__(self, cfg, device=None, dtype=torch.float32, generator=None, block=None):
        if cfg.n_encoder_layers <= 0:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs n_encoder_layers > 0")
        super().__init__(cfg, device, dtype, generator, block)

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

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, enc_len=None, device=None):
        """Zeroed caches (self-attention for ``max_len`` tokens, cross K/V for
        ``enc_len`` frames), on ``device`` (default the model's)."""
        cfg = self.cfg
        dev = self.device if device is None else device
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
        for i, lp in enumerate(self.decoder):
            (x,) = cross_decoder_layer(ONE, [lp], [x], None, None, cfg, caches=[cache], i=i)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = L.unembed(self.unembed, x)
        cache["pos"].add_(1)
        return logits, cache
