"""Decoder-only transformer assembly: dense, MoE, and hybrid families.

Counterpart of the reference's ``models/transformer.py``.  One
config-driven module covers 8 of the 10 architectures (arctic,
deepseek-moe, nemotron, qwen3, minicpm, granite, hymba, and the internvl2
language backbone).  Layers run in a Python loop over an
``nn.ModuleList`` (the reference's ``lax.scan``; see ``SpecModule``).

Hybrid (Hymba): each layer runs attention and a Mamba2-style SSD branch in
parallel on the same normed input and averages the outputs; a per-layer
window vector selects full vs sliding-window attention.  In decode the
sliding-window layers keep ring-buffer caches of window size while the
global layers keep full caches.

Caches are preallocated tensors that ``decode_step`` writes in place.

A dense, moe or vlm layer is one body over a ``parallel.sharding.
ModelGroup`` (:func:`decoder_layer`, :func:`decode_layer`): the Decoder
runs it over a group of one slot (:data:`ONE`, whose operators are
identities), and ``models/tensor_parallel.DecoderGroup`` over a data row's
``model`` slots, each holding its blocks of the weights.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.params import P, SpecModule, stack_spec
from repro_torch.parallel.sharding import Ax, ModelGroup, constrain


# --------------------------------------------------------------------------
# Hybrid SSD branch (Mamba2-style scalar-per-head decay)
# --------------------------------------------------------------------------

def ssd_spec(cfg):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    nh = di // cfg.head_dim
    n = cfg.ssm_state
    return {
        "wx": P((d, di), ("embed", "mlp")),
        "wz": P((d, di), ("embed", "mlp")),
        "wb": P((d, nh, n), ("embed", "ssm_heads", "ssm_state")),
        "wc": P((d, nh, n), ("embed", "ssm_heads", "ssm_state")),
        "wdt": P((d, nh), ("embed", "ssm_heads")),
        "dt0": P((nh,), ("ssm_heads",), "zeros"),
        "norm": P((di,), ("mlp",), "ones"),
        "wo": P((di, d), ("mlp", "embed")),
    }


def _ssd_project(params, x, cfg):
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.head_dim
    xv = x @ params["wx"].to(x.dtype)
    z = x @ params["wz"].to(x.dtype)
    bts = torch.einsum("bsd,dhn->bshn", x, params["wb"].to(x.dtype))
    cts = torch.einsum("bsd,dhn->bshn", x, params["wc"].to(x.dtype))
    dt = x @ params["wdt"].to(x.dtype)
    logw = -F.softplus(dt.float() + params["dt0"].float())
    v = xv.reshape(*xv.shape[:-1], nh, cfg.head_dim)
    return v, z, bts, cts, logw


def _ssd_out(params, y, z, cfg, x_dtype):
    di = cfg.ssm_expand * cfg.d_model
    y = y.reshape(*y.shape[:-2], di)
    yn = y.float()
    yn = yn * torch.rsqrt(torch.mean(yn * yn, dim=-1, keepdim=True) + 1e-5)
    y = (yn * params["norm"].float()).to(x_dtype)
    y = y * F.silu(z).to(x_dtype)
    return y @ params["wo"].to(x_dtype)


def ssd_apply(params, x, cfg, state0=None, chunk=64):
    """Full-sequence SSD branch.  Returns (out, final_state)."""
    v, z, bts, cts, logw = _ssd_project(params, x, cfg)
    out, state = S.chunked_decay_attention(cts, bts, v, logw[..., None], u=None,
                                           state0=state0, chunk=chunk, inclusive=True)
    return _ssd_out(params, out, z, cfg, x.dtype), state


def ssd_step(params, x, cfg, state):
    """Single-token decode.  x: (B,1,d)."""
    v, z, bts, cts, logw = _ssd_project(params, x, cfg)
    out, state = S.decay_attention_step(
        cts[:, 0], bts[:, 0], v[:, 0],
        torch.broadcast_to(logw[:, 0, :, None], bts[:, 0].shape), None, state)
    return _ssd_out(params, out[:, None], z, cfg, x.dtype), state


# --------------------------------------------------------------------------
# Layer spec / apply
# --------------------------------------------------------------------------

def layer_spec(cfg):
    spec = {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_spec(cfg),
    }
    if cfg.n_experts:
        spec["moe"] = M.moe_spec(cfg)
    else:
        spec["mlp"] = L.mlp_spec(cfg)
    if cfg.family == "hybrid":
        spec["ssd"] = ssd_spec(cfg)
    return spec


def decoder_spec(cfg):
    """The reference's ``Decoder(cfg).spec()``: layers stacked."""
    spec = {
        "embed": L.embed_spec(cfg),
        "layers": stack_spec(layer_spec(cfg), cfg.n_layers),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = L.unembed_spec(cfg)
    return spec


class Split(NamedTuple):
    """Which blocks of work a model group splits over its slots (the query
    heads, the MLP's or experts' ``mlp`` dimension); ``tensor_parallel.
    Layout`` answers for a laid-out model."""

    heads: bool = False
    ffn: bool = False


WHOLE = Split()
ONE = ModelGroup()  # one slot of a model that is not laid out


def _stretch(group, cfg):
    """How the body runs a stretch of one slot's work between two of the
    group's operators: over a mesh's slots each stretch under ``cfg.remat``
    on its own (its backward recomputes it on its own card's autograd
    thread, where a checkpoint of a whole layer spanning cards would be
    recomputed from two threads at once); one slot without a mesh as is,
    its caller checkpointing the whole layer."""
    if group.mesh is None:
        return lambda fn, *args: fn(*args)
    return lambda fn, *args: L.remat(cfg, fn, *args)


def _attend(ap, h, pos, cfg, window, sel):
    return L.self_attention(ap, h, pos, cfg, window=window, kv_select=sel)


def _ffn(group, lps, hs, cfg, split=WHOLE):
    """The MLP or MoE block over ``group``: (the outputs, one a slot; aux).
    Where ``split.ffn`` the normed input is handed out and the slots'
    partials reduced; an MoE layer routes on every slot (the same router
    and groups on each, so the slots dispatch the same tokens)."""
    run = _stretch(group, cfg)
    if not cfg.n_experts:
        mps = [lp["mlp"] for lp in lps]
        if split.ffn:
            hs = group.handout(hs)
        out = group.each(lambda mp, h: run(L.mlp, mp, h, cfg.mlp_act), mps, hs)
        return (group.reduce(out) if split.ffn else out), 0.0
    mps = [lp["moe"] for lp in lps]
    routed = group.each(lambda mp, h: run(M.moe_route, mp, h, cfg), mps, hs)
    aux = group.first([r.aux * cfg.router_aux_loss for r in routed])
    xg, comb = [r.x for r in routed], [r.combine for r in routed]
    if split.ffn:
        xg, comb = group.handout(xg), group.handout(comb)
    out = group.each(lambda mp, x, r, c: run(M.moe_experts, mp, x, r.dispatch, c, cfg),
                     mps, xg, routed, comb)
    if split.ffn:
        out = group.reduce(out)
    return group.each(lambda o, r: M.moe_ungroup(o, r.tokens), out, routed), aux


def decoder_layer(group, lps, xs, positions, cfg, window, split=WHOLE, kv_sel=(None,)):
    """One dense, moe or vlm layer over ``group``: ``lps``, ``xs`` and
    ``positions`` hold one entry a slot, ``kv_sel`` each slot's
    ``layers.select_kv``.  Each block's partials are reduced before the
    residual add.  Returns (the outputs, one a slot; aux)."""
    run = _stretch(group, cfg)
    hs = group.each(lambda lp, x: run(L.rmsnorm, lp["ln1"], x, cfg.norm_eps), lps, xs)
    if split.heads:
        hs = group.handout(hs)
    attn = group.each(lambda lp, h, pos, sel: run(_attend, lp["attn"], h, pos, cfg, window, sel),
                      lps, hs, positions, kv_sel)
    if split.heads:
        attn = group.reduce(attn)
    xs = group.each(lambda x, a: constrain(x + a, "batch", "seq", "embed_act"), xs, attn)
    hs = group.each(lambda lp, x: run(L.rmsnorm, lp["ln2"], x, cfg.norm_eps), lps, xs)
    out, aux = _ffn(group, lps, hs, cfg, split)
    xs = group.each(lambda x, o: constrain(x + o, "batch", "seq", "embed_act"), xs, out)
    return xs, aux


def decode_layer(group, lps, xs, caches, i, cfg, split=WHOLE, kv_sel=(None,)):
    """Layer ``i`` of a dense, moe or vlm decode step over ``group``:
    ``caches`` one ``{"k", "v", "pos"}`` a slot, layer ``i`` written in
    place.  Returns the outputs, one a slot."""
    hs = group.each(lambda lp, x: L.rmsnorm(lp["ln1"], x, cfg.norm_eps), lps, xs)
    if split.heads:
        hs = group.handout(hs)
    attn = group.each(
        lambda lp, h, c, sel: L.decode_attention(
            lp["attn"], h, c["k"][i], c["v"][i], c["pos"], cfg, window=cfg.attn_window,
            kv_select=sel)[0], lps, hs, caches, kv_sel)
    if split.heads:
        attn = group.reduce(attn)
    xs = group.each(lambda x, a: x + a, xs, attn)
    hs = group.each(lambda lp, x: L.rmsnorm(lp["ln2"], x, cfg.norm_eps), lps, xs)
    out, _ = _ffn(group, lps, hs, cfg, split)
    return group.each(lambda x, o: x + o, xs, out)


def layer_apply(params, x, positions, cfg, window, ssm_chunk=64):
    """Training/prefill layer.  window: per-layer scalar (0 = full)."""
    if cfg.family != "hybrid":
        (x,), aux = decoder_layer(ONE, [params], [x], [positions], cfg, window)
        return x, aux
    h = L.rmsnorm(params["ln1"], x, cfg.norm_eps)
    attn = L.self_attention(params["attn"], h, positions, cfg, window=window)
    ssm_out, _ = ssd_apply(params["ssd"], h, cfg, chunk=ssm_chunk)
    attn = (attn + ssm_out) * 0.5
    x = x + attn
    x = constrain(x, "batch", "seq", "embed_act")
    h = L.rmsnorm(params["ln2"], x, cfg.norm_eps)
    (out,), aux = _ffn(ONE, [params], [h], cfg)
    x = x + out
    x = constrain(x, "batch", "seq", "embed_act")
    return x, aux


# --------------------------------------------------------------------------
# Decoder model
# --------------------------------------------------------------------------

class Decoder(SpecModule):
    """Parameters: ``embed``, ``layers`` (one :class:`ParamTree` a layer),
    ``final_norm`` and, unless tied, ``unembed``; see :class:`SpecModule`
    for ``device``, ``dtype`` and ``generator``."""

    build_spec = staticmethod(decoder_spec)

    def windows(self):
        cfg = self.cfg
        if cfg.family == "hybrid" and cfg.attn_window:
            w = [0 if i in cfg.global_attn_layers else cfg.attn_window
                 for i in range(cfg.n_layers)]
        else:
            w = [cfg.attn_window] * cfg.n_layers
        return np.asarray(w, np.int32)

    # ---- forward (train / full-sequence) ----
    def forward(self, tokens, prefix_embeds=None, last_only=False):
        """tokens: (B, S) integer; prefix_embeds: (B, P, d) or None.

        Returns (logits (B, S_total, V), or the last position's (B, 1, V)
        with ``last_only``; aux_loss).
        """
        cfg = self.cfg
        x = L.embed(self.embed, tokens).to(L.compute_dtype(cfg))
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        x = constrain(x, "batch", "seq", "embed_act")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp, w in zip(self.layers, self.windows()):
            x, a = L.remat(cfg, layer_apply, lp, x, positions, cfg, int(w))
            aux = aux + a
        if last_only:
            x = x[:, -1:]
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = constrain(self._unembed(x), "batch", "seq", "vocab")
        return logits, aux

    # ---- decode ----
    def init_cache(self, batch, max_len, dtype=torch.bfloat16):
        """Zeroed caches for ``batch`` rows of up to ``max_len`` tokens, on
        the model's device."""
        cfg = self.cfg
        dev = self.device
        kvh, hd = cfg.n_kv_heads, cfg.head_dim
        pos = torch.zeros((batch,), dtype=torch.int64, device=dev)
        if cfg.family == "hybrid":
            nh = cfg.ssm_expand * cfg.d_model // hd
            caches = []
            for w in self.windows():
                slots = max_len if w == 0 else min(int(w), max_len)
                caches.append({
                    "k": torch.zeros((batch, slots, kvh, hd), dtype=dtype, device=dev),
                    "v": torch.zeros((batch, slots, kvh, hd), dtype=dtype, device=dev),
                    "kpos": torch.full((batch, slots), -1, dtype=torch.int64, device=dev),
                    "state": torch.zeros((batch, nh, cfg.ssm_state, hd), dtype=torch.float32,
                                         device=dev),
                })
            return {"layers": caches, "pos": pos}
        shape = (cfg.n_layers, batch, max_len, kvh, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": pos}

    def cache_axes(self):
        """Logical axes for each cache leaf."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            per_layer = {
                "k": Ax(("cache_batch", "cache_seq", "kv_heads", "head_dim")),
                "v": Ax(("cache_batch", "cache_seq", "kv_heads", "head_dim")),
                "kpos": Ax(("cache_batch", "cache_seq")),
                "state": Ax(("cache_batch", "ssm_heads", "ssm_state", "head_dim")),
            }
            return {"layers": [dict(per_layer) for _ in range(cfg.n_layers)],
                    "pos": Ax(("cache_batch",))}
        kv = Ax(("layers", "cache_batch", "cache_seq", "kv_heads", "head_dim"))
        return {"k": kv, "v": kv, "pos": Ax(("cache_batch",))}

    def decode_step(self, cache, tokens):
        """tokens: (B, 1) -> (logits (B, 1, V), cache), the cache written in
        place and its ``pos`` advanced by one."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens).to(L.compute_dtype(cfg))
        x = constrain(x, "batch", "seq", "embed_act")
        pos = cache["pos"]
        if cfg.family == "hybrid":
            for lp, lc, w in zip(self.layers, cache["layers"], self.windows()):
                x = self._hybrid_step(lp, x, lc, pos, int(w))
        else:
            for i, lp in enumerate(self.layers):
                (x,) = decode_layer(ONE, [lp], [x], [cache], i, cfg)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = self._unembed(x)
        pos.add_(1)
        return logits, cache

    def _unembed(self, x):
        if self.cfg.tie_embeddings:
            return x @ self.embed["embedding"].to(x.dtype).T
        return L.unembed(self.unembed, x)

    def _hybrid_step(self, lp, x, lc, pos, window):
        """One hybrid layer, single token, ring-buffer SWA cache."""
        cfg = self.cfg
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, kv = L.attention_qkv(lp["attn"], h, pos[:, None], cfg)
        slots = lc["k"].shape[1]
        oh = F.one_hot(pos % slots, slots)  # (B, slots)
        ohk = oh.to(lc["k"].dtype)[..., None, None]
        lc["k"].copy_(lc["k"] * (1 - ohk) + ohk * kv.k)
        lc["v"].copy_(lc["v"] * (1 - ohk) + ohk * kv.v)
        kpos = lc["kpos"]
        kpos.copy_(torch.where(oh > 0, pos[:, None], kpos))
        # attend over the ring buffer by the stored absolute positions
        valid = (kpos >= 0) & (kpos <= pos[:, None])
        if window:
            valid = valid & (kpos > pos[:, None] - window)
        o = L.cached_attention(q, lc["k"], lc["v"], valid, cfg)
        attn = L.attention_out(lp["attn"], o, x.dtype)
        ssm_out, nstate = ssd_step(lp["ssd"], h, cfg, lc["state"])
        lc["state"].copy_(nstate)
        x = x + (attn + ssm_out) * 0.5
        h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        (out,), _ = _ffn(ONE, [lp], [h2], cfg)
        return x + out
