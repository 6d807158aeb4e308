"""RWKV6 ("Finch"): attention-free decoder with data-dependent decay.

Counterpart of the reference's ``models/rwkv6.py``.  Per layer:
  * time-mix: token-shift lerps feed r/k/v/g/w projections; the decay
    w_t = exp(-softplus(lora_w(x_t))) is data-dependent per channel; the
    recurrence runs through the chunked diagonal-decay scan
    (``models/ssm.py``) with the current-token bonus u.
  * channel-mix: token-shifted squared-ReLU FFN with a sigmoid receptance
    gate.

Head size is fixed at 64.  Decode state per layer: (time-shift x,
channel-shift x, per-head (64, 64) state matrix) -- O(1) in sequence
length; ``decode_step`` writes it in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import P, SpecModule, stack_spec
from repro_torch.models.transformer import ONE, WHOLE, block, stretch
from repro_torch.parallel.sharding import Ax, constrain

HEAD_SIZE = 64


def _tm_spec(cfg):
    d = cfg.d_model
    nh = d // HEAD_SIZE
    return {
        "mu": P((5, d), (None, "embed"), "zeros"),  # r,k,v,w,g lerp factors
        "wr": P((d, d), ("embed", "heads")),
        "wk": P((d, d), ("embed", "heads")),
        "wv": P((d, d), ("embed", "heads")),
        "wg": P((d, d), ("embed", "heads")),
        "ww": P((d, d), ("embed", "heads")),
        "w0": P((d,), ("heads",), "zeros"),
        "u": P((nh, HEAD_SIZE), ("ssm_heads", None), "zeros"),
        "ln_x": P((d,), ("heads",), "ones"),  # per-head group norm scale
        "wo": P((d, d), ("heads", "embed")),
    }


def _cm_spec(cfg):
    d = cfg.d_model
    return {
        "mu": P((2, d), (None, "embed"), "zeros"),  # k, r lerp factors
        "wk": P((d, cfg.d_ff), ("embed", "mlp")),
        "wv": P((cfg.d_ff, d), ("mlp", "embed")),
        "wr": P((d, d), ("embed", "embed_act")),
    }


def rwkv6_spec(cfg):
    """The reference's ``RWKV6(cfg).spec()``: layers stacked."""
    one = {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "tm": _tm_spec(cfg),
        "cm": _cm_spec(cfg),
    }
    return {
        "embed": L.embed_spec(cfg),
        "layers": stack_spec(one, cfg.n_layers),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
        "unembed": L.unembed_spec(cfg),
    }


def _lerp(x, xprev, mu):
    return x + (xprev - x) * torch.sigmoid(mu).to(x.dtype)


def _shift(x):
    """(B, S, d) -> previous-token tensor (zero for t=0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _prev(h, prev):
    """The previous token's normed input: the shift of ``h``, or a decode
    step's cached one."""
    return _shift(h) if prev is None else prev.to(h.dtype)


def _time_mix_project(p, x, xprev):
    """r, k, v, g and the decay of the heads of ``p`` (a ``model`` slot's
    block: ``wr`` ... ``ww`` by columns, ``w0`` by ``heads``)."""
    nh = p["wr"].shape[-1] // HEAD_SIZE
    mu = p["mu"]
    xr, xk, xv, xw, xg = (_lerp(x, xprev, mu[i]) for i in range(5))
    shp = (*x.shape[:-1], nh, HEAD_SIZE)
    r = (xr @ p["wr"].to(x.dtype)).reshape(shp)
    k = (xk @ p["wk"].to(x.dtype)).reshape(shp)
    v = (xv @ p["wv"].to(x.dtype)).reshape(shp)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    logw = -F.softplus((xw @ p["ww"].to(x.dtype)).float() + p["w0"].float()).reshape(shp)
    return r, k, v, g, logw


def _time_mix_out(p, wkv, g, x_dtype):
    """Per-head group norm, gate, output projection (``wo``'s rows of the
    heads: a slot's partial)."""
    y = wkv.float()
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-5)
    y = y.reshape(*y.shape[:-2], -1) * p["ln_x"].float()
    y = y.to(x_dtype) * g.to(x_dtype)
    return y @ p["wo"].to(x_dtype)


def _time_mix(p, h, chunk):
    """The full-sequence time mix of the heads of ``p``."""
    r, k, v, g, logw = _time_mix_project(p, h, _shift(h))
    wkv, _ = S.chunked_decay_attention(r, k, v, logw, u=p["u"], chunk=chunk, inclusive=False)
    return _time_mix_out(p, wkv, g, h.dtype)


def _time_mix_step(p, h, prev, state):
    """One token's time mix, h (B, d): (out, the heads' new state)."""
    r, k, v, g, logw = _time_mix_project(p, h, prev.to(h.dtype))
    wkv, state = S.decay_attention_step(r, k, v, logw, p["u"], state)
    return _time_mix_out(p, wkv, g, h.dtype), state


def _cm_gate(p, h, prev=None):
    """The channel mix's receptance, ``wr`` whole: from the replicated
    input, outside any block of work."""
    return torch.sigmoid(_lerp(h, _prev(h, prev), p["mu"][1]) @ p["wr"].to(h.dtype))


def _cm_value(p, h, prev=None):
    """The channel mix's squared-ReLU FFN over ``p``'s ``mlp`` block (a
    slot's partial)."""
    k = torch.square(F.relu(_lerp(h, _prev(h, prev), p["mu"][0]) @ p["wk"].to(h.dtype)))
    return k @ p["wv"].to(h.dtype)


def _channel_mix(group, lps, hs, prevs, split, run):
    """The channel mix over ``group``: the gate whole on every slot, the
    FFN a block of work where ``split.ffn``."""
    r = group.each(lambda lp, h, pv: run(_cm_gate, lp["cm"], h, pv), lps, hs, prevs)
    kv = block(group, split.ffn, lambda lp, h, pv: run(_cm_value, lp["cm"], h, pv),
               lps, hs, prevs)
    return group.each(lambda a, b: a.to(b.dtype) * b, r, kv)


def layer(group, lps, xs, cfg, split=WHOLE, chunk=64):
    """One full-sequence layer over ``group`` (``lps``, ``xs`` one entry a
    slot): the time mix, a block of work over ``heads`` where ``split.
    heads`` (each slot's heads whole: its group norm and decay state are
    its own), then the channel mix."""
    run = stretch(group, cfg)
    hs = group.each(lambda lp, x: run(L.rmsnorm, lp["ln1"], x, cfg.norm_eps), lps, xs)
    tm = block(group, split.heads, lambda lp, h: run(_time_mix, lp["tm"], h, chunk), lps, hs)
    xs = group.each(lambda x, t: x + t, xs, tm)
    hs = group.each(lambda lp, x: run(L.rmsnorm, lp["ln2"], x, cfg.norm_eps), lps, xs)
    cm = _channel_mix(group, lps, hs, [None] * group.size, split, run)
    return group.each(lambda x, c: constrain(x + c, "batch", "seq", "embed_act"), xs, cm)


def decode_layer(group, lps, xs, caches, i, cfg, split=WHOLE):
    """Layer ``i`` of a decode step over ``group``, xs (B, d) one a slot:
    ``caches`` one a slot (the shifts whole, ``state`` the slot's heads),
    layer ``i`` written in place; each layer's normed inputs become the
    next step's shifts."""
    hs = group.each(lambda lp, x: L.rmsnorm(lp["ln1"], x, cfg.norm_eps), lps, xs)
    hh = group.handout(hs) if split.heads else hs
    res = group.each(lambda lp, h, c: _time_mix_step(lp["tm"], h, c["tm_shift"][i],
                                                     c["state"][i]), lps, hh, caches)
    tm = [r[0] for r in res]
    xs = group.each(lambda x, t: x + t, xs, group.reduce(tm) if split.heads else tm)
    hs2 = group.each(lambda lp, x: L.rmsnorm(lp["ln2"], x, cfg.norm_eps), lps, xs)
    cm = _channel_mix(group, lps, hs2, [c["cm_shift"][i] for c in caches], split,
                      stretch(group, cfg))
    xs = group.each(lambda x, c: x + c, xs, cm)
    for c, h, h2, r in zip(caches, hs, hs2, res):
        c["tm_shift"][i].copy_(h)
        c["cm_shift"][i].copy_(h2)
        c["state"][i].copy_(r[1])
    return xs


def _layer(lp, x, cfg, ssm_chunk):
    """One full-sequence layer of a model that is not laid out."""
    return layer(ONE, [lp], [x], cfg, chunk=ssm_chunk)[0]


class RWKV6(SpecModule):
    """Parameters: ``embed``, ``layers``, ``final_norm``, ``unembed``; see
    :class:`SpecModule` for ``device``, ``dtype`` and ``generator``."""

    def __init__(self, cfg, device=None, dtype=torch.float32, generator=None, block=None):
        if cfg.d_model % HEAD_SIZE:
            raise ValueError(f"d_model {cfg.d_model} is not a multiple of {HEAD_SIZE}")
        super().__init__(cfg, device, dtype, generator, block)

    build_spec = staticmethod(rwkv6_spec)

    def forward(self, tokens, prefix_embeds=None, ssm_chunk=64, last_only=False):
        """(logits (B, S_total, V), or the last position's with
        ``last_only``; 0.0)."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens).to(L.compute_dtype(cfg))
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        x = constrain(x, "batch", "seq", "embed_act")
        for lp in self.layers:
            x = L.remat(cfg, _layer, lp, x, cfg, ssm_chunk)
        if last_only:
            x = x[:, -1:]
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = L.unembed(self.unembed, x)
        return constrain(logits, "batch", "seq", "vocab"), 0.0

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, device=None):
        """Zeroed decode state for ``batch`` rows (``max_len`` does not size
        it), on ``device`` (default the model's)."""
        cfg = self.cfg
        dev = self.device if device is None else device
        nh = cfg.d_model // HEAD_SIZE
        lshape = (cfg.n_layers, batch)
        return {
            "tm_shift": torch.zeros((*lshape, cfg.d_model), dtype=dtype, device=dev),
            "cm_shift": torch.zeros((*lshape, cfg.d_model), dtype=dtype, device=dev),
            "state": torch.zeros((*lshape, nh, HEAD_SIZE, HEAD_SIZE), dtype=torch.float32,
                                 device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int64, device=dev),
        }

    def cache_axes(self):
        return {
            "tm_shift": Ax(("layers", "cache_batch", "embed_act")),
            "cm_shift": Ax(("layers", "cache_batch", "embed_act")),
            "state": Ax(("layers", "cache_batch", "ssm_heads", None, None)),
            "pos": Ax(("cache_batch",)),
        }

    def decode_step(self, cache, tokens):
        """tokens: (B, 1) -> (logits (B, 1, V), cache), the state written in
        place; each layer's normed inputs become the next step's shifts."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens).to(L.compute_dtype(cfg))[:, 0]  # (B, d)
        for i, lp in enumerate(self.layers):
            (x,) = decode_layer(ONE, [lp], [x], [cache], i, cfg)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = L.unembed(self.unembed, x[:, None])
        cache["pos"].add_(1)
        return logits, cache
