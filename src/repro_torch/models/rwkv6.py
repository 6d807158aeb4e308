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


def _time_mix_project(p, x, xprev, cfg):
    nh = cfg.d_model // HEAD_SIZE
    mu = p["mu"]
    xr, xk, xv, xw, xg = (_lerp(x, xprev, mu[i]) for i in range(5))
    shp = (*x.shape[:-1], nh, HEAD_SIZE)
    r = (xr @ p["wr"].to(x.dtype)).reshape(shp)
    k = (xk @ p["wk"].to(x.dtype)).reshape(shp)
    v = (xv @ p["wv"].to(x.dtype)).reshape(shp)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    logw = -F.softplus((xw @ p["ww"].to(x.dtype)).float() + p["w0"].float()).reshape(shp)
    return r, k, v, g, logw


def _time_mix_out(p, wkv, g, cfg, x_dtype):
    """Per-head group norm, gate, output projection."""
    y = wkv.float()
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-5)
    y = y.reshape(*y.shape[:-2], cfg.d_model) * p["ln_x"].float()
    y = y.to(x_dtype) * g.to(x_dtype)
    return y @ p["wo"].to(x_dtype)


def _channel_mix(p, x, xprev, cfg):
    xk = _lerp(x, xprev, p["mu"][0])
    xr = _lerp(x, xprev, p["mu"][1])
    k = torch.square(F.relu(xk @ p["wk"].to(x.dtype)))
    kv = k @ p["wv"].to(x.dtype)
    r = torch.sigmoid(xr @ p["wr"].to(x.dtype))
    return r.to(x.dtype) * kv


def _shift(x):
    """(B, S, d) -> previous-token tensor (zero for t=0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _layer(lp, x, cfg, ssm_chunk):
    """One full-sequence layer: time-mix, then channel-mix."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    r, k, v, g, logw = _time_mix_project(lp["tm"], h, _shift(h), cfg)
    wkv, _ = S.chunked_decay_attention(r, k, v, logw, u=lp["tm"]["u"], chunk=ssm_chunk,
                                       inclusive=False)
    x = x + _time_mix_out(lp["tm"], wkv, g, cfg, x.dtype)
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    x = x + _channel_mix(lp["cm"], h, _shift(h), cfg)
    return constrain(x, "batch", "seq", "embed_act")


class RWKV6(SpecModule):
    """Parameters: ``embed``, ``layers``, ``final_norm``, ``unembed``; see
    :class:`SpecModule` for ``device``, ``dtype`` and ``generator``."""

    def __init__(self, cfg, device=None, dtype=torch.float32, generator=None):
        if cfg.d_model % HEAD_SIZE:
            raise ValueError(f"d_model {cfg.d_model} is not a multiple of {HEAD_SIZE}")
        super().__init__(cfg, device, dtype, generator)

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

    def init_cache(self, batch, max_len, dtype=torch.bfloat16):
        """Zeroed decode state for ``batch`` rows (``max_len`` does not size
        it), on the model's device."""
        cfg = self.cfg
        dev = self.device
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
            tm_s, cm_s, st = cache["tm_shift"][i], cache["cm_shift"][i], cache["state"][i]
            h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            r, k, v, g, logw = _time_mix_project(lp["tm"], h, tm_s.to(h.dtype), cfg)
            wkv, st2 = S.decay_attention_step(r, k, v, logw, lp["tm"]["u"], st)
            x = x + _time_mix_out(lp["tm"], wkv, g, cfg, x.dtype)
            h2 = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + _channel_mix(lp["cm"], h2, cm_s.to(h2.dtype), cfg)
            tm_s.copy_(h)
            cm_s.copy_(h2)
            st.copy_(st2)
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = L.unembed(self.unembed, x[:, None])
        cache["pos"].add_(1)
        return logits, cache
