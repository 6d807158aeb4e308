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

A layer is one body over a ``parallel.sharding.ModelGroup``
(:func:`decoder_layer`, :func:`decode_layer`; an encoder-decoder's
encoder layers too): the Decoder runs it over a group of one slot
(:data:`ONE`, whose operators are identities), and ``models/
tensor_parallel.DecoderGroup`` over a data row's ``model`` slots, each
holding its blocks of the weights.  Over several slots the SSD branch's
``d_inner`` columns may split a head (:class:`SSDSel`); its RMS norm over
the whole ``d_inner`` then adds each slot's sum of squares.
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


class SSDSel(NamedTuple):
    """What a ``model`` slot computes of the SSD branch: the heads of its
    ``wb``/``wc``/``wdt`` block that its columns of ``d_inner`` fall in
    (``None``: every head of the block), and ``pad``, the columns of those
    heads before and after its own.  A v-column's recurrence reads only its
    head's b, c and decay (the state is (n, head_dim) a head), so a slot
    whose columns split a head runs the heads they touch with the other
    columns zero, and keeps its own."""

    heads: slice | None = None
    pad: tuple = (0, 0)


WHOLE_SSD = SSDSel()


def _ssd_project(params, x, cfg, sel=WHOLE_SSD):
    hd = cfg.head_dim
    xv = x @ params["wx"].to(x.dtype)
    z = x @ params["wz"].to(x.dtype)
    heads = slice(None) if sel.heads is None else sel.heads
    wb, wc = params["wb"][:, heads], params["wc"][:, heads]
    bts = torch.einsum("bsd,dhn->bshn", x, wb.to(x.dtype))
    cts = torch.einsum("bsd,dhn->bshn", x, wc.to(x.dtype))
    dt = x @ params["wdt"][:, heads].to(x.dtype)
    logw = -F.softplus(dt.float() + params["dt0"][heads].float())
    if sel.pad != (0, 0):
        xv = F.pad(xv, sel.pad)
    v = xv.reshape(*xv.shape[:-1], xv.shape[-1] // hd, hd)
    return v, z, bts, cts, logw


def _ssd_columns(y, sel):
    """The scan's output (..., heads, head_dim) as the slot's columns."""
    y = y.reshape(*y.shape[:-2], -1)
    lo, hi = sel.pad
    return y[..., lo:y.shape[-1] - hi] if lo or hi else y


def ssd_scan(params, x, cfg, sel=WHOLE_SSD, chunk=64):
    """Full-sequence SSD recurrence of a slot's columns: (y (B, S, cols)
    float32, z, final state)."""
    v, z, bts, cts, logw = _ssd_project(params, x, cfg, sel)
    out, state = S.chunked_decay_attention(cts, bts, v, logw[..., None], u=None,
                                           chunk=chunk, inclusive=True)
    return _ssd_columns(out, sel), z, state


def ssd_scan_step(params, x, cfg, state, sel=WHOLE_SSD):
    """Single-token decode of a slot's columns, x (B, 1, d): (y (B, 1,
    cols), z, new state)."""
    v, z, bts, cts, logw = _ssd_project(params, x, cfg, sel)
    out, state = S.decay_attention_step(
        cts[:, 0], bts[:, 0], v[:, 0],
        torch.broadcast_to(logw[:, 0, :, None], bts[:, 0].shape), None, state)
    return _ssd_columns(out[:, None], sel), z, state


def ssd_finish(params, y, ms, z, x_dtype):
    """The RMS norm of ``y`` by its mean square ``ms`` over the whole
    ``d_inner``, the gate, the output projection (a slot's partial)."""
    yn = y.float() * torch.rsqrt(ms + 1e-5)
    y = (yn * params["norm"].float()).to(x_dtype)
    y = y * F.silu(z).to(x_dtype)
    return y @ params["wo"].to(x_dtype)


def _ssd(group, lps, hs, cfg, split, sels, scan, states):
    """The SSD branch over ``group`` (``scan(params, h, sel, state)`` a
    slot's recurrence); where ``split`` its columns are a block of work:
    the input handed out, each slot's sum of squares reduced (and handed
    back out, so each slot's share of the norm's gradient reaches every
    slot), the partials reduced.  Returns (outputs, states), one a slot."""
    run = stretch(group, cfg)
    if split:
        hs = group.handout(hs)
    scanned = group.each(lambda lp, h, sel, st: run(scan, lp["ssd"], h, sel, st),
                         lps, hs, sels, states)
    ys = [s[0] for s in scanned]
    if split:
        di = cfg.ssm_expand * cfg.d_model
        ss = group.handout(group.reduce(
            group.each(lambda y: torch.sum(y * y, dim=-1, keepdim=True), ys)))
        ms = group.each(lambda s: s / di, ss)
    else:
        ms = group.each(lambda y: torch.mean(y * y, dim=-1, keepdim=True), ys)
    out = group.each(lambda lp, y, m, s, h: run(ssd_finish, lp["ssd"], y, m, s[1], h.dtype),
                     lps, ys, ms, scanned, hs)
    return (group.reduce(out) if split else out), [s[2] for s in scanned]


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
    heads, the MLP's or experts' ``mlp`` dimension, the hybrid SSD
    branch's ``mlp`` columns); ``tensor_parallel.Layout`` answers for a
    laid-out model."""

    heads: bool = False
    ffn: bool = False
    ssd: bool = False


WHOLE = Split()
ONE = ModelGroup()  # one slot of a model that is not laid out


def stretch(group, cfg):
    """How the body runs a stretch of one slot's work between two of the
    group's operators: over a mesh's slots each stretch under ``cfg.remat``
    on its own (its backward recomputes it on its own card's autograd
    thread, where a checkpoint of a whole layer spanning cards would be
    recomputed from two threads at once); one slot without a mesh as is,
    its caller checkpointing the whole layer."""
    if group.mesh is None:
        return lambda fn, *args: fn(*args)
    return lambda fn, *args: L.remat(cfg, fn, *args)


def block(group, split, fn, lps, hs, *rest):
    """``fn(lp, h, *rest)`` on each slot of ``group``: where ``split`` a
    block of work (the replicated input ``hs`` handed out, the slots'
    partials reduced), else whole on every slot.  ``rest`` holds further
    lists, one entry a slot."""
    if split:
        hs = group.handout(hs)
    out = group.each(fn, lps, hs, *rest)
    return group.reduce(out) if split else out


def _attend(ap, h, pos, cfg, window, sel, causal=True):
    return L.self_attention(ap, h, pos, cfg, window=window, kv_select=sel, causal=causal)


def _ffn(group, lps, hs, cfg, split=WHOLE):
    """The MLP or MoE block over ``group``: (the outputs, one a slot; aux).
    Where ``split.ffn`` the normed input is handed out and the slots'
    partials reduced; an MoE layer routes on every slot (the same router
    and groups on each, so the slots dispatch the same tokens)."""
    run = stretch(group, cfg)
    if not cfg.n_experts:
        return block(group, split.ffn, lambda lp, h: run(L.mlp, lp["mlp"], h, cfg.mlp_act),
                     lps, hs), 0.0
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


def _residual(group, xs, adds):
    return group.each(lambda x, a: constrain(x + a, "batch", "seq", "embed_act"), xs, adds)


def _hybrid(group, attn, ssd):
    """The hybrid layer's two branches averaged."""
    return group.each(lambda a, s: (a + s) * 0.5, attn, ssd)


def decoder_layer(group, lps, xs, positions, cfg, window, split=WHOLE, kv_sel=(None,),
                  ssd_sel=(WHOLE_SSD,), causal=True):
    """One layer over ``group``: ``lps``, ``xs`` and ``positions`` hold one
    entry a slot, ``kv_sel`` each slot's ``layers.select_kv`` and
    ``ssd_sel`` its :class:`SSDSel`.  Attention (non-causal for an
    encoder's layer), in a hybrid layer averaged with the SSD branch on
    the same normed input, then the MLP or MoE; each block's partials are
    reduced before the residual add.  Returns (the outputs, one a slot;
    aux)."""
    run = stretch(group, cfg)
    hs = group.each(lambda lp, x: run(L.rmsnorm, lp["ln1"], x, cfg.norm_eps), lps, xs)
    attn = block(group, split.heads,
                 lambda lp, h, pos, sel: run(_attend, lp["attn"], h, pos, cfg, window, sel,
                                             causal), lps, hs, positions, kv_sel)
    if cfg.family == "hybrid":
        ssd, _ = _ssd(group, lps, hs, cfg, split.ssd, ssd_sel,
                      lambda p, h, sel, st: ssd_scan(p, h, cfg, sel), [None] * group.size)
        attn = _hybrid(group, attn, ssd)
    xs = _residual(group, xs, attn)
    hs = group.each(lambda lp, x: run(L.rmsnorm, lp["ln2"], x, cfg.norm_eps), lps, xs)
    out, aux = _ffn(group, lps, hs, cfg, split)
    return _residual(group, xs, out), aux


def _ring_attention(ap, h, lc, pos, cfg, window, sel):
    """A hybrid layer's single-token attention against its ring-buffer
    cache ``lc`` (written in place), attending by the stored absolute
    positions."""
    q, kv = L.attention_qkv(ap, h, pos[:, None], cfg)
    slots = lc["k"].shape[1]
    oh = F.one_hot(pos % slots, slots)  # (B, slots)
    ohk = oh.to(lc["k"].dtype)[..., None, None]
    lc["k"].copy_(lc["k"] * (1 - ohk) + ohk * kv.k)
    lc["v"].copy_(lc["v"] * (1 - ohk) + ohk * kv.v)
    kpos = lc["kpos"]
    kpos.copy_(torch.where(oh > 0, pos[:, None], kpos))
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    if window:
        valid = valid & (kpos > pos[:, None] - window)
    o = L.cached_attention(q, L.select_kv(lc["k"], sel), L.select_kv(lc["v"], sel), valid, cfg)
    return L.attention_out(ap, o, h.dtype)


def decode_layer(group, lps, xs, caches, i, cfg, window, split=WHOLE, kv_sel=(None,),
                 ssd_sel=(WHOLE_SSD,)):
    """Layer ``i`` of a decode step over ``group``: ``caches`` one cache a
    slot (``{"k", "v", "pos"}``; a hybrid's ``{"layers", "pos"}``, each
    layer's ring buffer and SSD state), layer ``i`` written in place.
    Returns the outputs, one a slot."""
    hs = group.each(lambda lp, x: L.rmsnorm(lp["ln1"], x, cfg.norm_eps), lps, xs)
    if cfg.family == "hybrid":
        layer = [c["layers"][i] for c in caches]
        attn = block(group, split.heads,
                     lambda lp, h, lc, c, sel: _ring_attention(lp["attn"], h, lc, c["pos"], cfg,
                                                               window, sel),
                     lps, hs, layer, caches, kv_sel)
        ssd, states = _ssd(group, lps, hs, cfg, split.ssd, ssd_sel,
                           lambda p, h, sel, st: ssd_scan_step(p, h, cfg, st, sel),
                           [lc["state"] for lc in layer])
        for lc, st in zip(layer, states):
            lc["state"].copy_(st)
        attn = _hybrid(group, attn, ssd)
    else:
        attn = block(group, split.heads,
                     lambda lp, h, c, sel: L.decode_attention(
                         lp["attn"], h, c["k"][i], c["v"][i], c["pos"], cfg, window=window,
                         kv_select=sel)[0], lps, hs, caches, kv_sel)
    xs = group.each(lambda x, a: x + a, xs, attn)
    hs = group.each(lambda lp, x: L.rmsnorm(lp["ln2"], x, cfg.norm_eps), lps, xs)
    out, _ = _ffn(group, lps, hs, cfg, split)
    return group.each(lambda x, o: x + o, xs, out)


def layer_apply(params, x, positions, cfg, window):
    """Training/prefill layer.  window: per-layer scalar (0 = full)."""
    (x,), aux = decoder_layer(ONE, [params], [x], [positions], cfg, window)
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
    def init_cache(self, batch, max_len, dtype=torch.bfloat16, device=None):
        """Zeroed caches for ``batch`` rows of up to ``max_len`` tokens, on
        ``device`` (default the model's)."""
        cfg = self.cfg
        dev = self.device if device is None else device
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
        for i, (lp, w) in enumerate(zip(self.layers, self.windows())):
            (x,) = decode_layer(ONE, [lp], [x], [cache], i, cfg, int(w))
        x = L.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = self._unembed(x)
        cache["pos"].add_(1)
        return logits, cache

    def _unembed(self, x):
        if self.cfg.tie_embeddings:
            return x @ self.embed["embedding"].to(x.dtype).T
        return L.unembed(self.unembed, x)
