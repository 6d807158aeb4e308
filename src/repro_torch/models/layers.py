"""Shared transformer layers: norms, RoPE, GQA attention, MLP variants.

Counterpart of the reference's ``models/layers.py``, as plain functions on
tensors.  Each takes its parameters as a :class:`~repro_torch.models.params.
ParamTree` (or any mapping of tensors) and casts each weight to the
activations' dtype at use, as the reference does.  Where the reference asks
for ``preferred_element_type=float32`` (attention scores, the PV product),
the operands are cast to float32 first: a bf16 product is exact in float32,
so the sum is the reference's.

Attention is the reference's blockwise online softmax, a Python loop over
key blocks (its ``lax.scan``), so a long prefill never materialises a full
(S, S) score matrix.  Shapes follow (batch, seq, heads, head_dim).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models.params import P

NEG_INF = -1e30
_FAR = -(2**30)  # a window threshold no position reaches


def compute_dtype(cfg) -> torch.dtype:
    """The activations' dtype, ``cfg.dtype`` as a ``torch.dtype``."""
    return getattr(torch, cfg.dtype)


def remat(cfg, fn, *args):
    """``fn(*args)``, one layer's body.  Under ``cfg.remat`` with autograd
    recording, its activations are recomputed in the backward pass instead
    of saved (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
    with ``nothing_saveable``); without a gradient (serving) it runs as is."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm_spec(d):
    return {"scale": P((d,), ("embed",), "ones")}


def rmsnorm(params, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def head_rmsnorm(x, scale, eps=1e-5):
    """Per-head qk-norm (qwen3): normalise over head_dim."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope(x, positions, theta=1e4):
    """x: (B, S, H, D); positions: (B, S) integer."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., None].float() * freqs  # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Blockwise (flash-style) attention
# --------------------------------------------------------------------------

def blockwise_attention(q, k, v, *, causal=True, window=0, block_k=512, q_offset=0):
    """Online-softmax attention, grouped-query layout (no KV replication).

    q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H % K == 0.
    ``q_offset``: absolute position of q[0] relative to k[0] (decode /
    chunked prefill).  ``window`` > 0 = sliding-window attention.
    Returns (B, Sq, H, D).
    """
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    dt = q.dtype
    qf = (q * scale).to(dt).reshape(b, sq, kh, g, d).float()

    block_k = min(block_k, sk)
    nb = -(-sk // block_k)
    pad = nb * block_k - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))

    dev = q.device
    qpos = q_offset + torch.arange(sq, device=dev)  # (Sq,)
    acc = torch.zeros((b, sq, kh, g, d), dtype=torch.float32, device=dev)
    m = torch.full((b, sq, kh, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, kh, g), dtype=torch.float32, device=dev)
    for i in range(nb):
        kb = k[:, i * block_k:(i + 1) * block_k]
        vb = v[:, i * block_k:(i + 1) * block_k]
        s = torch.einsum("bqkgd,bskd->bqkgs", qf, kb.float())
        kpos = i * block_k + torch.arange(block_k, device=dev)  # (Bk,)
        mask = (kpos[None, :] < sk).expand(sq, block_k)  # padding
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgs,bskd->bqkgd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, d).to(dt)


# --------------------------------------------------------------------------
# GQA attention block
# --------------------------------------------------------------------------

def attention_spec(cfg):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "wq": P((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        spec["q_norm"] = P((hd,), ("head_dim",), "ones")
        spec["k_norm"] = P((hd,), ("head_dim",), "ones")
    return spec


class KVUpdate(NamedTuple):
    k: torch.Tensor  # (B, S, K, D) new keys (pre-cache)
    v: torch.Tensor


def attention_qkv(params, x, positions, cfg):
    """Project + rope + qk-norm.  Returns q, KVUpdate."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = head_rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = head_rmsnorm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, KVUpdate(k, v)


def attention_out(params, o, x_dtype):
    return torch.einsum("bshk,hkd->bsd", o, params["wo"].to(x_dtype))


def select_kv(t, kv_select):
    """The kv heads (dimension 2) of ``t`` that a ``model`` slot's query
    heads read: all of them (``None``) or a ``slice``."""
    return t if kv_select is None else t[:, :, kv_select]


def self_attention(params, x, positions, cfg, *, window=0, block_k=512, kv_select=None,
                   causal=True):
    """Full training-mode self-attention (causal unless an encoder's).
    ``kv_select`` picks the kv heads of the query heads in ``params``
    (:func:`select_kv`), where a ``model`` slot holds a block of the query
    heads and every kv head."""
    q, kv = attention_qkv(params, x, positions, cfg)
    o = blockwise_attention(q, select_kv(kv.k, kv_select), select_kv(kv.v, kv_select),
                            causal=causal, window=window, block_k=block_k)
    return attention_out(params, o, x.dtype)


def cached_attention(q, cache_k, cache_v, valid, cfg):
    """One query token against a cache: ``q`` (B, 1, H, D), ``cache_k/v``
    (B, S, K, D), ``valid`` (B, S) the slots it may read; the head counts
    are the tensors' (a ``model`` slot's block).  Scores in float32, the
    probabilities cast to the cache's dtype for the PV product.
    Returns (B, 1, H, D)."""
    b, _, h, hd = q.shape
    kh = cache_k.shape[2]
    qg = (q / math.sqrt(hd)).reshape(b, 1, kh, h // kh, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), cache_k.float())
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(cache_v.dtype)
    o = torch.einsum("bqkgs,bskd->bqkgd", p, cache_v)
    return o.reshape(b, 1, h, hd)


def decode_attention(params, x, cache_k, cache_v, pos, cfg, *, window=0, uniform_pos=True,
                     kv_select=None):
    """Single-token decode against a KV cache, which it updates in place.

    x: (B, 1, d); cache_k/v: (B, S_max, K, D); pos: (B,) current lengths.
    Returns (out, cache_k, cache_v).

    ``uniform_pos=True`` (the batched-serving path: every row is at the
    same step) writes the new KV of every row at ``pos[0]``
    (``index_copy_``, no host sync); otherwise each row's slot is a one-hot
    blend at its own position, as the reference's ragged path.
    ``kv_select`` picks the cache's kv heads that the query heads read
    (:func:`select_kv`).
    """
    q, kv = attention_qkv(params, x, pos[:, None], cfg)
    if uniform_pos:
        at = pos[:1].long()
        cache_k.index_copy_(1, at, kv.k.to(cache_k.dtype))
        cache_v.index_copy_(1, at, kv.v.to(cache_v.dtype))
    else:
        oh = F.one_hot(pos.long(), cache_k.shape[1]).to(cache_k.dtype)[..., None, None]
        cache_k.copy_(cache_k * (1 - oh) + oh * kv.k)
        cache_v.copy_(cache_v * (1 - oh) + oh * kv.v)
    kpos = torch.arange(cache_k.shape[1], device=x.device)[None, :]
    valid = kpos <= pos[:, None]
    wthr = pos[:, None] - window if window > 0 else _FAR
    valid = valid & (kpos > wthr)
    o = cached_attention(q, select_kv(cache_k, kv_select), select_kv(cache_v, kv_select),
                         valid, cfg)
    return attention_out(params, o, x.dtype), cache_k, cache_v


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------

def mlp_spec(cfg, d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {
            "wi": P((d, f), ("embed", "mlp")),
            "wg": P((d, f), ("embed", "mlp")),
            "wo": P((f, d), ("mlp", "embed")),
        }
    return {
        "wi": P((d, f), ("embed", "mlp")),
        "wo": P((f, d), ("mlp", "embed")),
    }


def activate(h, act: str, gate=None):
    """The MLP nonlinearity: ``silu(gate) * h`` for swiglu, ``relu(h)^2``,
    or GELU in its tanh form (``jax.nn.gelu``'s default)."""
    if act == "swiglu":
        return F.silu(gate) * h
    if act == "relu2":
        return torch.square(F.relu(h))
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    raise ValueError(act)


def mlp(params, x, act: str):
    h = x @ params["wi"].to(x.dtype)
    g = x @ params["wg"].to(x.dtype) if act == "swiglu" else None
    return activate(h, act, g) @ params["wo"].to(x.dtype)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def embed_spec(cfg):
    # table padded to vocab_padded for even vocab-axis sharding; ids are
    # always < vocab_size, and loss/serve mask the padded logit slots.
    return {"embedding": P((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"))}


def embed(params, ids):
    return F.embedding(ids.long(), params["embedding"])


def embed_block(params, ids, offset: int):
    """A ``model`` slot's addend of a vocab-parallel embedding: the rows of
    its block of the table (ids ``offset`` onwards), zeros for the ids
    outside it."""
    table = params["embedding"]
    local = ids.long() - offset
    inside = (local >= 0) & (local < table.shape[0])
    rows = F.embedding(local.clamp(0, table.shape[0] - 1), table)
    return rows * inside[..., None].to(rows.dtype)


def unembed_spec(cfg):
    return {"w": P((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"))}


def unembed(params, x):
    return x @ params["w"].to(x.dtype)
