"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

Counterpart of the reference's ``models/moe.py``: the dense dispatch of
Mesh-TF/Switch.  Tokens are regrouped into dispatch groups; each group
routes its tokens into per-expert capacity slots through one-hot
dispatch/combine einsums, and a token past its expert's capacity is
dropped.  Covers arctic-480b (128 experts top-2 + a parallel dense
residual FFN) and deepseek-moe-16b (64 fine-grained experts top-6 + 2
shared experts).

Top-k is taken from a stable descending sort, so a tie goes to the lower
expert index as ``jax.lax.top_k`` gives it: the padded tokens of a group
are zero rows with uniform router probabilities, and their first choice
feeds the auxiliary loss.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.params import P


def moe_spec(cfg):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    spec = {
        "router": P((d, e), ("embed", "expert")),
        "wi": P((e, d, f), ("expert", "embed", "mlp")),
        "wo": P((e, f, d), ("expert", "mlp", "embed")),
    }
    if cfg.mlp_act == "swiglu":
        spec["wg"] = P((e, d, f), ("expert", "embed", "mlp"))
    if cfg.n_shared_experts:
        spec["shared"] = layers.mlp_spec(cfg, d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    if cfg.dense_residual_ff:
        spec["dense"] = layers.mlp_spec(cfg, d_ff=cfg.dense_residual_ff)
    return spec


def _capacity(s_tokens: int, k: int, e: int, factor: float) -> int:
    c = int(math.ceil(s_tokens * k * factor / e))
    return max(4, min(c, s_tokens))


class Routed(NamedTuple):
    """The routing of one MoE layer's tokens (:func:`moe_route`)."""

    x: torch.Tensor  # (g, gs, d) the tokens in dispatch groups, the last padded
    dispatch: torch.Tensor  # (g, gs, e, cap) one-hot token -> expert slot
    combine: torch.Tensor  # (g, gs, e, cap) the gate of each token's slots
    aux: torch.Tensor  # () the load-balancing loss (before router_aux_loss)
    tokens: tuple  # (B, S) of the layer's input


def moe_route(params, x, cfg) -> Routed:
    """x: (B, S, d) regrouped into dispatch groups of ``cfg.moe_group_size``
    (the last padded with zero rows, which claim no slot and give no
    output; the dense dispatch/combine einsums cost O(group_size) FLOPs
    per token), and routed: the router, top-k, the auxiliary loss and the
    dispatch and combine tensors."""
    b_in, s_in, d = x.shape
    gs = min(cfg.moe_group_size, b_in * s_in)
    pad = (-(b_in * s_in)) % gs
    flat = x.reshape(-1, d)
    valid_flat = torch.ones((flat.shape[0],), dtype=x.dtype, device=x.device)
    if pad:
        flat = F.pad(flat, (0, 0, 0, pad))
        valid_flat = F.pad(valid_flat, (0, pad))
    x = flat.reshape(-1, gs, d)
    valid = valid_flat.reshape(-1, gs)  # (g, s) 1 for real tokens
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    cap = _capacity(s, k, e, cfg.capacity_factor)

    logits = torch.einsum("gsd,de->gse", x, params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)  # (g,s,e)

    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]  # (g,s,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    # renormalised among the selected (deepseek convention)

    # load-balancing auxiliary loss (Switch): e * sum(frac_tokens * frac_prob)
    assign1 = F.one_hot(gate_idx[..., 0], e).float()
    frac_tokens = assign1.mean(dim=1)  # (g,e)
    frac_probs = probs.mean(dim=1)  # (g,e)
    aux = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))

    # capacity slots: position of each (token, choice) in its expert queue;
    # padded tokens neither claim slots nor contribute output
    onehot = F.one_hot(gate_idx, e) * valid[:, :, None, None].long()  # (g,s,k,e)
    flat_oh = onehot.reshape(b, s * k, e)
    pos = (torch.cumsum(flat_oh, dim=1) - flat_oh).reshape(b, s, k, e)  # slots used before
    keep = (pos < cap) & (onehot > 0)
    # (g,s,k,e,cap); a dropped entry points at slot cap, which no column holds
    slot = torch.where(keep, pos, cap)
    slot_oh = (slot[..., None] == torch.arange(cap, device=x.device)).to(x.dtype)

    onehot_x = onehot.to(x.dtype)
    dispatch = torch.einsum("gske,gskec->gsec", onehot_x, slot_oh)
    combine = torch.einsum("gske,gskec->gsec", gate_vals.to(x.dtype)[..., None] * onehot_x,
                           slot_oh)
    return Routed(x, dispatch, combine, aux, (b_in, s_in))


def moe_experts(params, x, dispatch, combine, cfg):
    """The experts (with the shared experts and the dense residual FFN) on
    routed tokens: x (g, gs, d) -> (g, gs, d).  Over a ``model`` slot's
    blocks of the ``mlp`` dimension, a partial sum."""
    xe = torch.einsum("gsec,gsd->gecd", dispatch, x)  # (g,e,cap,d)
    h = torch.einsum("gecd,edf->gecf", xe, params["wi"].to(x.dtype))
    gate = (torch.einsum("gecd,edf->gecf", xe, params["wg"].to(x.dtype))
            if cfg.mlp_act == "swiglu" else None)
    h = layers.activate(h, cfg.mlp_act, gate)
    ye = torch.einsum("gecf,efd->gecd", h, params["wo"].to(x.dtype))
    out = torch.einsum("gsec,gecd->gsd", combine, ye)

    if cfg.n_shared_experts:
        out = out + layers.mlp(params["shared"], x, cfg.mlp_act)
    if cfg.dense_residual_ff:
        out = out + layers.mlp(params["dense"], x, cfg.mlp_act)
    return out


def moe_ungroup(out, tokens: tuple):
    """The grouped output (g, gs, d) back as (B, S, d), the padding cut."""
    b_in, s_in = tokens
    out = out.reshape(-1, out.shape[-1])
    if out.shape[0] != b_in * s_in:
        out = out[: b_in * s_in]
    return out.reshape(b_in, s_in, -1)


def moe_apply(params, x, cfg):
    """x: (B, S, d) -> (out, aux_loss): :func:`moe_route`, then
    :func:`moe_experts` and :func:`moe_ungroup`."""
    r = moe_route(params, x, cfg)
    out = moe_experts(params, r.x, r.dispatch, r.combine, cfg)
    return moe_ungroup(out, r.tokens), r.aux * cfg.router_aux_loss
