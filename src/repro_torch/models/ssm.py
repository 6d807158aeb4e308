"""Chunked linear attention with data-dependent diagonal decay.

Counterpart of the reference's ``models/ssm.py`` (which wraps the scan in
``jax.jit``; here it is a plain function, the chunks a Python loop).  One
primitive covers both recurrent families:
  * RWKV6 ("Finch") time-mix: per-key-channel data-dependent decay w_t plus
    a current-token bonus u  --  S_t = diag(w_t) S_{t-1} + k_t v_t^T,
    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T).
  * Mamba2-style SSD heads (Hymba's parallel-SSM branch): scalar-per-head
    decay == the same recurrence with w_t broadcast across key channels.

A chunk of C steps becomes three products.  All exponents are differences
of cumulative log-decays along *forward* spans, hence <= 0:

    la_t   = sum_{tau<=t} log w_tau           (cumulative, inclusive)
    inter  : out_t += (r_t * exp(la_{t-1})) @ S_0
    intra  : out_t += sum_{tau<t} [sum_i r_ti k_taui exp(la_{t-1,i}-la_tau,i)] v_tau
    bonus  : out_t += (sum_i r_ti u_i k_ti) v_t
    carry  : S_C = diag(exp(la_C)) S_0 + sum_tau (k_tau exp(la_C-la_tau))^T v_tau
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def decay_attention_step(r, k, v, logw, u, state):
    """One decode step.

    r/k/logw: (B, H, Dk); v: (B, H, Dv); u: (H, Dk) or None;
    state: (B, H, Dk, Dv).  Returns (out (B, H, Dv), new_state).
    """
    r, k, v = r.float(), k.float(), v.float()
    new_state = torch.exp(logw)[..., None] * state + k[..., None] * v[..., None, :]
    if u is not None:
        out = torch.einsum("bhi,bhiv->bhv", r, state)
        out = out + torch.einsum("bhi,bhv->bhv", r * u.float() * k, v)
    else:
        # SSD convention: output reads the *updated* state (inclusive)
        out = torch.einsum("bhi,bhiv->bhv", r, new_state)
    return out, new_state


def chunked_decay_attention(r, k, v, logw, u=None, state0=None, chunk=64, inclusive=False):
    """Full-sequence chunked scan.

    r/k: (B, T, H, Dk); v: (B, T, H, Dv); logw: (B, T, H, Dk) (<= 0,
    broadcastable over Dk for scalar-per-head decay); u: (H, Dk) or None.
    ``inclusive``: out_t reads the state including step t (SSD convention,
    used when u is None).  Returns (out (B, T, H, Dv), state (B,H,Dk,Dv)).
    """
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    logw = torch.broadcast_to(logw, (b, t, h, dk)).float()
    if state0 is None:
        state0 = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    c = min(chunk, t)
    t_orig = t
    if t % c:
        # Pad to a chunk multiple with neutral steps: logw=0 (exp(0)=1 keeps
        # the state unchanged), k=0 (no contribution), r=0 (no output read).
        # The scan's final state therefore equals the state at t_orig; padded
        # outputs are sliced off below.
        pad = c - t % c
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
        t = t + pad
    n = t // c

    rc = r.reshape(b, n, c, h, dk).float()
    kc = k.reshape(b, n, c, h, dk).float()
    vc = v.reshape(b, n, c, h, dv).float()
    lw = logw.reshape(b, n, c, h, dk)

    tri = torch.tril(torch.ones((c, c), dtype=torch.float32, device=r.device),
                     0 if inclusive else -1)
    state = state0
    outs = []
    for j in range(n):
        rr, kk, vv, ww = rc[:, j], kc[:, j], vc[:, j], lw[:, j]  # (b,c,h,dk/(dv))
        la = torch.cumsum(ww, dim=1)  # (b,c,h,dk) inclusive
        a = la if inclusive else la - ww  # exponent used by queries
        q_eff = rr * torch.exp(a)
        k_dec = kk * torch.exp(-la + la[:, -1:])  # k * exp(la_C - la_tau)
        # inter-chunk
        out = torch.einsum("bchi,bhiv->bchv", q_eff, state)
        # intra-chunk: the exact pairwise exponent a_t - la_tau, <= 0 on the
        # valid region; any factored form (q*e^a)(k*e^-la) has one unbounded
        # side under strong decay, so the masked-out upper triangle is
        # clamped instead and the (C, C, Dk) workspace paid
        expo = a[:, :, None] - la[:, None]  # (b,c,c,h,dk)
        dmat = torch.exp(torch.clamp(expo, max=0.0))
        scores = torch.einsum("bcdhi,bcdhi->bhcd", rr[:, :, None] * kk[:, None], dmat)
        scores = scores * tri[None, None]
        out = out + torch.einsum("bhcd,bdhv->bchv", scores, vv)
        if u is not None:
            bonus = torch.einsum("bchi,bchi->bch", rr * u.float(), kk)
            out = out + bonus[..., None] * vv
        state = torch.exp(la[:, -1])[..., None] * state + torch.einsum(
            "bchi,bchv->bhiv", k_dec, vv)
        outs.append(out)
    out = torch.stack(outs, dim=1).reshape(b, t, h, dv)
    if t != t_orig:
        out = out[:, :t_orig]
    return out, state
