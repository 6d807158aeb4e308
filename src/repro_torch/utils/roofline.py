"""The analytic half of the reference's ``utils/roofline.py``.

The port's own copy of the three functions of the dry run's roofline that
need no compiled program: :func:`structural_hbm_bytes` (a per-device
model of the HBM bytes one step moves), :func:`model_flops_train` and
:func:`model_flops_decode` (the standard 6 N D and 2 N D estimates).
Every value is computed from a config and a shape, not measured.

The reference's HLO parsers (``collective_bytes``, ``cost_terms``,
``memory_report``, ``loop_corrections``) are not ported: they read the
text and the ``cost_analysis`` of a program that XLA compiled, and the
port compiles no program (PyTorch runs its ops eagerly).  So the port's
dry run reports no collective bytes, temporaries or compiled FLOP count.
"""
from __future__ import annotations


def structural_hbm_bytes(cfg, shape, n_chips: int, tp: int = 16,
                         dp: int = 16, cache_shard: int = 1) -> float:
    """Structural per-device HBM-traffic model of one step.

    Counts what dominates a step's device-memory traffic: weight reads (x3
    for forward, remat recompute and backward in training), optimizer state
    read and written, saved layer-boundary activations, logits, and (decode)
    the KV cache.  ``tp`` is the tensor-parallel width, ``dp`` the batch's
    data-parallel width, ``cache_shard`` the split of a sequence-sharded
    cache.
    """
    N = cfg.n_active_params
    b_loc = max(1, shape.global_batch // dp)
    s = shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers + cfg.n_encoder_layers
    vp = cfg.vocab_padded
    w_read = 2.0 * N / tp  # bf16 weight shard streamed per pass
    if shape.kind == "train":
        passes = 3.0  # fwd + remat-recompute + bwd
        opt = 10.0 * 4.0 * N / n_chips  # p,m,v,g r/w at f32, fully sharded
        acts = 2.0 * L * b_loc * s * d * 2.0  # save + reload layer inputs
        logits = 3.0 * b_loc * s * (vp / tp) * 2.0
        return passes * w_read + opt + acts + logits
    if shape.kind == "prefill":
        acts = 2.0 * L * b_loc * s * d * 2.0
        logits = b_loc * 1 * (vp / tp) * 2.0
        return w_read + acts + logits
    # decode: one token -- weights + cache traffic dominate
    cache = 0.0
    if cfg.family == "ssm":
        nh = d // 64
        cache = 2.0 * L * b_loc * (2 * d + nh * 64 * 64 * 2) * 2.0
    elif cfg.family == "hybrid":
        di = cfg.ssm_expand * d
        nh = di // cfg.head_dim
        for i in range(cfg.n_layers):
            w = cfg.attn_window if i not in cfg.global_attn_layers else 0
            slots = min(s, w) if w else s
            cache += b_loc * slots * cfg.n_kv_heads * cfg.head_dim * 2 * 2.0
            cache += b_loc * nh * cfg.ssm_state * cfg.head_dim * 4 * 2.0
    else:
        kv = max(1, cfg.n_kv_heads // 1)  # kv heads often replicated on TP
        cache = L * b_loc * s * kv * cfg.head_dim * 2 * 2.0
        if cfg.family in ("audio", "encdec"):
            cache += L * b_loc * (s // 4) * kv * cfg.head_dim * 2 * 2.0
    cache /= max(1, cache_shard)  # seq-sharded cache (flash-decode layout)
    logits = b_loc * (vp / tp) * 2.0
    return w_read + cache + logits


def model_flops_train(cfg, tokens: int) -> float:
    """6 * N_active * D (the standard training-FLOPs estimate)."""
    return 6.0 * cfg.n_active_params * tokens


def model_flops_decode(cfg, tokens: int) -> float:
    """2 * N_active * D (a forward over ``tokens`` tokens)."""
    return 2.0 * cfg.n_active_params * tokens
