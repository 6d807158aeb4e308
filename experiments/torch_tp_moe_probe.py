"""Where a laid-out MoE forward leaves one slot's, in float32 (TF32 off):
deepseek-moe-16b at full width and 2 layers, over (1, 4) slots of the card
against one slot, on chip_smoke.py phase 16d's 2 x 512 tokens.

    python3 experiments/torch_tp_moe_probe.py [--capacity-factor F]

Both runs record each MoE layer's routing (the top-k experts of each token
from the stable sort, and the experts it is dispatched to after capacity;
the laid-out run's first slot, every slot routing alike).  Printed, per
layer: the tokens whose top-k set differs, each with the gap between its
k-th and (k+1)-th router probability in one slot's run; the tokens whose
dispatched set differs; the tokens each run drops.  Then the logits'
max |tp - one| over one slot's largest logit, over every token and over
the tokens that no routing difference reaches (none at or before them in
their row, in any layer), and the relative Frobenius gap.  A third run,
one slot with float64 weights and matmuls (attention and the norms stay
float32 inside), and one slot's run again, show each float32 run's own
error: each MoE layer's normed input and the logits, as max |a - b| over
b's largest entry.  Card only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.launch.mesh import grid_mesh  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.tensor_parallel import lay_out  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

B, S = 2, 512


def recording(log: list):
    """``moe_route`` that appends (top-k sets, the k-th gaps, dispatched
    sets, the normed input) of each call from a first slot (or no group)
    to ``log``."""
    route = M.moe_route

    def wrapped(params, x, cfg):
        r = route(params, x, cfg)
        if sharding._MODEL_SLOT.k in (None, 0):
            n, k = r.tokens[0] * r.tokens[1], cfg.n_experts_per_token
            logits = torch.einsum("gsd,de->gse", r.x, params["router"].to(r.x.dtype)).float()
            probs = torch.softmax(logits, dim=-1).reshape(-1, cfg.n_experts)[:n]
            vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
            top = torch.zeros_like(probs, dtype=torch.bool).scatter_(1, idx[:, :k], True)
            sent = (r.dispatch.sum(-1) > 0).reshape(-1, cfg.n_experts)[:n]
            log.append((top, vals[:, k - 1] - vals[:, k], sent,
                        r.x.reshape(-1, r.x.shape[-1])[:n]))
        return r

    return wrapped


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capacity-factor", type=float, default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(registry.get_config("deepseek-moe-16b"), n_layers=2,
                              dtype="float32")
    if args.capacity_factor:
        cfg = dataclasses.replace(cfg, capacity_factor=args.capacity_factor)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "nvidia-smi: no answer")
    # the weights as phase 16d's: seed-0 bf16, widened
    half = registry.get_model(cfg, device=dev, dtype=torch.bfloat16,
                              generator=torch.Generator(device=dev).manual_seed(0))
    one = registry.get_model(cfg, device=dev)
    one.load_state_dict({k: v.float() for k, v in half.state_dict().items()})
    del half
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    logs = {"one": [], "tp": [], "f64": []}
    wide = registry.get_model(dataclasses.replace(cfg, dtype="float64"), device=dev,
                              dtype=torch.float64)
    wide.load_state_dict({k: v.double() for k, v in one.state_dict().items()})
    M.moe_route = recording(logs["f64"])
    with torch.inference_mode():
        exact = wide.forward(tokens)[0]
    del wide
    M.moe_route = recording(logs["one"])
    with torch.inference_mode():
        want, want_aux = one.forward(tokens)
        again = one.forward(tokens)[0]
    laid = lay_out(one, grid_mesh([dev] * 4, 4))
    M.moe_route = recording(logs["tp"])
    with torch.inference_mode():
        got, aux = laid.forward(tokens)

    def share(a, b):  # max |a - b| over b's largest entry
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    inputs = [{"layer": i, "tp_one": share(t[3], o[3]), "one_f64": share(o[3], w[3]),
               "tp_f64": share(t[3], w[3])}
              for i, (o, t, w) in enumerate(zip(logs["one"], logs["tp"], logs["f64"]))]
    reach = torch.zeros((B, S), dtype=torch.bool, device=dev)
    layers = []
    for i, ((t1, gap, s1, _), (t2, _, s2, _)) in enumerate(zip(logs["one"], logs["tp"])):
        flip = (t1 != t2).any(-1)
        moved = (s1 != s2).any(-1)
        k = cfg.n_experts_per_token
        layers.append({
            "layer": i, "topk_differs": int(flip.sum()),
            "their_kth_gaps": [float(g) for g in gap[flip][:8]],
            "median_kth_gap": float(gap.median()),
            "dispatch_differs": int(moved.sum()),
            "dropped_one": int(k * len(t1) - s1.sum()), "dropped_tp": int(k * len(t2) - s2.sum())})
        hit = (flip | moved).reshape(B, S)
        reach |= torch.cumsum(hit.int(), dim=1) > 0
    diff = (got - want).abs().amax(-1)  # (B, S)
    top = float(want.abs().max())
    clean = ~reach
    print(json.dumps({
        "capacity_factor": cfg.capacity_factor, "layers": layers,
        "share_all": float(diff.max()) / top,
        "share_untouched": float(diff[clean].max()) / top if bool(clean.any()) else None,
        "untouched_tokens": int(clean.sum()),
        "rel_frobenius": float((got - want).norm() / want.norm()),
        "aux_one": float(want_aux), "aux_tp": float(aux),
        "moe_inputs": inputs, "logits_one_f64": share(want, exact),
        "logits_tp_f64": share(got, exact), "logits_one_again": share(again, want),
        "worst_tokens": [[int(b), int(s), float(diff[b, s]) / top] for b, s in
                         zip(*np.unravel_index(np.argsort(-diff.cpu().numpy(), axis=None)[:5],
                                               diff.shape))]}))


if __name__ == "__main__":
    main()
