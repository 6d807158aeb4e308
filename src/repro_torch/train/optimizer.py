"""AdamW and the learning-rate schedules, as plain functions on tensors.

Counterpart of the reference's ``train/optimizer.py``.  Parameters,
gradients and the moments are mappings of a model's parameter names
(``dict(model.named_parameters())``) to tensors; :func:`adamw_update`
writes the parameters and the moments in place under ``torch.no_grad()``.
The order of operations is the reference's, in float32: the global-norm
clip ``min(1, clip / max(gnorm, 1e-9))``, the bias-corrected moments, the
decoupled weight decay added to the step.  ``torch.optim.AdamW`` differs
in both (its clip is a separate call with its own epsilon, its decay
multiplies the parameter before the step), and its state is not the
reference's tree, so the port does not use it.

``OptState.step`` is a 0-d int32 tensor on the parameters' device, and the
schedule and the update read it there: a step makes no host sync.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import RunConfig


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict
    v: dict


def init_opt_state(params, dtype=torch.float32) -> OptState:
    """Zero moments for ``params`` (a mapping of names to tensors) in
    ``dtype`` (float32 by default; bfloat16 for memory-tight giants, as the
    reference allows), and step 0, on the parameters' device."""
    params = dict(params)
    device = next(iter(params.values())).device
    m = {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
    v = {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}
    return OptState(torch.zeros((), dtype=torch.int32, device=device), m, v)


def make_schedule(run: RunConfig):
    """Returns ``lr(step)``: ``step`` a 0-d integer tensor, the rate a 0-d
    float32 tensor on its device.  'wsd' = warmup-stable-decay (MiniCPM)."""

    def lr(step):
        step = step.to(torch.float32)
        warm = torch.clamp((step + 1) / max(1, run.warmup_steps), max=1.0)
        if run.schedule == "constant":
            dec = 1.0
        elif run.schedule == "cosine":
            t = torch.clamp((step - run.warmup_steps) / max(1, run.steps - run.warmup_steps),
                            0.0, 1.0)
            dec = 0.5 * (1 + torch.cos(math.pi * t))
        elif run.schedule == "wsd":
            decay_start = int(run.steps * 0.9)
            t = torch.clamp((step - decay_start) / max(1, run.steps - decay_start), 0.0, 1.0)
            dec = 1.0 - t * (1.0 - 0.1)  # linear decay to 10%
        else:
            raise ValueError(run.schedule)
        return run.learning_rate * warm * dec

    return lr


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every tensor of ``tree`` (a mapping or a
    sequence of tensors)."""
    leaves = tree.values() if hasattr(tree, "values") else tree
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in leaves])))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0, gnorm=None):
    """One AdamW step with global-norm clipping.

    ``params``, ``grads`` and the moments of ``state`` are mappings with
    the same names; the parameters and the moments are written in place.
    ``gnorm`` is the gradients' global norm where ``grads`` are one shard
    of them (a data-parallel slot's); by default :func:`global_norm` of
    ``grads``.  Returns ``(params, state, gnorm)``, ``state`` with the new
    step.
    """
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if grad_clip else 1.0)
    step = state.step + 1
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state.m[name], state.v[name]
        m2 = b1 * m.float() + (1 - b1) * g
        v2 = b2 * v.float() + (1 - b2) * g * g
        delta = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m2)
        v.copy_(v2)
    return params, OptState(step, state.m, state.v), gnorm
