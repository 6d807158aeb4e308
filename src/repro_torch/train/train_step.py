"""Train step factory: loss (chunked CE + z-loss + MoE aux), grad, update.

Counterpart of the reference's ``train/train_step.py``.  The model holds
its parameters, so ``make_train_step(model, run)`` returns
    (opt_state, batch) -> (opt_state, metrics)
which runs the forward and ``torch.autograd``'s backward, leaves the
gradients the update used in the parameters' ``.grad``, and writes the
AdamW step into the parameters in place.  Batches carry:
    tokens  (B, S) integer                     -- always
    frames  (B, S_enc, d) float                -- audio (encoder stub input)
    prefix  (B, P, d) float                    -- vlm (patch stub input)
Loss is next-token cross entropy over text positions; the padded vocab tail
is masked out of the softmax.  Gradient accumulation: set run.microbatch to
split the batch into sequential microbatches.  Nothing in a step reads a
value back to the host.
"""
from __future__ import annotations

import math

import torch
import torch.profiler
import torch.utils.checkpoint

from repro_torch.parallel.sharding import active_mesh
from repro_torch.train import optimizer as opt


def cross_entropy(logits, labels, vocab_size, zloss=0.0, chunk=512, weights=None):
    """Mean next-token CE, chunked over sequence to bound logit memory.

    logits: (B, S, Vp) (padded vocab); labels: (B, S) (already shifted);
    weights: optional (B, S) loss mask (0 = ignore position).
    """
    b, s, vp = logits.shape
    chunk = min(chunk, s)
    n = s // chunk if s % chunk == 0 else 1
    if s % chunk:
        chunk = s
    if weights is None:
        weights = torch.ones((b, s), dtype=torch.float32, device=logits.device)
    weights = weights.to(torch.float32)
    labels = labels.long()
    # mask padded vocab slots out of the softmax
    valid = torch.arange(vp, device=logits.device) < vocab_size
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        x = torch.where(valid, logits[:, sl].to(torch.float32), -1e30)
        m = torch.amax(x, dim=-1, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(x - m), dim=-1)) + m[..., 0]
        # the gold logit by index: the reference's one-hot contraction sums
        # it times 1 with zeros, the same value, without a (B, chunk, Vp)
        # one-hot that autograd would save
        gold = torch.gather(x, -1, labels[:, sl, None])[..., 0]
        w = weights[:, sl]
        ce = torch.sum((lse - gold) * w)
        zl = torch.sum(torch.square(lse) * w) * zloss
        total = total + ce + zl
    return total / torch.clamp(torch.sum(weights), min=1.0)


def make_loss_fn(model, run):
    """Returns ``loss_fn(batch) -> (loss, {"ce", "aux"})`` over the model's
    own parameters."""
    cfg = model.cfg

    def loss_fn(batch):
        # Forward the FULL token length and mask the final position out of
        # the loss instead of slicing tokens[:, :-1] (the reference's
        # reason: an odd length breaks every power-of-two tiling downstream).
        tokens = batch["tokens"]
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
        wts = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
        wts[:, -1] = 0.0
        if "frames" in batch:
            logits, aux = model.forward(tokens, batch["frames"])
        elif "prefix" in batch:
            logits, aux = model.forward(tokens, prefix_embeds=batch["prefix"])
            logits = logits[:, batch["prefix"].shape[1]:]
        else:
            logits, aux = model.forward(tokens)
        ce = cross_entropy(logits, labels, cfg.vocab_size, zloss=cfg.zloss, weights=wts)
        aux = (aux.to(torch.float32) if torch.is_tensor(aux)  # a float 0.0 without MoE
               else torch.full((), aux, dtype=torch.float32, device=ce.device))
        return ce + aux, {"ce": ce, "aux": aux}

    return loss_fn


def _replicate_over_data(model, params):
    """The reference constrains every parameter to a data-replicated layout
    here, once before the microbatch loop.  Without a mesh, or on a mesh of
    one slot, there is nothing to place: ``params`` as given.  A mesh of
    more slots does not reach here (``train.trainer.Trainer`` raises)."""
    mesh = active_mesh()
    if mesh is None or math.prod(mesh.shape.values()) == 1:
        return params
    raise NotImplementedError("sharded training is not ported (ROADMAP.md, Queue 1 item 5.2(c))")


def make_train_step(model, run):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``:
    ``metrics`` holds 0-d tensors ``loss``, ``lr``, ``grad_norm`` and, on
    the single-batch path, ``ce`` and ``aux``.  The model's parameters must
    be float32, as the reference's are (``cfg.dtype`` sets the compute)."""
    if model.param_dtype != torch.float32:
        raise ValueError(f"training keeps float32 parameters, not {model.param_dtype}")
    loss_fn = make_loss_fn(model, run)
    schedule = opt.make_schedule(run)
    params = dict(model.named_parameters())

    def train_step(opt_state, batch):
        # two profiler spans (each ~1 us without a profiler): the gradient
        # and the update, so a trace splits a step's host and device time
        with torch.profiler.record_function("train_step.grad"):
            loss, metrics = _grad(batch)
        with torch.profiler.record_function("train_step.adamw"):
            grads = {k: p.grad for k, p in params.items()}
            lr = schedule(opt_state.step)
            _, opt_state, gnorm = opt.adamw_update(
                params, grads, opt_state, lr,
                weight_decay=run.weight_decay, grad_clip=run.grad_clip,
            )
        out = {"loss": loss.detach(), "lr": lr, "grad_norm": gnorm}
        out.update({k: v.detach() for k, v in metrics.items()})
        return opt_state, out

    def _grad(batch):
        """The loss, its metrics (single-batch path only) and the
        gradients, left in ``.grad``."""
        model.zero_grad(set_to_none=True)
        metrics = {}
        if run.microbatch and run.microbatch > 1:
            n = run.microbatch
            mbs = [{k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i] for k, x in batch.items()}
                   for i in range(n)]
            if run.gather_weights_once:
                # one graph over the microbatches, each loss checkpointed (its
                # activations recomputed in the backward), one backward
                _replicate_over_data(model, params)
                tot = torch.zeros((), dtype=torch.float32, device=model.device)
                for mb in mbs:
                    tot = tot + torch.utils.checkpoint.checkpoint(
                        lambda mb: loss_fn(mb)[0], mb, use_reentrant=False)
                loss = tot / n
                loss.backward()
            else:
                # the gradients sum in .grad (float32), then are averaged
                ltot = torch.zeros((), dtype=torch.float32, device=model.device)
                for mb in mbs:
                    lm, _ = loss_fn(mb)
                    lm.backward()
                    ltot = ltot + lm.detach()
                for p in params.values():
                    if p.grad is not None:
                        p.grad.div_(n)
                loss = ltot / n
        else:
            loss, metrics = loss_fn(batch)
            loss.backward()
        for p in params.values():
            if p.grad is None:  # an unused leaf: the reference's zero gradient
                p.grad = torch.zeros_like(p)
        return loss, metrics

    return train_step


def make_eval_step(model, run):
    """Returns ``eval_step(batch) -> {"loss", "ce", "aux"}``, no gradient."""
    loss_fn = make_loss_fn(model, run)

    def eval_step(batch):
        with torch.no_grad():
            loss, metrics = loss_fn(batch)
        return {"loss": loss, **metrics}

    return eval_step
