"""Fault-tolerant training loop.

Counterpart of the reference's ``train/trainer.py``.  Wires together the
train step (``train_step.make_train_step``), async atomic checkpointing
with auto-resume (``runtime/checkpoint``), preemption (a SIGTERM writes a
checkpoint and stops), straggler logging and JSONL metrics.  The model
holds its parameters, on its own device.

The checkpoint tree is the reference's ``(params, opt_state)`` in the
reference's layout: nested dicts of the spec's paths, the layers stacked
on a leading axis, and ``OptState(step, m, v)``.  So a checkpoint that
either package's trainer writes restores in the other's, leaf for leaf.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.convert import (
    opt_state_from_reference,
    params_from_reference,
    stack_named,
)
from repro_torch.models.params import abstract_params
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault_tolerance import (
    PreemptionHandler,
    StepTimer,
    StragglerDetector,
)
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


class Trainer:
    """Trains ``model`` (a port model, float32 parameters on its device) on
    the batches of ``data_iter`` (dicts of tensors on that device), writing
    ``metrics.jsonl`` and checkpoints under ``workdir``.  ``mesh`` may be
    ``None`` or a mesh of one slot; sharded training over more slots is not
    ported and raises."""

    def __init__(self, model, run: RunConfig, data_iter, workdir, mesh=None, rules=None):
        if mesh is not None and math.prod(mesh.shape.values()) > 1:
            raise NotImplementedError(
                f"training over a mesh of {mesh.shape} is not ported (ROADMAP.md, Queue 1 "
                f"item 5.2(c)); pass mesh=None or one device")
        self.model = model
        self.run = run
        self.data_iter = data_iter
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.mesh = mesh
        self.rules = rules
        self.ckpt = CheckpointManager(self.workdir / "ckpt", keep=run.keep_checkpoints)
        self.straggler = StragglerDetector()
        self.metrics_path = self.workdir / "metrics.jsonl"
        self.step_fn = make_train_step(model, run)

    # -- state --------------------------------------------------------------
    def init_state(self, seed=0):
        """Draws the model's parameters anew from ``seed`` (a generator on
        its device) and returns ``(params, opt_state)``: the parameters by
        name and zero moments."""
        self.model.init(torch.Generator(device=self.model.device).manual_seed(seed))
        params = dict(self.model.named_parameters())
        return params, opt.init_opt_state(params)

    def _checkpoint_tree(self, opt_state):
        """``(params, opt_state)`` in the reference's layout (tensors; the
        stacked leaves are new tensors, the others the model's own)."""
        m = self.model
        return (stack_named(m, dict(m.named_parameters())),
                opt.OptState(opt_state.step, stack_named(m, opt_state.m),
                             stack_named(m, opt_state.v)))

    def _skeleton(self, opt_state):
        """The checkpoint tree's shapes and dtypes as ``meta`` tensors."""
        spec = self.model.spec()
        moments = abstract_params(spec, next(iter(opt_state.m.values())).dtype)
        return (abstract_params(spec, self.model.param_dtype),
                opt.OptState(torch.empty((), dtype=torch.int32, device="meta"), moments,
                             moments))

    def resume_or_init(self, seed=0):
        params, opt_state = self.init_state(seed)
        out = self.ckpt.restore_latest(self._skeleton(opt_state), device=self.model.device)
        if out is None:
            return 0, params, opt_state
        step, (ref_params, ref_opt), _ = out
        params_from_reference(self.model, ref_params)
        del ref_params
        opt_state = opt_state_from_reference(self.model, ref_opt)
        print(f"[trainer] resumed from step {step}")
        return step, params, opt_state

    # -- loop ---------------------------------------------------------------
    def train(self, steps=None, seed=0):
        steps = steps or self.run.steps
        start, params, opt_state = self.resume_or_init(seed)
        preempt = PreemptionHandler().install()
        mfile = self.metrics_path.open("a")
        last = {}
        try:
            for step in range(start, steps):
                batch = next(self.data_iter)
                with StepTimer() as t:
                    opt_state, metrics = self.step_fn(opt_state, batch)
                    loss = float(metrics["loss"])  # waits for the step's device work
                slow = self.straggler.observe(step, t.seconds)
                rec = {
                    "step": step,
                    "loss": loss,
                    "lr": float(metrics["lr"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "step_s": round(t.seconds, 4),
                    "straggler": slow,
                }
                last = rec
                mfile.write(json.dumps(rec) + "\n")
                mfile.flush()
                do_ckpt = (
                    (step + 1) % self.run.checkpoint_every == 0
                    or step + 1 == steps
                    or preempt.requested
                )
                if do_ckpt:
                    tree = self._checkpoint_tree(opt_state)
                    if self.run.async_checkpoint and not preempt.requested:
                        self.ckpt.save_async(step + 1, tree)
                    else:
                        self.ckpt.save(step + 1, tree)
                    del tree
                if preempt.requested:
                    print(f"[trainer] preempted at step {step + 1}; checkpoint written")
                    break
        finally:
            self.ckpt.wait()
            mfile.close()
            preempt.uninstall()
        return params, opt_state, last

