"""Fault-tolerant training loop.

Counterpart of the reference's ``train/trainer.py``.  Wires together the
train step (``train_step.make_train_step``), async atomic checkpointing
with auto-resume (``runtime/checkpoint``), preemption (a SIGTERM writes a
checkpoint and stops), straggler logging and JSONL metrics.  The model
holds its parameters, on its own device.  Given a mesh of several slots,
it trains over the mesh's ``pod``, ``data`` and ``model`` axes
(``train_step.DataParallelStep``: a replica a data row, or over a
``model`` axis larger than one a group of the model's shards a row, a
``pod`` axis folded into the rows, the moments laid out by the
reference's parameter shardings over the step's mesh); the
checkpoint is the gathered tree all the same, and the model's own
parameters are brought up to date at each checkpoint and at the end.  A
resume over a mesh places the restored tree by
:func:`checkpoint_shardings`, the layout in which
``runtime/fault_tolerance.elastic_remesh`` hands a tree back, and trains
from that placed tree (``train(restored=...)`` takes ``elastic_remesh``'s).

The checkpoint tree is the reference's ``(params, opt_state)`` in the
reference's layout: nested dicts of the spec's paths, the layers stacked
on a leading axis, and ``OptState(step, m, v)``.  So a checkpoint that
either package's trainer writes restores in the other's, leaf for leaf.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.convert import (
    opt_state_from_reference,
    params_from_reference,
    stack_named,
)
from repro_torch.models.params import abstract_params
from repro_torch.parallel.sharding import PartitionSpec as P
from repro_torch.parallel.sharding import (
    NamedSharding,
    param_shardings,
    slot_device,
    tree_map,
)
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault_tolerance import (
    PreemptionHandler,
    StepTimer,
    StragglerDetector,
)
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import DataParallelStep, make_train_step


def checkpoint_skeleton(model, moment_dtype=torch.float32):
    """The checkpoint tree's shapes and dtypes, ``(params, OptState)`` in
    the reference's layout, as ``meta`` tensors."""
    spec = model.spec()
    moments = abstract_params(spec, moment_dtype)
    return (abstract_params(spec, model.param_dtype),
            opt.OptState(torch.empty((), dtype=torch.int32, device="meta"), moments, moments))


def checkpoint_shardings(model, mesh, rules=None):
    """The layout of the checkpoint tree over ``mesh``: the parameters
    and the moments by ``param_shardings`` of the model's spec (the
    reference's FSDP layout), the step a copy on every slot.  Pass
    ``lambda mesh: checkpoint_shardings(model, mesh)`` to
    ``elastic_remesh`` for a tree that :meth:`Trainer.train` takes."""
    p_sh = param_shardings(model.spec(), mesh, rules)
    return p_sh, opt.OptState(NamedSharding(mesh, P()), p_sh, p_sh)


class Trainer:
    """Trains ``model`` (a port model, float32 parameters on its device) on
    the batches of ``data_iter`` (dicts of tensors on that device), writing
    ``metrics.jsonl`` and checkpoints under ``workdir``.  ``mesh`` may be
    ``None``, a mesh of one slot, or a ``(data, model)`` or ``(pod, data,
    model)`` mesh whose first slot is the model's device (``rules`` over
    the reference's lay the parameters and moments out); a ``model`` axis
    larger than one lays the model out over it (any family).  Over a mesh,
    ``self.mesh`` is the train step's (``DataParallelStep.mesh``: a
    ``pod`` axis folded into ``data``), over which a checkpoint is
    placed."""

    def __init__(self, model, run: RunConfig, data_iter, workdir, mesh=None, rules=None):
        if (mesh is not None and math.prod(mesh.shape.values()) > 1
                and mesh.home != slot_device(model.device)):
            raise ValueError(f"the mesh's first slot {mesh.home} is not the model's device "
                             f"{model.device}")
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
        self.step_fn = make_train_step(model, run, mesh, rules)
        self.sharded = isinstance(self.step_fn, DataParallelStep)
        if self.sharded:
            self.mesh = self.step_fn.mesh

    # -- state --------------------------------------------------------------
    def init_state(self, seed=0):
        """Draws the model's parameters anew from ``seed`` (a generator on
        its device) and returns ``(params, opt_state)``: the parameters by
        name and zero moments."""
        self.model.init(torch.Generator(device=self.model.device).manual_seed(seed))
        params = dict(self.model.named_parameters())
        if self.sharded:  # drawn on the first slot, then placed
            self.step_fn.broadcast()
            return params, self.step_fn.init_state()
        return params, opt.init_opt_state(params)

    def _checkpoint_tree(self, opt_state):
        """``(params, opt_state)`` in the reference's layout (tensors; the
        stacked leaves are new tensors, the others the model's own; over a
        mesh the moments gathered to the model's device first)."""
        m = self.model
        if self.sharded:
            self.step_fn.collect()
            opt_state = self.step_fn.gather(opt_state)
        return (stack_named(m, dict(m.named_parameters())),
                opt.OptState(opt_state.step, stack_named(m, opt_state.m),
                             stack_named(m, opt_state.v)))

    def _skeleton(self, opt_state):
        """The checkpoint tree's shapes and dtypes as ``meta`` tensors."""
        m = next(iter(opt_state.m.values()))
        return checkpoint_skeleton(self.model, m.flat[0].dtype if self.sharded else m.dtype)

    def resume_or_init(self, seed=0, restored=None):
        """``(step, params, opt_state)``: from ``restored`` where given
        (``(step, tree)``, the tree placed over this trainer's mesh by
        :func:`checkpoint_shardings`, as ``elastic_remesh`` returns it),
        else from the latest checkpoint, else drawn from ``seed``."""
        if restored is not None and not self.sharded:
            raise ValueError("a restored tree is one placed over a mesh of several slots")
        params, opt_state = self.init_state(seed)
        if restored is None:
            out = self.ckpt.restore_latest(self._skeleton(opt_state), device=self.model.device)
            if out is None:
                return 0, params, opt_state
            step, tree, _ = out
            if self.sharded:
                tree = tree_map(lambda x, sh: sh.place(x), tree,
                                checkpoint_shardings(self.model, self.mesh, self.rules))
        else:
            step, tree = restored
        del opt_state
        if self.sharded:
            opt_state = self._adopt(tree)
        else:
            params_from_reference(self.model, tree[0])
            opt_state = opt_state_from_reference(self.model, tree[1])
        del tree
        print(f"[trainer] resumed from step {step}")
        return step, params, opt_state

    def _adopt(self, placed):
        """The train step's state from a checkpoint tree placed over the
        mesh: the parameters gathered into every replica, and each slot's
        stacked moment shards unstacked into its blocks by name."""
        mesh, step_fn = self.mesh, self.step_fn
        p_sh, _ = checkpoint_shardings(self.model, mesh, self.rules)
        p_placed, o_placed = placed
        if o_placed.step.shape != mesh.devices.shape:
            raise ValueError(f"a tree placed over {o_placed.step.shape} slots, not over the "
                             f"trainer's mesh of {mesh.devices.shape}")
        params_from_reference(self.model, tree_map(
            lambda a, sh: sh.gather(a, self.model.device), p_placed, p_sh))
        step_fn.broadcast()
        shapes = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        m, v = {}, {}
        for at in np.ndindex(mesh.devices.shape):
            part = opt_state_from_reference(self.model, tree_map(lambda a: a[at], o_placed),
                                            device=mesh.devices[at])
            for out, named in ((m, part.m), (v, part.v)):
                for n, t in named.items():
                    if tuple(t.shape) != step_fn.shardings[n].shard_shape(shapes[n]):
                        raise ValueError(f"{n}: a shard of {tuple(t.shape)}, not the train "
                                         f"step's block of {shapes[n]}")
                    out.setdefault(n, np.empty(mesh.devices.shape, dtype=object))[at] = t
        return opt.OptState(o_placed.step, m, v)

    # -- loop ---------------------------------------------------------------
    def train(self, steps=None, seed=0, restored=None):
        steps = steps or self.run.steps
        start, params, opt_state = self.resume_or_init(seed, restored)
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
        if self.sharded:
            self.step_fn.collect()
        return params, opt_state, last

