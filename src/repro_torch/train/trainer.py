"""Fault-tolerant training loop.

Counterpart of the reference's ``train/trainer.py``.  Wires together the
train step (``train_step.make_train_step``), async atomic checkpointing
with auto-resume (``runtime/checkpoint``), preemption (a SIGTERM writes a
checkpoint and stops), straggler logging and JSONL metrics.  Without a
mesh the model holds its parameters, on its own device.  Given a mesh of
several slots, it trains over the mesh's ``pod``, ``data`` and ``model``
axes (``train_step.DataParallelStep``: a replica a data row, or over a
``model`` axis larger than one a group of the model's shards a row, a
``pod`` axis folded into the rows, the moments laid out by the
reference's parameter shardings over the step's mesh).  Over a ``model``
axis larger than one no card holds a whole copy of a leaf that the axis
splits, as under the reference's GSPMD: the model may be given on
``meta``, :meth:`Trainer.init_state` draws each slot's blocks from the
seed (bit for bit the blocks of the whole draw), a checkpoint is
assembled leaf by leaf on the host from the slots that own each block,
and a resume copies each slot only its blocks of the memory-mapped files.
A resume over a mesh may also start from a tree placed by
:func:`checkpoint_shardings`, the layout in which
``runtime/fault_tolerance.elastic_remesh`` hands a tree back
(``train(restored=...)``).

The checkpoint tree is the reference's ``(params, opt_state)`` in the
reference's layout: nested dicts of the spec's paths, the layers stacked
on a leading axis, and ``OptState(step, m, v)``.  So a checkpoint that
either package's trainer writes restores in the other's, leaf for leaf,
over any mesh.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.convert import (
    host_tree,
    leaf_reader,
    opt_state_from_reference,
    params_from_reference,
    whole,
)
from repro_torch.models.params import abstract_params, get_path, tree_paths
from repro_torch.parallel.sharding import PartitionSpec as P
from repro_torch.parallel.sharding import (
    NamedSharding,
    param_shardings,
    slot_device,
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
    model)`` mesh (``rules`` over the reference's lay the parameters and
    moments out).  Over a ``model`` axis of one, ``model`` may hold its
    parameters on the mesh's first slot (it is the first replica) or be on
    ``meta``; over a ``model`` axis larger than one (any family) it must be
    on ``meta`` (``get_model(cfg, device='meta')``), as the reference's
    stateless model: the step holds each slot's blocks alone, which
    :meth:`init_state` or a resume fills, and ``self.step_fn.collect()``
    reads the weights out (a model holding parameters raises
    ``ValueError``: its weights would be drawn anew or restored over, and
    would go stale beside the blocks).  Over a mesh, ``self.mesh`` is the
    train step's (``DataParallelStep.mesh``: a ``pod`` axis folded into
    ``data``), over which a checkpoint is placed, and ``self.model`` the
    step's model: the first replica over a ``model`` axis of one, else the
    model on ``meta`` (its names and shapes)."""

    def __init__(self, model, run: RunConfig, data_iter, workdir, mesh=None, rules=None):
        if mesh is not None and math.prod(mesh.shape.values()) > 1 and model.device.type != "meta":
            if mesh.shape.get("model", 1) > 1:
                raise ValueError(
                    f"over a 'model' axis of {mesh.shape['model']} the Trainer holds each "
                    f"slot's blocks alone: give it the model on meta (get_model(cfg, "
                    f"device='meta')); init_state or a resume fills the blocks, and "
                    f"step_fn.collect() reads the weights out")
            if mesh.home != slot_device(model.device):
                raise ValueError(f"the mesh's first slot {mesh.home} is not the model's device "
                                 f"{model.device}")
        self.run = run
        self.data_iter = data_iter
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.mesh = mesh
        self.rules = rules
        self.ckpt = CheckpointManager(self.workdir / "ckpt", keep=run.keep_checkpoints)
        self.straggler = StragglerDetector()
        self.metrics_path = self.workdir / "metrics.jsonl"
        # a model on meta over a mesh: left unset, init_state or a resume fills it
        self.step_fn = make_train_step(model, run, mesh, rules, seed=None)
        self.sharded = isinstance(self.step_fn, DataParallelStep)
        self.model = model
        if self.sharded:
            self.mesh = self.step_fn.mesh
            if self.step_fn.n_model == 1:
                self.model = self.step_fn.model
        self.laid_out = self.sharded and self.step_fn.n_model > 1

    # -- state --------------------------------------------------------------
    def _params(self) -> dict:
        """The parameters by name: the model's, or over a ``model`` axis
        larger than one the first data row's slots' (``slots.<k>.<name>``)."""
        held = self.step_fn.replicas[0] if self.laid_out else self.model
        return dict(held.named_parameters())

    def init_state(self, seed=0):
        """Draws the parameters anew from ``seed`` and returns ``(params,
        opt_state)``: the parameters by name (:meth:`_params`) and zero
        moments.  Without a ``model`` axis larger than one the model is
        drawn on its device (a generator there) and copied into the other
        replicas; with one each device draws every leaf once and each slot
        keeps its blocks (``LaidOutModel.init``), the same bits."""
        if self.laid_out:
            self.step_fn.laid.init(seed)
            return self._params(), self.step_fn.init_state()
        self.model.init(torch.Generator(device=self.model.device).manual_seed(seed))
        params = self._params()
        if self.sharded:  # drawn on the first slot, then copied into the rows
            self.step_fn.broadcast()
            return params, self.step_fn.init_state()
        return params, opt.init_opt_state(params)

    def _checkpoint_tree(self, opt_state):
        """``(params, opt_state)`` in the reference's layout as numpy arrays
        assembled on the host (``convert.host_tree``), sharing nothing with
        the state: the model's tensors, or over a mesh the parameters from
        the first data row (over a ``model`` axis larger than one each
        slot's blocks) and each moment from the slots that own its blocks,
        so no whole leaf is made on a card."""
        if self.laid_out:
            first = self.step_fn.replicas[0]

            def params(name):
                return [(first.slices(k, name), sl.get_parameter(name))
                        for k, sl in enumerate(first.slots)]
        else:
            params = whole(self._params())
        if self.sharded:
            def moments(named):
                return lambda name: self.step_fn.shardings[name].pieces(named[name])
        else:
            moments = whole
        step = opt_state.step.flat[0] if self.sharded else opt_state.step
        m = self.model
        return (host_tree(m, params),
                opt.OptState(step.detach().cpu().numpy().copy(),
                             host_tree(m, moments(opt_state.m)),
                             host_tree(m, moments(opt_state.v))))

    def resume_or_init(self, seed=0, restored=None):
        """``(step, params, opt_state)``: from ``restored`` where given
        (``(step, tree)``, the tree placed over this trainer's mesh by
        :func:`checkpoint_shardings`, as ``elastic_remesh`` returns it),
        else from the latest checkpoint (over a mesh its files memory-mapped,
        each slot reading its blocks), else drawn from ``seed``."""
        if restored is not None and not self.sharded:
            raise ValueError("a restored tree is one placed over a mesh of several slots")
        if restored is None:
            out = self.ckpt.restore_latest(
                checkpoint_skeleton(self.model),
                **({"mmap": True} if self.sharded else {"device": self.model.device}))
            if out is None:
                params, opt_state = self.init_state(seed)
                return 0, params, opt_state
            step, tree, _ = out
        else:
            step, tree = restored
        if self.sharded:
            opt_state = self._adopt(tree)
        else:
            params_from_reference(self.model, tree[0])
            opt_state = opt_state_from_reference(self.model, tree[1])
        del tree
        print(f"[trainer] resumed from step {step}")
        return step, self._params(), opt_state

    def _adopt(self, tree):
        """The train step's state from a checkpoint tree, each slot reading
        only its blocks: the parameters into every data row, each moment's
        owned blocks, the step on every slot.  ``tree`` holds host arrays in
        the reference's layout (the memory-mapped files) or shards placed
        over the mesh by :func:`checkpoint_shardings` (``elastic_remesh``'s
        tree)."""
        mesh, step_fn = self.mesh, self.step_fn
        p_tree, o_tree = tree
        placed = isinstance(o_tree.step, np.ndarray) and o_tree.step.dtype == object
        if placed and o_tree.step.shape != mesh.devices.shape:
            raise ValueError(f"a tree placed over {o_tree.step.shape} slots, not over the "
                             f"trainer's mesh of {mesh.devices.shape}")
        p_sh, _ = checkpoint_shardings(self.model, mesh, self.rules)
        for path, leaf in tree_paths(self.model.spec()):
            for part in (p_tree, o_tree.m, o_tree.v):
                x = get_path(part, path)
                got = tuple(get_path(p_sh, path).global_shape(x) if placed else x.shape)
                if got != tuple(leaf.shape):
                    raise ValueError(f"{'/'.join(path)}: {got} in the checkpoint, not the "
                                     f"model's {tuple(leaf.shape)}")
        # a placed tree's region is read from the shards that hold it
        take = (lambda path, leaf, cut, dev: get_path(p_sh, path).read(leaf, cut, dev)) \
            if placed else None
        read = leaf_reader(p_tree, take)
        for rep in step_fn.replicas:
            if self.laid_out:
                rep.load(read)
            else:
                with torch.no_grad():
                    for name, p in rep.named_parameters():
                        p.copy_(read(name, tuple(slice(0, n) for n in p.shape), p.device))
        shapes = step_fn.shapes
        m, v = {}, {}
        reads = [(m, leaf_reader(o_tree.m, take)), (v, leaf_reader(o_tree.v, take))]
        for at in np.ndindex(mesh.devices.shape):
            dev = mesh.devices[at]
            for out, read in reads:
                for n, shape in shapes.items():
                    block = read(n, step_fn.shardings[n].block(at, shape), dev)
                    out.setdefault(n, np.empty(mesh.devices.shape, dtype=object))[at] = \
                        block.to(device=dev, dtype=torch.float32)
        steps = np.empty(mesh.devices.shape, dtype=object)
        for at in np.ndindex(mesh.devices.shape):
            s = o_tree.step[at] if placed else torch.from_numpy(np.array(o_tree.step))
            steps[at] = s.to(device=mesh.devices[at], dtype=torch.int32, copy=True).reshape(())
        return opt.OptState(steps, m, v)

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
                    tree = self._checkpoint_tree(opt_state)  # host arrays of its own
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

