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

import numpy as np
import torch
import torch.profiler
import torch.utils.checkpoint

from repro_torch.models.tensor_parallel import VocabShards, lay_out
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import PartitionSpec as P
from repro_torch.parallel.sharding import ModelGroup, active_mesh, axis_size
from repro_torch.train import optimizer as opt


def cross_entropy(logits, labels, vocab_size, zloss=0.0, chunk=512, weights=None):
    """Mean next-token CE, chunked over sequence to bound logit memory.

    logits: (B, S, Vp) (padded vocab), or a ``VocabShards`` of a model
    group (:func:`_sharded_cross_entropy`); labels: (B, S) (already
    shifted); weights: optional (B, S) loss mask (0 = ignore position).
    """
    if isinstance(logits, VocabShards):
        return _sharded_cross_entropy(logits, labels, vocab_size, zloss, chunk, weights)
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


def _sharded_cross_entropy(shards, labels, vocab_size, zloss, chunk, weights):
    """:func:`cross_entropy` over logits split over the vocabulary, one
    block a slot of a model group, as the reference's contraction reduces
    over a vocab-sharded axis instead of gathering: the maximum over the
    slots (no gradient: the log-sum-exp's gradient through it is zero),
    then each slot's sum of exponentials and its share of the gold logit
    (zero where the label lies in another slot's block), each added over
    the slots in slot order on the first slot.  The padded vocabulary is
    masked at each slot's global offset.  Logits whole on every slot are
    the first slot's."""
    group = shards.group
    if not shards.split:
        return cross_entropy(group.first(shards.parts), labels, vocab_size, zloss, chunk,
                             weights)
    b, s, width = shards.parts[0].shape
    chunk = min(chunk, s)
    n = s // chunk if s % chunk == 0 else 1
    if s % chunk:
        chunk = s
    home = group.home
    if weights is None:
        weights = torch.ones((b, s), dtype=torch.float32, device=home)
    weights = weights.to(device=home, dtype=torch.float32)
    labs = group.copies(labels.long())
    offsets = [k * width for k in range(group.size)]
    valid = group.each(lambda off, p: off + torch.arange(width, device=p.device) < vocab_size,
                       offsets, shards.parts)
    total = torch.zeros((), dtype=torch.float32, device=home)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        xs = group.each(lambda p, ok: torch.where(ok, p[:, sl].to(torch.float32), -1e30),
                        shards.parts, valid)
        m = group.pmax(group.each(lambda x: torch.amax(x.detach(), dim=-1, keepdim=True), xs))
        se = group.each(lambda x, mk: torch.sum(torch.exp(x - mk), dim=-1), xs, m)

        def gold_share(x, lab, off):
            local = lab[:, sl] - off
            inside = (local >= 0) & (local < width)
            g = torch.gather(x, -1, local.clamp(0, width - 1)[..., None])[..., 0]
            return torch.where(inside, g, 0.0)

        gold = group.first(group.reduce(group.each(gold_share, xs, labs, offsets)))
        lse = torch.log(group.first(group.reduce(se))) + m[0][..., 0]
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
    here, once before the microbatch loop.  Without a mesh, on a mesh of
    one slot, or inside a data row of a mesh step (where each slot holds
    its ``model`` blocks whole over ``data``), there is nothing to place:
    ``params`` as given."""
    mesh = active_mesh()
    if mesh is None or math.prod(mesh.shape.values()) == 1:
        return params
    raise NotImplementedError(f"a train step over a mesh of {mesh.shape} runs through "
                              f"make_train_step(model, run, mesh), which lays the model out "
                              f"over it; not under an ambient mesh")


def _grads(model, loss_fn, run, batch):
    """The loss and its metrics (single-batch path only) of ``batch``, the
    gradients left in ``model``'s ``.grad`` (zeros for an unused leaf)."""
    params = dict(model.named_parameters())
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


def make_train_step(model, run, mesh=None, rules=None, seed=0):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``:
    ``metrics`` holds 0-d tensors ``loss``, ``lr``, ``grad_norm`` and, on
    the single-batch path, ``ce`` and ``aux``.  The model's parameters must
    be float32, as the reference's are (``cfg.dtype`` sets the compute).
    With a ``mesh`` of more than one slot the step is a
    :class:`DataParallelStep` over its ``data`` and ``model`` axes, which
    also takes a model on ``meta``, drawn from ``seed`` (``None``: left
    unset, for the caller to draw or restore)."""
    if mesh is not None and math.prod(mesh.shape.values()) > 1:
        return DataParallelStep(model, run, mesh, rules, seed)
    if model.device.type == "meta":
        raise ValueError("a model on meta holds no parameters: train it over a mesh of several "
                         "slots, which lays it out, or build it on a device")
    if model.param_dtype != torch.float32:
        raise ValueError(f"training keeps float32 parameters, not {model.param_dtype}")
    loss_fn = make_loss_fn(model, run)
    schedule = opt.make_schedule(run)
    params = dict(model.named_parameters())

    def train_step(opt_state, batch):
        # two profiler spans (each ~1 us without a profiler): the gradient
        # and the update, so a trace splits a step's host and device time
        with torch.profiler.record_function("train_step.grad"):
            loss, metrics = _grads(model, loss_fn, run, batch)
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

    return train_step


class DataParallelStep:
    """The train step over the ``data`` and ``model`` axes of a mesh: the
    reference's train step under its FSDP and tensor-parallel layout.

    Each data row runs the forward and backward of its contiguous shard of
    the batch under ``parallel.sharding.shard_map_compat``, a host thread a
    row.  With a ``model`` axis of one a row is a replica of the model on
    its slot's device (the first row's is ``model`` itself, ``self.model``;
    a model on ``meta`` is drawn on the first slot from ``seed``, or left
    unset with ``None``).
    With more, a row is a ``models/tensor_parallel`` group of shards (any
    family) of ``self.laid`` (``lay_out(model, mesh, seed=seed)``: a model
    on ``meta`` drawn from ``seed`` block by block, or left unset for the
    caller with ``None``; a whole model's blocks copied and the model not
    kept, so no card holds a whole copy of a leaf that ``model`` splits):
    a shard of the model a slot of the row, driven by the row's thread as
    one autograd graph (no barrier in its backward), whose whole leaves
    read inside a block of work have their partial gradients added over
    the row (``sum_region_grads``).  A ``pod`` axis is folded into the
    data rows, outermost (row = pod x n_data + data), as the reference's ``batch ->
    ('pod', 'data')`` lays out the batch: the step runs on that
    ``(pod x data, model)`` mesh (``self.mesh``), so its moments' FSDP
    blocks span the pods too, where the reference's ``embed -> data``
    replicates them over pods (ROADMAP.md, Queue 3).  Each parameter has
    its reference layout over the (folded) mesh (``param_shardings`` of
    the model's spec, a stacked leaf's spec without its layer entry): a
    slot owns one block of each leaf, within its shard, and its float32
    moments are that block's.  A step then

      * reduces the gradients over ``data``: each slot adds its blocks of
        every row's gradient (the same ``model`` slot's) in row order and
        divides by the rows that ran, so every row holds the bits any
        other would;
      * takes the global norm from each slot's owned blocks, a leaf counted
        on one slot of each axis that does not split it (the first), a sum
        over the row's slots in slot order and a ``psum`` over the rows;
      * runs AdamW on each slot's blocks, and copies every other row's
        updated blocks into its shard, so the rows stay equal.

    The mean over rows equals the global batch's mean loss only while each
    shard weighs the same token count: every shard has the same rows and
    the loss masks one position a row (``make_loss_fn``), which the step
    checks.  A batch the data axis does not divide is not padded: as the
    reference's ``pspec`` replicates it, the first row runs it whole and
    the others run no forward.  An MoE model forms its dispatch groups over
    a row's tokens, so a shard matches the global batch's groups only when
    the tokens a row routes at once are a multiple of ``moe_group_size``;
    elsewhere the step raises ``ValueError``.

    The state is an ``OptState`` over the (folded) mesh, in the layout of
    ``parallel.sharding.NamedSharding.place``: each of its leaves (the step
    and each parameter's m and v) an object array shaped as that mesh's
    devices, each entry the slot's shard on its device (:meth:`init_state`
    makes each slot's zeros in place; :meth:`gather` goes through
    ``state_shardings``).  After the first row's parameters are set outside
    a step, :meth:`broadcast` copies them into the other rows;
    :meth:`collect` gives the parameters as a whole model (the first
    replica, or the first row's blocks gathered on the CPU).  ``abstract``
    is the model on ``meta``: its names and shapes.  A mesh with an axis
    other than ``pod``, ``data`` and ``model`` larger than one raises
    ``NotImplementedError``: the reference's train step lays nothing else
    out (GPipe's stages are ``parallel/pipeline.py``'s).
    """

    def __init__(self, model, run, mesh, rules=None, seed=0):
        mesh = fold_pods(mesh)
        if model.param_dtype != torch.float32:
            raise ValueError(f"training keeps float32 parameters, not {model.param_dtype}")
        self.cfg, self.run, self.mesh = model.cfg, run, mesh
        self.abstract = model if model.device.type == "meta" else model.meta()
        self.n_model = axis_size(mesh, "model")
        self.slots = mesh.slots("data")  # each row's first slot
        self.n = len(self.slots)
        self.rows = [ModelGroup(mesh, at).indices for at in self.slots]
        if self.n_model == 1:
            if model.device.type == "meta":  # drawn on the first slot, or left unset
                model = (type(model).empty(model.cfg, mesh.home, model.param_dtype)
                         if seed is None else
                         type(model)(model.cfg, device=mesh.home, dtype=model.param_dtype,
                                     generator=torch.Generator(device=mesh.home).manual_seed(seed)))
            self.model = model
            self.replicas = [model] + [self._replica(mesh.devices[i]) for i in self.slots[1:]]
            self._row_mesh = mesh
        else:
            self.laid = lay_out(model, mesh, rules, seed)
            self.replicas = self.laid.groups
            row_devices = np.empty(self.n, dtype=object)
            row_devices[:] = [mesh.devices[at] for at in self.slots]
            self._row_mesh = sharding.Mesh(row_devices, ("data",))
        del model  # a whole model's blocks are copied: the step keeps no reference to it
        self.shardings = self._shardings(self.abstract, mesh, rules)
        self.state_shardings = opt.OptState(sharding.NamedSharding(mesh, P()),
                                            self.shardings, self.shardings)
        # the whole parameters' shapes by name
        self.shapes = shapes = {n: tuple(p.shape) for n, p in self.abstract.named_parameters()}
        # each row's slots' parameters by the whole model's names, and the
        # block each slot owns as slices of its own parameter
        self._params = [[dict(self._slot_module(d, m).named_parameters())
                         for m in range(self.n_model)] for d in range(self.n)]
        self._blocks = [[{n: self._owned(n, d, m, shapes[n]) for n in shapes}
                         for m in range(self.n_model)] for d in range(self.n)]
        # a leaf is split over data where a slot owns less than its shard
        first = self._params[0][0]
        self._split_names = {n for n, b in self._blocks[0][0].items()
                             if tuple(s.stop - s.start for s in b) != tuple(first[n].shape)}
        by_model = {n for n in shapes if tuple(first[n].shape) != shapes[n]}
        self._counted = [[{n for n in shapes if (d == 0 or n in self._split_names)
                           and (m == 0 or n in by_model)} for m in range(self.n_model)]
                         for d in range(self.n)]
        self.loss_fns = [make_loss_fn(r, run) for r in self.replicas]
        self.schedule = opt.make_schedule(run)

    def _replica(self, device):
        m = self.model
        rep = type(m).empty(m.cfg, device, m.param_dtype)
        rep.load_state_dict(m.state_dict())
        return rep

    def _slot_module(self, d, m):
        rep = self.replicas[d]
        return rep if self.n_model == 1 else rep.slots[m]

    def _owned(self, name, d, m, shape):
        """The block of ``name`` that slot (row ``d``, model slot ``m``)
        owns, as slices of the slot's parameter."""
        full = self.shardings[name].block(self.rows[d][m], shape)
        if self.n_model == 1:
            return full
        base = self.replicas[d].slices(m, name)
        return tuple(slice(f.start - b.start, f.stop - b.start) for f, b in zip(full, base))

    @staticmethod
    def _shardings(model, mesh, rules):
        from repro_torch.models.convert import _param_names
        from repro_torch.models.params import STACKED, get_path, tree_paths

        tree = sharding.param_shardings(model.spec(), mesh, rules)
        out = {}
        for path, _ in tree_paths(model.spec()):
            sh = get_path(tree, path)
            if path[0] in STACKED:
                if sh.spec and sh.spec[0] is not None:
                    raise NotImplementedError(f"{'/'.join(path)}: layers laid out over "
                                              f"{sh.spec[0]!r}; a replica holds every layer")
                sh = sharding.NamedSharding(mesh, sh.spec[1:])
            for name in _param_names(model, path):
                out[name] = sh
        return out

    # -- state ---------------------------------------------------------------
    @torch.no_grad()
    def broadcast(self):
        """Copy the first row's parameters (its replica, or its model
        slots' blocks) into every other row."""
        src = dict(self.replicas[0].named_parameters())
        for rep in self.replicas[1:]:
            for name, p in rep.named_parameters():
                p.copy_(src[name])

    def collect(self, device="cpu"):
        """The parameters as a whole model: on a ``model`` axis of one the
        first replica itself (``self.model``, up to date after every step);
        else a new model on ``device`` (default the CPU) holding the first
        row's blocks (``LaidOutModel.gather``), for reading the weights
        out."""
        return self.model if self.n_model == 1 else self.laid.gather(device)

    def _zeros(self, shape, dtype) -> np.ndarray:
        """An object array shaped as the mesh's devices: each slot's zeros
        of ``shape`` made on its device."""
        devices = self.mesh.devices
        out = np.empty(devices.shape, dtype=object)
        for i in np.ndindex(devices.shape):
            out[i] = torch.zeros(shape, dtype=dtype, device=devices[i])
        return out

    def init_state(self, dtype=torch.float32) -> opt.OptState:
        """Zero moments in ``dtype`` and step 0, laid out over the slots:
        each slot's blocks made in place on its device."""
        def zeros():
            return {n: self._zeros(self.shardings[n].shard_shape(shape), dtype)
                    for n, shape in self.shapes.items()}

        return opt.OptState(self._zeros((), torch.int32), zeros(), zeros())

    def gather(self, state, device=None) -> opt.OptState:
        """The whole ``OptState`` on ``device`` (default the model's on a
        ``model`` axis of one, else the CPU)."""
        if device is None:
            device = self.model.device if self.n_model == 1 else "cpu"
        return sharding.tree_map(lambda a, sh: sh.gather(a, device), state,
                                 self.state_shardings)

    # -- the step --------------------------------------------------------------
    def _check_batch(self, batch, sharded: bool):
        rows = len(batch["tokens"])
        if not sharded:
            return
        per = rows // self.n
        if per * self.n != rows:  # the mean over slots needs equal shards
            raise RuntimeError(f"{rows} rows do not split into {self.n} equal shards")
        cfg = self.cfg
        if cfg.n_experts:
            mb = self.run.microbatch if self.run.microbatch and self.run.microbatch > 1 else 1
            seq = batch["tokens"].shape[1] + (batch["prefix"].shape[1] if "prefix" in batch else 0)
            routed = per // mb * seq
            if routed % cfg.moe_group_size:
                raise ValueError(
                    f"{cfg.name}: a data slot routes {routed} tokens at once ({per // mb} rows "
                    f"of {seq}), not a multiple of moe_group_size {cfg.moe_group_size}: its "
                    f"dispatch groups would differ from the global batch's")

    def __call__(self, state: opt.OptState, batch):
        rows = len(batch["tokens"])
        sharded = rows % self.n == 0
        self._check_batch(batch, sharded)
        spec = P("data") if sharded else P()
        steps = np.empty(state.step.shape, dtype=object)
        step = sharding.shard_map_compat(
            lambda b: self._slot(state, steps, b, sharded), self._row_mesh, (spec,), P())
        metrics = step(batch)
        return opt.OptState(steps, state.m, state.v), metrics

    def _slot(self, state, steps, batch, sharded):
        d = sharding.axis_index("data")
        rep, at, params = self.replicas[d], self.rows[d], self._params[d]
        devs = self._row_devices(d)
        active = sharded or d == 0
        with torch.profiler.record_function("train_step.grad"):
            if active:
                loss, metrics = _grads(rep, self.loss_fns[d], self.run, batch)
                if self.n_model > 1:
                    rep.sum_region_grads()
            grads = [{n: p.grad for n, p in ps.items()} for ps in params] if active else None
            n_active = self.n if sharded else 1
            _join(devs)
            owned = sharding.collective(grads, "data",
                                        lambda ops: self._reduce(ops, d, n_active))
            _fork(devs)
        with torch.profiler.record_function("train_step.adamw"):
            part = None
            for m, got in enumerate(owned):
                mine = [torch.sum(torch.square(g.float())) for n, g in got.items()
                        if n in self._counted[d][m]]
                pm = (torch.sum(torch.stack(mine)) if mine else
                      torch.zeros((), dtype=torch.float32, device=devs[m]))
                part = pm if part is None else part + pm.to(devs[0], non_blocking=True)
            gnorm = torch.sqrt(sharding.psum(part, "data"))
            lrs, split = [], []
            with torch.no_grad():
                for m, i in enumerate(at):
                    lr = self.schedule(state.step[i])
                    blocks = {n: p[self._blocks[d][m][n]] for n, p in params[m].items()}
                    _, new, _ = opt.adamw_update(
                        blocks, owned[m], opt.OptState(state.step[i],
                                                       {n: a[i] for n, a in state.m.items()},
                                                       {n: a[i] for n, a in state.v.items()}),
                        lr, weight_decay=self.run.weight_decay, grad_clip=self.run.grad_clip,
                        gnorm=gnorm if m == 0 else gnorm.to(devs[m], non_blocking=True))
                    steps[i] = new.step
                    lrs.append(lr)
                    split.append({n: b for n, b in blocks.items() if n in self._split_names})
                _join(devs)
                sharding.collective(split, "data", lambda ops: self._fill(ops, d))
                _fork(devs)
            vals = {"loss": loss.detach()} if active else {}
            if active:
                vals.update({n: v.detach() for n, v in metrics.items()})
            mean = sharding.collective(vals, "data", lambda ops: self._mean(ops, n_active))
        _join(devs)
        return {"loss": mean["loss"], "lr": lrs[0], "grad_norm": gnorm,
                **{n: mean[n] for n in mean if n != "loss"}}

    def _reduce(self, ops, d, n_active):
        """Row ``d``'s slots' blocks of the mean gradient, one dict a model
        slot: the blocks of every row that ran, added in row order."""
        out = []
        for m, blocks in enumerate(self._blocks[d]):
            def mine(tree, m=m, blocks=blocks):
                return None if tree is None else {n: tree[m][n][b] for n, b in blocks.items()}

            acc = None
            for j in range(len(ops)):
                g = ops.select(j, mine, device=self.mesh.devices[self.rows[d][m]])
                if g is None:  # a row that ran no forward
                    continue
                acc = {n: x.clone() for n, x in g.items()} if acc is None else \
                    {n: a.add_(g[n]) for n, a in acc.items()}
            out.append({n: a.div_(n_active) for n, a in acc.items()} if n_active > 1 else acc)
        _join(self._row_devices(d))  # the reads on the row's other cards are done with the row
        return out

    def _row_devices(self, d) -> list:
        return [self.mesh.devices[i] for i in self.rows[d]]

    def _fill(self, ops, d):
        """Copy every other row's updated blocks into row ``d``'s slots."""
        for j in range(len(ops)):
            if j == d:
                continue
            for m, params in enumerate(self._params[d]):
                got = ops.select(j, lambda tree, m=m: tree[m],
                                 device=self.mesh.devices[self.rows[d][m]])
                for name, b in got.items():
                    params[name].data[self._blocks[j][m][name]].copy_(b)
        _join(self._row_devices(d))

    @staticmethod
    def _mean(ops, n_active):
        """Each metric added over the slots that ran, in slot order, over
        their count."""
        out = {}
        for n in ops[0]:
            acc = ops[0][n].clone()
            for j in range(1, len(ops)):
                if n in ops[j]:
                    acc = acc.add_(ops[j][n])
            out[n] = acc.div_(n_active) if n_active > 1 else acc
        return out


def fold_pods(mesh):
    """``mesh`` as the train step's ``('data', 'model')`` mesh: a ``pod``
    axis folded into ``data``, outermost (row = pod x n_data + data); a
    mesh without one as it is.  Raises ``NotImplementedError`` for any
    other axis larger than one, and for a mesh without ``data``."""
    wide = {a: n for a, n in mesh.shape.items()
            if a not in ("pod", "data", "model") and n > 1}
    if wide or "data" not in mesh.shape:
        raise NotImplementedError(
            f"training over a mesh of {mesh.shape}: the step runs over the 'pod', 'data' and "
            f"'model' axes, as the reference's lays the batch over ('pod', 'data') and the "
            f"weights over 'model'; GPipe's stages are parallel/pipeline.py's")
    if "pod" not in mesh.shape:
        return mesh
    order = [mesh.axis_names.index(a) for a in ("pod", "data", "model") if a in mesh.shape]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]  # each of size 1
    rows = mesh.shape["pod"] * mesh.shape["data"]
    devices = mesh.devices.transpose(order + rest).reshape(rows, mesh.shape.get("model", 1))
    return sharding.Mesh(devices, ("data", "model"))


def _join(devs):
    """On the card: the first device's current stream waits for the other
    cards' current streams of a row (so an event it records covers the
    row)."""
    home = devs[0]
    if home.type != "cuda":
        return
    for dev in {d for d in devs[1:] if d != home}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        torch.cuda.current_stream(home).wait_event(ev)


def _fork(devs):
    """On the card: the row's other cards' current streams wait for the
    first device's."""
    home = devs[0]
    others = {d for d in devs[1:] if d != home}
    if home.type != "cuda" or not others:
        return
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(home))
    for dev in others:
        torch.cuda.current_stream(dev).wait_event(ev)


def make_eval_step(model, run):
    """Returns ``eval_step(batch) -> {"loss", "ce", "aux"}``, no gradient."""
    loss_fn = make_loss_fn(model, run)

    def eval_step(batch):
        with torch.no_grad():
            loss, metrics = loss_fn(batch)
        return {"loss": loss, **metrics}

    return eval_step
