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

from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import PartitionSpec as P
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
    here, once before the microbatch loop.  Without a mesh, on a mesh of
    one slot, or inside a data-parallel slot (where the replica holds every
    parameter whole), there is nothing to place: ``params`` as given."""
    mesh = active_mesh()
    if mesh is None or math.prod(mesh.shape.values()) == 1:
        return params
    raise NotImplementedError("a train step over a mesh runs through make_train_step(mesh=), "
                              "one replica a data slot")


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


def make_train_step(model, run, mesh=None, rules=None):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``:
    ``metrics`` holds 0-d tensors ``loss``, ``lr``, ``grad_norm`` and, on
    the single-batch path, ``ce`` and ``aux``.  The model's parameters must
    be float32, as the reference's are (``cfg.dtype`` sets the compute).
    With a ``mesh`` of more than one slot the step is a
    :class:`DataParallelStep` over its ``data`` axis."""
    if mesh is not None and math.prod(mesh.shape.values()) > 1:
        return DataParallelStep(model, run, mesh, rules)
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
    """The train step over the ``data`` axis of a mesh: the reference's
    data-parallel train step, its moments laid out as its FSDP lays them.

    Each data slot holds a replica of the model on its device (the first
    slot's is ``model`` itself) and runs the forward and backward of its
    contiguous shard of the batch, under ``parallel.sharding.
    shard_map_compat``.  Each parameter has its reference layout
    (``param_shardings`` of the model's spec, a stacked leaf's spec without
    its layer entry): a slot owns one block of each sharded parameter, and
    its float32 moments are that block's.  A step then

      * reduces the gradients: each slot adds its blocks of every slot's
        gradient in slot order and divides by the slots that ran, so every
        slot holds the bits any other would;
      * takes the global norm from each slot's owned blocks (a replicated
        leaf counted on the first slot), a ``psum`` over the slots;
      * runs AdamW on each slot's blocks, and copies every other slot's
        updated blocks into its replica, so the replicas stay equal.

    The mean over slots equals the global batch's mean loss only while each
    shard weighs the same token count: every shard has the same rows and
    the loss masks one position a row (``make_loss_fn``), which the step
    checks.  A batch the data axis does not divide is not padded: as the
    reference's ``pspec`` replicates it, the first slot runs it whole and
    the others run no forward.  An MoE model forms its dispatch groups over
    a slot's tokens, so a shard matches the global batch's groups only when
    the tokens a slot routes at once are a multiple of ``moe_group_size``;
    elsewhere the step raises ``ValueError``.

    The state is an ``OptState`` over the mesh, in the layout of
    ``parallel.sharding.NamedSharding.place``: each of its leaves (the step
    and each parameter's m and v) an object array shaped as the mesh's
    devices, each entry the slot's shard on its device (:meth:`init_state`
    and :meth:`gather` go through ``state_shardings``).
    After the model's parameters are set outside a step, :meth:`broadcast`
    copies them into the replicas.  A mesh whose ``model`` axis (or any
    axis but ``data``) is larger than one raises ``NotImplementedError``:
    tensor parallelism is not ported.
    """

    def __init__(self, model, run, mesh, rules=None):
        wide = {a: n for a, n in mesh.shape.items() if a != "data" and n > 1}
        if wide or "data" not in mesh.shape:
            raise NotImplementedError(
                f"training over a mesh of {mesh.shape}: only the 'data' axis may be larger "
                f"than one; tensor parallelism over the 'model' axis is not ported (ROADMAP.md, "
                f"Queue 1 item 5.3)")
        if model.param_dtype != torch.float32:
            raise ValueError(f"training keeps float32 parameters, not {model.param_dtype}")
        self.model, self.run, self.mesh = model, run, mesh
        self.slots = mesh.slots("data")
        self.n = len(self.slots)
        self.replicas = [model] + [self._replica(mesh.devices[i]) for i in self.slots[1:]]
        self.shardings = self._shardings(model, mesh, rules)
        self.state_shardings = opt.OptState(sharding.NamedSharding(mesh, P()),
                                            self.shardings, self.shardings)
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self._blocks = [{n: sh.block(self.slots[k], shapes[n])
                         for n, sh in self.shardings.items()} for k in range(self.n)]
        # a leaf is split where a slot's block is smaller than the leaf: a
        # spec that names only axes of size one leaves every slot the whole
        self._split_names = {n for n, sh in self.shardings.items()
                             if sh.shard_shape(shapes[n]) != shapes[n]}
        self.loss_fns = [make_loss_fn(r, run) for r in self.replicas]
        self.schedule = opt.make_schedule(run)

    def _replica(self, device):
        m = self.model
        rep = type(m)(m.cfg, device=device, dtype=m.param_dtype,
                      generator=torch.Generator(device=device).manual_seed(0))
        rep.load_state_dict(m.state_dict())
        return rep

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

    def _block(self, name, k):
        """The slices of the block of parameter ``name`` that data slot
        ``k`` owns."""
        return self._blocks[k][name]

    # -- state ---------------------------------------------------------------
    @torch.no_grad()
    def broadcast(self):
        """Copy the model's parameters into every other replica."""
        src = dict(self.model.named_parameters())
        for rep in self.replicas[1:]:
            for name, p in rep.named_parameters():
                p.copy_(src[name])

    def init_state(self, dtype=torch.float32) -> opt.OptState:
        """Zero moments in ``dtype`` and step 0, laid out over the slots
        (each leaf made whole on the first slot, then placed)."""
        home = self.mesh.home
        shapes = {n: p.shape for n, p in self.model.named_parameters()}

        def zeros():
            return {n: self.shardings[n].place(torch.zeros(shape, dtype=dtype, device=home))
                    for n, shape in shapes.items()}

        return opt.OptState(self.state_shardings.step.place(
            torch.zeros((), dtype=torch.int32, device=home)), zeros(), zeros())

    def gather(self, state, device=None) -> opt.OptState:
        """The whole ``OptState`` on ``device`` (default the model's)."""
        device = self.model.device if device is None else device
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
        cfg = self.model.cfg
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
            lambda b: self._slot(state, steps, b, sharded), self.mesh, (spec,), P())
        metrics = step(batch)
        return opt.OptState(steps, state.m, state.v), metrics

    def _slot(self, state, steps, batch, sharded):
        k = sharding.axis_index("data")
        at = self.slots[k]
        rep = self.replicas[k]
        params = dict(rep.named_parameters())
        active = sharded or k == 0
        with torch.profiler.record_function("train_step.grad"):
            if active:
                loss, metrics = _grads(rep, self.loss_fns[k], self.run, batch)
            grads = {n: p.grad for n, p in params.items()} if active else None
            n_active = self.n if sharded else 1
            owned = sharding.collective(grads, "data",
                                        lambda ops: self._reduce(ops, k, n_active))
        with torch.profiler.record_function("train_step.adamw"):
            mine = [torch.sum(torch.square(g.float())) for n, g in owned.items()
                    if k == 0 or n in self._split_names]
            part = (torch.sum(torch.stack(mine)) if mine else
                    torch.zeros((), dtype=torch.float32, device=rep.device))
            gnorm = torch.sqrt(sharding.psum(part, "data"))
            lr = self.schedule(state.step[at])
            with torch.no_grad():
                blocks = {n: p[self._block(n, k)] for n, p in params.items()}
                _, new, _ = opt.adamw_update(
                    blocks, owned, opt.OptState(state.step[at],
                                                {n: a[at] for n, a in state.m.items()},
                                                {n: a[at] for n, a in state.v.items()}), lr,
                    weight_decay=self.run.weight_decay, grad_clip=self.run.grad_clip,
                    gnorm=gnorm)
                split = {n: b for n, b in blocks.items() if n in self._split_names}
                sharding.collective(split, "data", lambda ops: self._fill(ops, params, k))
            steps[at] = new.step
            vals = {"loss": loss.detach()} if active else {}
            if active:
                vals.update({n: v.detach() for n, v in metrics.items()})
            mean = sharding.collective(vals, "data", lambda ops: self._mean(ops, n_active))
        return {"loss": mean["loss"], "lr": lr, "grad_norm": gnorm,
                **{n: mean[n] for n in mean if n != "loss"}}

    def _reduce(self, ops, k, n_active):
        """This slot's blocks of the mean gradient: the blocks of every
        slot that ran, added in slot order."""
        blocks = self._blocks[k]

        def mine(tree):
            return None if tree is None else {n: tree[n][b] for n, b in blocks.items()}

        acc = None
        for j in range(len(ops)):
            g = ops.select(j, mine)
            if g is None:  # a slot that ran no forward
                continue
            acc = {n: x.clone() for n, x in g.items()} if acc is None else \
                {n: a.add_(g[n]) for n, a in acc.items()}
        return {n: a.div_(n_active) for n, a in acc.items()} if n_active > 1 else acc

    def _fill(self, ops, params, k):
        """Copy every other slot's updated blocks into this replica."""
        for j in range(len(ops)):
            if j != k:
                for name, b in ops[j].items():
                    params[name].data[self._block(name, j)].copy_(b)

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


def make_eval_step(model, run):
    """Returns ``eval_step(batch) -> {"loss", "ce", "aux"}``, no gradient."""
    loss_fn = make_loss_fn(model, run)

    def eval_step(batch):
        with torch.no_grad():
            loss, metrics = loss_fn(batch)
        return {"loss": loss, **metrics}

    return eval_step
