"""Tensor parallelism over the ``model`` axis of a mesh: a ``Decoder`` of the
``dense``, ``moe`` and ``vlm`` families laid out over ``(data, model)``.

Counterpart of what GSPMD makes of the reference's ``DEFAULT_RULES``
(``heads``, ``kv_heads``, ``mlp`` and ``vocab`` over ``model``) and its
``constrain`` sites: sharding changes where the work runs, not what it
computes.  Each leaf's block along ``model`` is the reference's layout
with every other axis dropped (``params.model_shardings``; ``pspec`` leaves
a dimension whole where the axis does not divide it).  One data row's
slots along ``model`` form a :class:`DecoderGroup`: a shard of the model a
slot (``Decoder(..., block=ModelBlock(...))``), run by one host thread as
one autograd graph through ``parallel.sharding.ModelGroup``'s operators
(Megatron-LM's scheme):

* the embedding is vocab-parallel where ``vocab`` splits: each slot looks
  up its rows (zeros elsewhere) and the addends are reduced;
* attention is a block of work where ``heads`` splits: the normed input is
  handed out, each slot projects its query heads, its kv heads (or, where
  ``kv_heads`` stays whole, every kv head, and picks those its query heads
  read: ``layers.select_kv``), attends and projects out a partial, and the
  partials are reduced before the residual add;
* the MLP likewise over its ``mlp`` block (``wi``/``wg`` columns, ``wo``
  rows); an MoE layer routes on every slot (the same router and groups on
  each, so the slots dispatch the same tokens), hands the grouped tokens
  and the combine weights out, and reduces its experts', shared experts'
  and dense FFN's partials over their ``mlp`` blocks;
* the logits are vocab-sharded (:class:`VocabShards`); the train step's
  cross entropy reduces over the blocks (``train_step.cross_entropy``).

A block whose leaves stay whole on ``model`` runs whole on every slot, on
the replicated stream.  A leaf that stays whole but is read inside a block
of work (``q_norm``, ``k_norm``, and ``wk``/``wv`` where ``kv_heads`` stays
whole) gets a partial gradient on each slot: :meth:`DecoderGroup.
sum_region_grads` adds them in slot order.  Every other leaf's gradient is
its slot's own (a block) or equal on every slot (a replicated leaf).

:func:`lay_out` gives a :class:`LaidOutModel` (a group a data row; a batch
split over the rows) with ``forward``, ``init_cache`` and ``decode_step``,
which ``serve/serve_step.py`` serves; ``train/train_step.DataParallelStep``
trains a group a row.  The ``hybrid`` (hymba), ``ssm`` (rwkv6) and
``audio``/``encdec`` (seamless) families raise ``NotImplementedError``:
ROADMAP.md Queue 1 item 5.3(b).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.params import ModelBlock, model_shardings, tree_paths
from repro_torch.models.transformer import Decoder, decode_layer, decoder_layer, decoder_spec
from repro_torch.parallel.sharding import Ax, ModelGroup, axis_size, constrain, tree_shardings

FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg):
    """Raise ``NotImplementedError`` for a family whose layout over the
    ``model`` axis is not ported: each needs reductions of its own."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): tensor parallelism over the 'model' axis covers the "
            f"{', '.join(FAMILIES)} families; hymba's SSD norm, rwkv6's time mix and seamless's "
            f"cross-attention are ROADMAP.md Queue 1 item 5.3(b)")


class Layout:
    """Which blocks of ``cfg``'s Decoder split over ``mesh``'s ``model``
    axis (under ``rules`` over the reference's)."""

    def __init__(self, cfg, mesh, rules=None):
        check_family(cfg)
        self.cfg, self.mesh, self.rules = cfg, mesh, rules
        self.size = axis_size(mesh, "model")
        spec = decoder_spec(cfg)
        shapes = {path: tuple(leaf.shape) for path, leaf in tree_paths(spec)}
        shardings = model_shardings(spec, mesh, rules)
        self.split = {path: sh.shard_shape(shapes[path]) != shapes[path]
                      for path, sh in shardings.items()}
        for path, sh in shardings.items():
            if path[0] == "layers" and sh.spec and sh.spec[0] is not None:
                raise NotImplementedError(f"{'/'.join(path)}: layers laid out over 'model'")
        lay = ("layers",)
        self.heads = self.split[lay + ("attn", "wq")]
        self.kv = self.split[lay + ("attn", "wk")]
        self.vocab = self.split[("embed", "embedding")]
        ffn = "moe" if cfg.n_experts else "mlp"
        blocks = {path[2] for path in self.split if path[:2] == lay + (ffn,) and len(path) > 3}
        self.ffn = self._one(lay + (ffn,), ("wi", "wg", "wo"))
        if cfg.n_experts:
            for sub in sorted(blocks):  # shared experts, the dense residual FFN
                if self._one(lay + (ffn, sub), ("wi", "wg", "wo")) != self.ffn:
                    raise NotImplementedError(f"{cfg.name}: the experts and {sub!r} split "
                                              f"differently over 'model'")
        if self.heads != self.split[lay + ("attn", "wo")]:
            raise NotImplementedError(f"{cfg.name}: wq and wo split differently over 'model'")
        # whole leaves read inside a block of work: their gradients are partial
        self.region_whole = tuple(path[1:] for path in self.split
                                  if self.heads and path[:2] == lay + ("attn",)
                                  and not self.split[path])

    def _one(self, prefix, names) -> bool:
        got = {self.split[prefix + (n,)] for n in names if prefix + (n,) in self.split}
        if len(got) != 1:
            raise NotImplementedError(f"{'/'.join(prefix)}: its leaves split differently "
                                      f"over 'model'")
        return got.pop()

    def kv_select(self, k: int):
        """What slot ``k`` reads of the kv heads it holds: ``None`` (its
        block, or every head where the query heads are whole too) or the
        ``slice`` of every kv head that its query heads read, each read by
        as many of them."""
        if not self.heads or self.kv:
            return None
        h, kh = self.cfg.n_heads, self.cfg.n_kv_heads
        g, hl = h // kh, h // self.size
        idx = [(k * hl + j) // g for j in range(hl)]
        lo, n = idx[0], idx[-1] - idx[0] + 1
        if hl % n or idx != [lo + j // (hl // n) for j in range(hl)]:
            raise NotImplementedError(
                f"{self.cfg.name}: slot {k} of {self.size} holds query heads that read kv heads "
                f"{idx} unevenly: a grouping of heads over 'model' that is not ported")
        return slice(lo, lo + n)


class VocabShards:
    """Logits split over the vocabulary: one block a slot of ``group`` (the
    slot's columns, from ``k * width``), or, where the vocabulary stays
    whole, the whole logits on every slot (``split`` false).  Indexing
    applies to every block (leading dimensions only)."""

    def __init__(self, group: ModelGroup, parts: list, split: bool):
        self.group, self.parts, self.split = group, list(parts), split

    def __getitem__(self, index):
        return VocabShards(self.group, [p[index] for p in self.parts], self.split)

    def gather(self, device=None) -> torch.Tensor:
        """The whole logits on ``device`` (default the first slot's)."""
        if self.split:
            return self.group.gather(self.parts, -1, device)
        out = self.parts[0]
        return out if device is None or out.device == device else out.to(device)


# --------------------------------------------------------------------------
# one data row's model group
# --------------------------------------------------------------------------

class DecoderGroup(nn.Module):
    """The model slots of one data row (``row``, an index tuple of the
    layout's mesh): ``slots`` holds a ``Decoder`` shard a slot of ``group``
    (a ``parallel.sharding.ModelGroup``), each on its
    slot's device, not drawn: :meth:`load_from` fills them.
    Its ``forward`` gives (:class:`VocabShards`, aux on the first slot);
    ``decode_step`` serves from a cache of one dict a slot
    (``LaidOutModel.init_cache``).
    Parameter names are ``slots.<k>.<the whole model's name>``."""

    def __init__(self, cfg, layout: Layout, row=None, dtype=torch.float32):
        super().__init__()
        group = ModelGroup(layout.mesh, row, sizes={
            "vocab": cfg.vocab_padded, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads})
        self.cfg, self.layout, self.group = cfg, layout, group
        self.slots = nn.ModuleList(
            Decoder(cfg, device=dev, dtype=dtype, block=ModelBlock(layout.mesh, k, layout.rules))
            for k, dev in enumerate(group.devices))
        self.kv_sel = [layout.kv_select(k) for k in range(group.size)]
        self.vocab_width = cfg.vocab_padded // group.size if layout.vocab else 0
        self._region = [f"layers.{i}.{'.'.join(p)}" for i in range(cfg.n_layers)
                        for p in layout.region_whole]

    @property
    def device(self) -> torch.device:
        return self.group.home

    # -- weights ---------------------------------------------------------------
    def slices(self, k: int, name: str) -> tuple:
        """The slices of the whole parameter ``name`` that slot ``k``
        holds."""
        parts = name.split(".")
        if parts[0] == "layers":  # one layer of a stacked leaf
            return self.slots[k].block_slices[(parts[0], *parts[2:])][1:]
        return self.slots[k].block_slices[tuple(parts)]

    @torch.no_grad()
    def load_from(self, model):
        """Copy each slot's blocks of ``model``'s parameters (a whole
        model of the same config) into the slot's shard."""
        whole = dict(model.named_parameters())
        for k, sl in enumerate(self.slots):
            for name, p in sl.named_parameters():
                p.copy_(whole[name][self.slices(k, name)])

    @torch.no_grad()
    def gather_into(self, model):
        """Copy every slot's blocks into ``model``'s whole parameters."""
        whole = dict(model.named_parameters())
        for k, sl in enumerate(self.slots):
            for name, p in sl.named_parameters():
                whole[name][self.slices(k, name)].copy_(p)

    @torch.no_grad()
    def gathered_grads(self, model) -> dict:
        """The slots' gradients as whole tensors by the names of ``model``
        (a whole model of the same config), on the first slot's device."""
        out = {n: torch.zeros(p.shape, dtype=p.dtype, device=self.device)
               for n, p in model.named_parameters()}
        for k, sl in enumerate(self.slots):
            for name, p in sl.named_parameters():
                out[name][self.slices(k, name)].copy_(p.grad)
        return out

    @torch.no_grad()
    def sum_region_grads(self):
        """Add the partial gradients of the whole leaves read inside a block
        of work in slot order, so every slot holds the sum."""
        for name in self._region:
            grads = [sl.get_parameter(name).grad for sl in self.slots]
            for sl in self.slots:
                p = sl.get_parameter(name)
                acc = grads[0].to(p.device, copy=True)
                for g in grads[1:]:
                    acc.add_(g.to(p.device, non_blocking=True))
                p.grad = acc

    # -- forward ---------------------------------------------------------------
    def _embed(self, tokens):
        group = self.group
        toks = group.copies(tokens)
        if self.layout.vocab:
            w = self.vocab_width
            xs = group.reduce(group.each(lambda sl, t, k: L.embed_block(sl.embed, t, k * w),
                                         self.slots, toks, range(group.size)))
        else:
            xs = group.each(lambda sl, t: L.embed(sl.embed, t), self.slots, toks)
        dt = L.compute_dtype(self.cfg)
        return [x.to(dt) for x in xs]

    def _unembed(self, xs) -> VocabShards:
        group, split = self.group, self.layout.vocab
        if split:
            xs = group.handout(xs)
        return VocabShards(group, group.each(lambda sl, x: sl._unembed(x), self.slots, xs), split)

    def forward(self, tokens, prefix_embeds=None, last_only=False):
        """tokens (B, S) integer and prefix_embeds (B, P, d) or None, on any
        device -> (logits as :class:`VocabShards`, the last position's only
        with ``last_only``; aux on the first slot)."""
        cfg, group = self.cfg, self.group
        xs = self._embed(tokens)
        if prefix_embeds is not None:
            xs = group.each(lambda p, x: torch.cat([p.to(x.dtype), x], dim=1),
                            group.copies(prefix_embeds), xs)
        b, s, _ = xs[0].shape
        positions = group.each(lambda x: torch.arange(s, device=x.device).expand(b, s), xs)
        xs = group.each(lambda x: constrain(x, "batch", "seq", "embed_act"), xs)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, w in enumerate(self.slots[0].windows()):
            lps = [sl.layers[i] for sl in self.slots]
            xs, a = decoder_layer(group, lps, xs, positions, cfg, int(w), self.layout, self.kv_sel)
            aux = aux + a
        if last_only:
            xs = [x[:, -1:] for x in xs]
        xs = group.each(lambda sl, x: L.rmsnorm(sl.final_norm, x, cfg.norm_eps), self.slots, xs)
        logits = self._unembed(xs)
        logits.parts = group.each(lambda x: constrain(x, "batch", "seq", "vocab"), logits.parts)
        return logits, aux

    # -- decode ------------------------------------------------------------------
    def decode_step(self, caches, tokens):
        """tokens (B, 1) against ``caches`` (one ``{"k", "v", "pos"}`` a slot,
        written in place, each ``pos`` advanced) -> (:class:`VocabShards`,
        caches)."""
        cfg, group = self.cfg, self.group
        xs = group.each(lambda x: constrain(x, "batch", "seq", "embed_act"), self._embed(tokens))
        for i in range(cfg.n_layers):
            lps = [sl.layers[i] for sl in self.slots]
            xs = decode_layer(group, lps, xs, caches, i, cfg, self.layout, self.kv_sel)
        xs = group.each(lambda sl, x: L.rmsnorm(sl.final_norm, x, cfg.norm_eps), self.slots, xs)
        logits = self._unembed(xs)
        for c in caches:
            c["pos"].add_(1)
        return logits, caches


# --------------------------------------------------------------------------
# a model laid out over (data, model)
# --------------------------------------------------------------------------

def lay_out(model, mesh, rules=None) -> "LaidOutModel":
    """``model`` (a whole port ``Decoder`` of the dense, moe or vlm family)
    laid out over ``mesh``: a :class:`DecoderGroup` a data row, each slot
    holding its blocks of ``model``'s current parameters."""
    return LaidOutModel(model, mesh, rules)


class LaidOutModel:
    """A ``Decoder`` over a ``(data, model)`` mesh: ``groups`` holds one
    :class:`DecoderGroup` a data row (the same weights on every row).

    ``forward``, ``init_cache`` and ``decode_step`` take the whole model's
    arguments on the mesh's first device and split the batch over the
    data rows where :meth:`rows` says so; else the first row runs it whole
    (and holds the whole cache; the other rows' caches are empty).  The
    logits come back
    whole on that device.  ``model`` is the whole model laid out, kept on
    its device: :meth:`gather` copies the first row's blocks back into it,
    :meth:`place` copies its parameters into every row.  So a model is laid
    out only where its whole parameters fit on that device (ROADMAP.md
    Queue 1 item 5.3(b)).
    """

    def __init__(self, model, mesh, rules=None):
        if not isinstance(model, Decoder) or model.block is not None:
            check_family(model.cfg)
            raise TypeError(f"lay_out takes a whole Decoder, not {type(model).__name__}")
        self.model, self.cfg, self.mesh, self.rules = model, model.cfg, mesh, rules
        self.layout = Layout(model.cfg, mesh, rules)
        rows = mesh.slots("data") if "data" in mesh.shape else [None]
        self.groups = [DecoderGroup(model.cfg, self.layout, row, model.param_dtype)
                       for row in rows]
        self.place()

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    def place(self):
        """Copy ``model``'s parameters into every row's slots."""
        for g in self.groups:
            g.load_from(self.model)
        return self

    def gather(self):
        """``model`` with the first row's blocks copied back in."""
        self.groups[0].gather_into(self.model)
        return self.model

    def rows(self, batch: int, seq: int) -> int:
        """How many data rows run ``batch`` rows of ``seq`` tokens: every
        row where the rows divide the batch and, for an MoE model, each
        row routes a multiple of ``moe_group_size`` tokens (so that its
        dispatch groups, and their capacity, are the whole batch's);
        else 1, the first row running the batch whole."""
        n, cfg = len(self.groups), self.cfg
        if batch % n or (cfg.n_experts and batch // n * seq % cfg.moe_group_size):
            return 1
        return n

    def forward(self, tokens, prefix_embeds=None, last_only=False):
        """(logits (B, S_total, V) whole on the first device, or only the
        last position's with ``last_only``; aux, the rows' mean)."""
        seq = tokens.shape[1] + (0 if prefix_embeds is None else prefix_embeds.shape[1])
        n = self.rows(len(tokens), seq)
        per = len(tokens) // n
        logits, auxes = [], []
        for d in range(n):
            rows = slice(d * per, (d + 1) * per)
            pre = None if prefix_embeds is None else prefix_embeds[rows]
            out, aux = self.groups[d].forward(tokens[rows], pre, last_only)
            logits.append(out.gather(self.device))
            auxes.append(aux.to(self.device))
        aux = auxes[0]
        for a in auxes[1:]:
            aux = aux + a
        return torch.cat(logits) if n > 1 else logits[0], (aux / n if n > 1 else aux)

    def cache_axes(self):
        kv = Ax(("layers", "cache_batch", "cache_seq", "kv_heads", "head_dim"))
        return {"k": kv, "v": kv, "pos": Ax(("cache_batch",))}

    def init_cache(self, batch, max_len, dtype=torch.bfloat16):
        """Zeroed caches laid out over the mesh by ``cache_axes``: each leaf
        an object array shaped as the mesh's devices, one slot's block each
        (``kv_heads`` split over ``model`` where it divides, else every kv
        head on every slot; ``cache_batch`` over the data rows where
        :meth:`rows` splits a decode step's batch, else whole on the first
        row and empty, a batch of 0, on the others)."""
        cfg = self.cfg
        kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        whole = {"k": kv, "v": kv, "pos": (batch,)}
        split = self.rows(batch, 1) > 1
        rules = self.rules if split else {**(self.rules or {}), "cache_batch": None}
        sh = tree_shardings({k: torch.empty(v, device="meta") for k, v in whole.items()},
                            self.cache_axes(), self.mesh, rules)
        first = set(self.groups[0].group.indices)
        out = {}
        for name, s in sh.items():
            arr = np.empty(self.mesh.devices.shape, dtype=object)
            for index in np.ndindex(arr.shape):
                shape = list(s.shard_shape(whole[name]))
                if not (split or index in first):
                    shape[1 if name in ("k", "v") else 0] = 0
                arr[index] = torch.zeros(shape, dtype=torch.int64 if name == "pos" else dtype,
                                         device=self.mesh.devices[index])
            out[name] = arr
        return out

    def decode_step(self, cache, tokens):
        """tokens (B, 1) -> (logits (B, 1, V) whole on the first device,
        cache), each slot's cache written in place."""
        n = self.rows(len(tokens), 1)
        per = len(tokens) // n
        logits = []
        for d in range(n):
            g = self.groups[d]
            slots = [{k: cache[k][i] for k in ("k", "v", "pos")} for i in g.group.indices]
            out, _ = g.decode_step(slots, tokens[d * per:(d + 1) * per])
            logits.append(out.gather(self.device))
        return (torch.cat(logits) if n > 1 else logits[0]), cache

