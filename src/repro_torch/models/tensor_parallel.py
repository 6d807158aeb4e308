"""Tensor parallelism over the ``model`` axis of a mesh: a model of any
family laid out over ``(data, model)``.

Counterpart of what GSPMD makes of the reference's ``DEFAULT_RULES``
(``heads``, ``kv_heads``, ``mlp``, ``vocab`` and ``ssm_heads`` over
``model``) and its ``constrain`` sites: sharding changes where the work
runs, not what it computes.  Each leaf's block along ``model`` is the
reference's layout with every other axis dropped (``params.
model_shardings``; ``pspec`` leaves a dimension whole where the axis does
not divide it).  One data row's slots along ``model`` form a group of
shards (:class:`DecoderGroup`, :class:`RWKVGroup`, :class:`EncDecGroup`;
a shard of the model a slot, the family's module built with a
``ModelBlock``), run by one host thread as one autograd graph through
``parallel.sharding.ModelGroup``'s operators (Megatron-LM's scheme):

* the embedding is vocab-parallel where ``vocab`` splits: each slot looks
  up its rows (zeros elsewhere) and the addends are reduced;
* attention (an encoder's, a decoder's self- and cross-attention) is a
  block of work where ``heads`` splits: the normed input is handed out,
  each slot projects its query heads, its kv heads (or, where
  ``kv_heads`` stays whole, every kv head, and picks those its query heads
  read: ``layers.select_kv``), attends and projects out a partial, and the
  partials are reduced before the residual add; a decoder layer's cross
  K/V are projected from the replicated encoder output, handed out;
* the MLP likewise over its ``mlp`` block (``wi``/``wg`` columns, ``wo``
  rows); an MoE layer routes on every slot (the same router and groups on
  each, so the slots dispatch the same tokens), hands the grouped tokens
  and the combine weights out, and reduces its experts', shared experts'
  and dense FFN's partials over their ``mlp`` blocks;
* a hybrid layer's SSD branch is a block over its ``mlp`` columns of
  ``d_inner``; where they split a head (``ssm_heads`` stays whole) each
  slot runs the heads its columns touch (``transformer.SSDSel``) and its
  RMS norm adds the slots' sums of squares; the attention beside it runs
  whole on every slot, from the replicated input, where ``heads`` stays
  whole;
* rwkv6's time mix is a block over ``heads`` (64 columns a head: each
  slot's group norm and decay state are its own; a split inside a head is
  refused), its channel mix a block over ``mlp`` beside a receptance gate
  that stays whole;
* the logits are vocab-sharded (:class:`VocabShards`); the train step's
  cross entropy reduces over the blocks (``train_step.cross_entropy``).

A block whose leaves stay whole on ``model`` runs whole on every slot, on
the replicated stream.  A leaf that stays whole but is read inside a block
of work (``q_norm``, ``k_norm``, ``wk``/``wv`` where ``kv_heads`` stays
whole, the SSD's ``wb``/``wc``/``wdt``/``dt0`` where ``ssm_heads`` does,
rwkv6's time-mix ``mu`` and row 0 of its channel-mix ``mu``) gets a
partial gradient on each slot: :meth:`ModelShards.sum_region_grads` adds
them in slot order.  Every other leaf's gradient is its slot's own (a
block) or equal on every slot (a replicated leaf).

:func:`lay_out` gives a :class:`LaidOutModel` (a group a data row; a batch
split over the rows) with ``forward``, ``init_cache`` and ``decode_step``
(an encoder-decoder's ``prefill_encoder`` too), which
``serve/serve_step.py`` serves; ``train/train_step.DataParallelStep``
trains a group a row.  The cards hold only the slots' blocks, as the
reference's GSPMD layout holds only each device's shards: a model on
``meta`` is laid out from a seed (each device draws each whole leaf once,
in float32, and its slots keep their blocks, bit for bit those of the
whole model's draw), from a checkpoint (``train/trainer.Trainer``, each
block read from the files) or from the reference's arrays
(``convert.blocks_from_reference``); a whole model's blocks are copied and
the model itself is not kept.  :meth:`LaidOutModel.gather` builds a whole
model, by default on the CPU, only on request.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R
from repro_torch.models.params import (
    STACKED,
    ModelBlock,
    SpecModule,
    draw_blocks,
    model_shardings,
    tree_paths,
)
from repro_torch.models.registry import model_class, model_spec
from repro_torch.models.transformer import WHOLE_SSD, SSDSel, decode_layer, decoder_layer
from repro_torch.parallel.sharding import ModelGroup, axis_size, constrain, tree_map, tree_shardings


class Layout:
    """Which blocks of ``cfg``'s model split over ``mesh``'s ``model`` axis
    (under ``rules`` over the reference's): ``heads``, ``kv``, ``ffn``,
    ``vocab`` and, for a hybrid, ``ssd`` (its ``d_inner`` columns) and
    ``ssd_heads``; ``region`` lists the whole leaves read inside a block of
    work (``(stacked key, path in a layer, rows or None)``)."""

    def __init__(self, cfg, mesh, rules=None):
        self.cfg, self.mesh, self.rules = cfg, mesh, rules
        self.size = axis_size(mesh, "model")
        spec = model_spec(cfg)
        shapes = {path: tuple(leaf.shape) for path, leaf in tree_paths(spec)}
        shardings = model_shardings(spec, mesh, rules)
        self.split = {path: sh.shard_shape(shapes[path]) != shapes[path]
                      for path, sh in shardings.items()}
        for path, sh in shardings.items():
            if path[0] in STACKED and sh.spec and sh.spec[0] is not None:
                raise NotImplementedError(f"{'/'.join(path)}: layers laid out over 'model'")
        self.vocab = self.split[("embed", "embedding")]
        self.kv = self.ssd = self.ssd_heads = False
        self.region = []
        if cfg.family == "ssm":
            self._rwkv()
        elif cfg.family in ("audio", "encdec"):
            self._encdec()
        else:
            self._decoder()

    def _decoder(self):
        cfg, lay = self.cfg, ("layers",)
        self.heads = self._one(lay + ("attn",), ("wq", "wo"))
        self.kv = self.split[lay + ("attn", "wk")]
        ffn = "moe" if cfg.n_experts else "mlp"
        blocks = {path[2] for path in self.split if path[:2] == lay + (ffn,) and len(path) > 3}
        self.ffn = self._one(lay + (ffn,), ("wi", "wg", "wo"))
        if cfg.n_experts:
            for sub in sorted(blocks):  # shared experts, the dense residual FFN
                if self._one(lay + (ffn, sub), ("wi", "wg", "wo")) != self.ffn:
                    raise NotImplementedError(f"{cfg.name}: the experts and {sub!r} split "
                                              f"differently over 'model'")
        if self.heads:
            self._whole_in(lay + ("attn",))
        if cfg.family == "hybrid":
            self.ssd = self._one(lay + ("ssd",), ("wx", "wz", "norm", "wo"))
            self.ssd_heads = self._one(lay + ("ssd",), ("wb", "wc", "wdt", "dt0"))
            if self.ssd:
                self._whole_in(lay + ("ssd",))

    def _encdec(self):
        parts = (("encoder", "attn"), ("decoder", "attn"), ("decoder", "cross"))
        self.heads = self._one(parts[0], ("wq", "wo"))
        self.kv = self.split[("decoder", "attn", "wk")]
        for part in parts:
            if (self._one(part, ("wq", "wo")), self._one(part, ("wk", "wv"))) != \
                    (self.heads, self.kv):
                raise NotImplementedError(f"{'/'.join(part)}: its heads split differently "
                                          f"over 'model'")
            if self.heads:
                self._whole_in(part)
        self.ffn = self._one(("decoder", "mlp"), ("wi", "wg", "wo"))
        if self._one(("encoder", "mlp"), ("wi", "wg", "wo")) != self.ffn:
            raise NotImplementedError(f"{self.cfg.name}: the encoder's and the decoder's MLPs "
                                      f"split differently over 'model'")

    def _rwkv(self):
        cfg, tm = self.cfg, ("layers", "tm")
        self.heads = self._one(tm, ("wr", "wk", "wv", "wg", "ww", "w0", "ln_x", "wo"))
        if self.heads and not self.split[tm + ("u",)]:
            d, n = cfg.d_model, self.size
            raise NotImplementedError(
                f"{cfg.name}: the time mix's {d} columns ({d // R.HEAD_SIZE} heads of "
                f"{R.HEAD_SIZE}) over a {n}-slot 'model' axis give each slot {d // n} columns, "
                f"splitting a head, whose r.k would be contracted across slots: a layout that "
                f"is not ported")
        self.ffn = self._one(("layers", "cm"), ("wk", "wv"))
        if self.heads:
            self.region.append(("layers", ("tm", "mu"), None))
        if self.ffn:  # row 0 feeds the split wk; row 1 the whole wr, outside the block
            self.region.append(("layers", ("cm", "mu"), slice(0, 1)))

    def _one(self, prefix, names) -> bool:
        got = {self.split[prefix + (n,)] for n in names if prefix + (n,) in self.split}
        if len(got) != 1:
            raise NotImplementedError(f"{'/'.join(prefix)}: its leaves split differently "
                                      f"over 'model'")
        return got.pop()

    def _whole_in(self, prefix):
        self.region += [(prefix[0], path[1:], None) for path in self.split
                        if path[:len(prefix)] == prefix and not self.split[path]]

    def kv_select(self, k: int):
        """What slot ``k`` reads of the kv heads it holds: ``None`` (its
        block, or every head where the query heads are whole too) or the
        ``slice`` of every kv head that its query heads read, each read by
        as many of them."""
        if not self.heads or self.kv or self.cfg.family == "ssm":
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

    def ssd_select(self, k: int) -> SSDSel:
        """Slot ``k``'s share of the hybrid SSD branch: every head of its
        ``wb`` block where the columns split along head boundaries (or not
        at all), else the heads its ``d_inner`` columns fall in, the
        columns of those heads outside its own padded."""
        if not self.ssd or self.ssd_heads:
            return WHOLE_SSD
        hd = self.cfg.head_dim
        cols = self.cfg.ssm_expand * self.cfg.d_model // self.size
        lo, hi = k * cols, (k + 1) * cols
        h0, h1 = lo // hd, -(-hi // hd)
        return SSDSel(slice(h0, h1), (lo - h0 * hd, h1 * hd - hi))


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

class ModelShards(nn.Module):
    """The model slots of one data row (``row``, an index tuple of the
    layout's mesh): ``slots`` holds a shard of the model a slot of
    ``group`` (a ``parallel.sharding.ModelGroup``), each on its slot's
    device, not drawn: :meth:`load` fills them.  Parameter names are
    ``slots.<k>.<the whole model's name>``.  A family's subclass runs the
    forward and the decode step."""

    def __init__(self, cfg, layout: Layout, row=None, dtype=torch.float32):
        super().__init__()
        group = ModelGroup(layout.mesh, row, sizes={
            "vocab": cfg.vocab_padded, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads})
        self.cfg, self.layout, self.group = cfg, layout, group
        self.slots = nn.ModuleList(
            model_class(cfg)(cfg, device=dev, dtype=dtype,
                             block=ModelBlock(layout.mesh, k, layout.rules))
            for k, dev in enumerate(group.devices))
        self.kv_sel = [layout.kv_select(k) for k in range(group.size)]
        self.vocab_width = cfg.vocab_padded // group.size if layout.vocab else 0
        depth = {"layers": cfg.n_layers, "decoder": cfg.n_layers,
                 "encoder": cfg.n_encoder_layers}
        self._region = [(f"{key}.{i}.{'.'.join(path)}", rows)
                        for key, path, rows in layout.region for i in range(depth[key])]

    @property
    def device(self) -> torch.device:
        return self.group.home

    # -- weights ---------------------------------------------------------------
    def slices(self, k: int, name: str) -> tuple:
        """The slices of the whole parameter ``name`` that slot ``k``
        holds."""
        parts = name.split(".")
        if parts[0] in STACKED:  # one layer of a stacked leaf
            return self.slots[k].block_slices[(parts[0], *parts[2:])][1:]
        return self.slots[k].block_slices[tuple(parts)]

    @torch.no_grad()
    def load(self, read):
        """Fill each slot's shard with ``read(name, slices, device)``: the
        block ``slices`` of the whole parameter ``name`` (a tensor on any
        device, best the slot's ``device``, in any float dtype: it is
        copied and cast into the slot)."""
        for k, sl in enumerate(self.slots):
            for name, p in sl.named_parameters():
                p.copy_(read(name, self.slices(k, name), p.device))

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
        (a model of the same config, on ``meta`` too), on the first slot's
        device."""
        out = {n: torch.zeros(p.shape, dtype=p.dtype, device=self.device)
               for n, p in model.named_parameters()}
        for k, sl in enumerate(self.slots):
            for name, p in sl.named_parameters():
                out[name][self.slices(k, name)].copy_(p.grad)
        return out

    @torch.no_grad()
    def sum_region_grads(self):
        """Add the partial gradients of the whole leaves read inside a block
        of work (their partial rows alone where ``rows`` is given) in slot
        order, so every slot holds the sum."""
        for name, rows in self._region:
            params = [sl.get_parameter(name) for sl in self.slots]
            rows = slice(None) if rows is None else rows
            sums = []
            for p in params:
                acc = params[0].grad[rows].to(p.device, copy=True)
                for q in params[1:]:
                    acc.add_(q.grad[rows].to(p.device, non_blocking=True))
                sums.append(acc)
            for p, acc in zip(params, sums):
                p.grad[rows] = acc

    # -- the stream's ends -------------------------------------------------------
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

    def _unembed(self, xs, norm="final_norm") -> "VocabShards":
        """The final norm and the logits, vocab-sharded where ``vocab``
        splits."""
        group, split, cfg = self.group, self.layout.vocab, self.cfg
        xs = group.each(lambda sl, x: L.rmsnorm(getattr(sl, norm), x, cfg.norm_eps),
                        self.slots, xs)
        if split:
            xs = group.handout(xs)

        def logits(sl, x):
            if cfg.tie_embeddings:
                return x @ sl.embed["embedding"].to(x.dtype).T
            return L.unembed(sl.unembed, x)

        out = VocabShards(group, group.each(logits, self.slots, xs), split)
        out.parts = group.each(lambda x: constrain(x, "batch", "seq", "vocab"), out.parts)
        return out

    def _positions(self, xs):
        b, s, _ = xs[0].shape
        return self.group.each(lambda x: torch.arange(s, device=x.device).expand(b, s), xs)

    def _layers(self, key="layers"):
        """Each layer's parameters, one a slot."""
        return [[getattr(sl, key)[i] for sl in self.slots]
                for i in range(len(getattr(self.slots[0], key)))]

    @staticmethod
    def _advance(caches):
        for c in caches:
            c["pos"].add_(1)


class DecoderGroup(ModelShards):
    """A ``Decoder`` (dense, moe, vlm, hybrid) laid out over a data row's
    slots.  Its ``forward`` gives (:class:`VocabShards`, aux on the first
    slot); ``decode_step`` serves from a cache of one dict a slot
    (``LaidOutModel.init_cache``)."""

    def __init__(self, cfg, layout: Layout, row=None, dtype=torch.float32):
        super().__init__(cfg, layout, row, dtype)
        self.ssd_sel = [layout.ssd_select(k) for k in range(self.group.size)]

    def forward(self, tokens, prefix_embeds=None, last_only=False):
        """tokens (B, S) integer and prefix_embeds (B, P, d) or None, on any
        device -> (logits as :class:`VocabShards`, the last position's only
        with ``last_only``; aux on the first slot)."""
        cfg, group = self.cfg, self.group
        xs = self._embed(tokens)
        if prefix_embeds is not None:
            xs = group.each(lambda p, x: torch.cat([p.to(x.dtype), x], dim=1),
                            group.copies(prefix_embeds), xs)
        positions = self._positions(xs)
        xs = group.each(lambda x: constrain(x, "batch", "seq", "embed_act"), xs)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for lps, w in zip(self._layers(), self.slots[0].windows()):
            xs, a = decoder_layer(group, lps, xs, positions, cfg, int(w), self.layout,
                                  self.kv_sel, self.ssd_sel)
            aux = aux + a
        if last_only:
            xs = [x[:, -1:] for x in xs]
        return self._unembed(xs), aux

    def decode_step(self, caches, tokens):
        """tokens (B, 1) against ``caches`` (one a slot, written in place,
        each ``pos`` advanced) -> (:class:`VocabShards`, caches)."""
        cfg, group = self.cfg, self.group
        xs = group.each(lambda x: constrain(x, "batch", "seq", "embed_act"), self._embed(tokens))
        for i, (lps, w) in enumerate(zip(self._layers(), self.slots[0].windows())):
            xs = decode_layer(group, lps, xs, caches, i, cfg, int(w), self.layout, self.kv_sel,
                              self.ssd_sel)
        logits = self._unembed(xs)
        self._advance(caches)
        return logits, caches


class RWKVGroup(ModelShards):
    """An ``RWKV6`` laid out over a data row's slots."""

    def forward(self, tokens, prefix_embeds=None, ssm_chunk=64, last_only=False):
        """As ``RWKV6.forward``: (:class:`VocabShards`, 0.0)."""
        group = self.group
        xs = self._embed(tokens)
        if prefix_embeds is not None:
            xs = group.each(lambda p, x: torch.cat([p.to(x.dtype), x], dim=1),
                            group.copies(prefix_embeds), xs)
        xs = group.each(lambda x: constrain(x, "batch", "seq", "embed_act"), xs)
        for lps in self._layers():
            xs = R.layer(group, lps, xs, self.cfg, self.layout, ssm_chunk)
        if last_only:
            xs = [x[:, -1:] for x in xs]
        return self._unembed(xs), 0.0

    def decode_step(self, caches, tokens):
        """As ``RWKV6.decode_step``, one cache a slot (the shifts whole,
        ``state`` the slot's heads)."""
        xs = [x[:, 0] for x in self._embed(tokens)]
        for i, lps in enumerate(self._layers()):
            xs = R.decode_layer(self.group, lps, xs, caches, i, self.cfg, self.layout)
        logits = self._unembed([x[:, None] for x in xs])
        self._advance(caches)
        return logits, caches


class EncDecGroup(ModelShards):
    """An ``EncDec`` laid out over a data row's slots: the encoder's layers
    and the decoder's, each a ``transformer.decoder_layer``-like body over
    the group; the encoder's output replicated."""

    def encode(self, frames):
        """frames (B, S_enc, d) -> the encoder's output, one copy a slot."""
        cfg, group = self.cfg, self.group
        xs = [x.to(L.compute_dtype(cfg)) for x in group.copies(frames)]
        positions = self._positions(xs)
        xs = group.each(lambda x: constrain(x, "batch", "seq", "embed_act"), xs)
        for lps in self._layers("encoder"):
            xs = E.encoder_layer(group, lps, xs, positions, cfg, self.layout, self.kv_sel)
        return group.each(lambda sl, x: L.rmsnorm(sl.enc_norm, x, cfg.norm_eps), self.slots, xs)

    def forward(self, tokens, frames, last_only=False):
        """Teacher-forced: (:class:`VocabShards`, 0.0)."""
        cfg, group = self.cfg, self.group
        enc = self.encode(frames)
        xs = group.each(lambda x: constrain(x, "batch", "seq", "embed_act"), self._embed(tokens))
        positions = self._positions(xs)
        for lps in self._layers("decoder"):
            xs = E.cross_decoder_layer(group, lps, xs, enc, positions, cfg, self.layout,
                                       self.kv_sel)
        if last_only:
            xs = [x[:, -1:] for x in xs]
        return self._unembed(xs), 0.0

    @torch.no_grad()
    def prefill_encoder(self, caches, frames):
        """Run the encoder once and write each decoder layer's projected
        cross K/V, each slot's kv heads, into its cache."""
        enc = self.encode(frames)
        for i, lps in enumerate(self._layers("decoder")):
            for lp, e, c in zip(lps, enc, caches):
                k, v = E._cross_kv(lp["cross"], e)
                c["cross_k"][i].copy_(k)
                c["cross_v"][i].copy_(v)
        return caches

    def decode_step(self, caches, tokens):
        xs = self._embed(tokens)
        for i, lps in enumerate(self._layers("decoder")):
            xs = E.cross_decoder_layer(self.group, lps, xs, None, None, self.cfg, self.layout,
                                       self.kv_sel, caches=caches, i=i)
        logits = self._unembed(xs)
        self._advance(caches)
        return logits, caches


def model_group(cfg, layout: Layout, row=None, dtype=torch.float32) -> ModelShards:
    """The group of shards of ``cfg``'s family for one data row."""
    if cfg.family == "ssm":
        return RWKVGroup(cfg, layout, row, dtype)
    if cfg.family in ("audio", "encdec"):
        return EncDecGroup(cfg, layout, row, dtype)
    return DecoderGroup(cfg, layout, row, dtype)


# --------------------------------------------------------------------------
# a model laid out over (data, model)
# --------------------------------------------------------------------------

def lay_out(model, mesh, rules=None, seed=0) -> "LaidOutModel":
    """``model`` (a port model of any family) laid out over ``mesh``: a
    group of shards a data row (the same weights on every row).  A model
    on ``meta`` is drawn from ``seed``: each slot holds its blocks of the
    model that ``get_model`` draws from a generator seeded ``seed`` on the
    slot's device (:func:`params.draw_blocks`: one float32 draw of each
    leaf a device, freed before the next); with ``seed=None`` its blocks
    are left unset for the caller to fill (:meth:`LaidOutModel.init`,
    :meth:`LaidOutModel.load`).  A whole model's current
    parameters are copied block by block; the laid-out model keeps no
    reference to it, so a caller that drops it frees it."""
    return LaidOutModel(model, mesh, rules, seed)


def _rows(t, rows):
    return t[rows] if torch.is_tensor(t) else t


class LaidOutModel:
    """A model over a ``(data, model)`` mesh: ``groups`` holds one group
    of shards (:func:`model_group`) a data row (the same weights on every
    row); the cards hold the slots' blocks and nothing whole.

    ``forward``, ``init_cache``, ``prefill_encoder`` and ``decode_step``
    take the whole model's arguments on the mesh's first device and split
    the batch over the data rows where :meth:`rows` says so; else the first
    row runs it whole (and holds the whole cache; the other rows' caches
    are empty).  The logits come back whole on that device.  :meth:`init`
    draws the blocks anew from a seed, :meth:`load` reads them from a
    source of whole parameters (a model, the reference's arrays, a
    checkpoint's files), and :meth:`gather` builds a whole model from the
    first row's blocks.
    """

    def __init__(self, model, mesh, rules=None, seed=0):
        if not isinstance(model, SpecModule) or model.block is not None:
            raise TypeError(f"lay_out takes a whole port model, not {type(model).__name__}")
        self.cfg, self.mesh, self.rules = model.cfg, mesh, rules
        self.param_dtype = model.param_dtype
        self.layout = Layout(model.cfg, mesh, rules)
        rows = mesh.slots("data") if "data" in mesh.shape else [None]
        self.groups = [model_group(model.cfg, self.layout, row, model.param_dtype)
                       for row in rows]
        if model.device.type == "meta":
            if seed is not None:
                self.init(seed)
        else:
            whole = dict(model.named_parameters())
            self.load(lambda name, cut, _device: whole[name][cut])

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    def shards(self) -> list:
        """Every slot's shard, row by row."""
        return [sl for g in self.groups for sl in g.slots]

    def init(self, seed=0):
        """Draw every slot's blocks anew from ``seed``
        (:func:`params.draw_blocks`); returns ``self``."""
        draw_blocks(self.shards(), seed)
        return self

    def load(self, read):
        """Fill every row's slots with ``read(name, slices, device)``, the block
        ``slices`` of the whole parameter ``name`` (``ModelShards.load``);
        returns ``self``."""
        for g in self.groups:
            g.load(read)
        return self

    def gather(self, device="cpu"):
        """A new whole model on ``device`` (default the CPU) holding the
        first row's blocks: for reading the weights out
        (``convert.params_to_reference``), never on a serving or training
        path."""
        whole = model_class(self.cfg).empty(self.cfg, device, self.param_dtype)
        self.groups[0].gather_into(whole)
        return whole

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

    def forward(self, tokens, *extra, **kw):
        """The model's ``forward`` (``extra``: an encoder-decoder's frames;
        ``prefix_embeds``, ``last_only``): (logits (B, S_total, V) whole on
        the first device, or only the last position's with ``last_only``;
        aux, the rows' mean)."""
        pre = kw.get("prefix_embeds")
        seq = tokens.shape[1] + (0 if pre is None else pre.shape[1])
        n = self.rows(len(tokens), seq)
        per = len(tokens) // n
        logits, auxes = [], []
        for d in range(n):
            rows = slice(d * per, (d + 1) * per)
            out, aux = self.groups[d].forward(tokens[rows], *(_rows(e, rows) for e in extra),
                                              **{k: _rows(v, rows) for k, v in kw.items()})
            logits.append(out.gather(self.device))
            auxes.append(aux.to(self.device) if torch.is_tensor(aux) else aux)
        aux = auxes[0]
        for a in auxes[1:]:
            aux = aux + a
        return torch.cat(logits) if n > 1 else logits[0], (aux / n if n > 1 else aux)

    def cache_axes(self):
        return self.groups[0].slots[0].cache_axes()

    def init_cache(self, batch, max_len, dtype=torch.bfloat16, **kw):
        """Zeroed caches laid out over the mesh by ``cache_axes``: each leaf
        an object array shaped as the mesh's devices, one slot's block each
        (``kv_heads`` and ``ssm_heads`` split over ``model`` where they
        divide, else whole on every slot; a hybrid's SSD state the heads
        its ``d_inner`` columns touch; ``cache_batch`` over the data rows
        where :meth:`rows` splits a decode step's batch, else whole on the
        first row and empty, a batch of 0, on the others).  ``kw``: the
        model's own (an encoder-decoder's ``enc_len``)."""
        split = self.rows(batch, 1) > 1
        rules = self.rules if split else {**(self.rules or {}), "cache_batch": None}
        axes = self.cache_axes()
        a = self.mesh.axis_names.index("model") if "model" in self.mesh.shape else None
        first = set(self.groups[0].group.indices)
        out = None
        for index in np.ndindex(self.mesh.devices.shape):
            k = 0 if a is None else index[a]
            sl = self.groups[0].slots[k]  # its init_cache reads the config alone
            whole = sl.init_cache(batch, max_len, dtype=dtype, device=self.mesh.devices[index],
                                  **kw)
            sh = tree_shardings(whole, axes, self.mesh, rules)
            ssd = self.layout.ssd_select(k)

            def block(t, s, ax):
                cut = list(s.block(index, tuple(t.shape)))
                if self.cfg.family == "hybrid" and ssd.heads is not None \
                        and "ssm_heads" in ax.axes:
                    cut[ax.axes.index("ssm_heads")] = ssd.heads
                if not (split or index in first):
                    cut[ax.axes.index("cache_batch")] = slice(0, 0)
                return t[tuple(cut)].clone(memory_format=torch.contiguous_format)

            mine = tree_map(block, whole, sh, axes)
            del whole
            if out is None:
                out = tree_map(lambda t: np.empty(self.mesh.devices.shape, dtype=object), mine)
            tree_map(lambda arr, t: arr.__setitem__(index, t), out, mine)
        return out

    def _slot_caches(self, cache, group) -> list:
        return [tree_map(lambda arr: arr[i], cache) for i in group.group.indices]

    def prefill_encoder(self, cache, frames):
        """An encoder-decoder's encoder over ``frames``, each decoder
        layer's cross K/V written into every slot's cache."""
        n = self.rows(len(frames), 1)
        per = len(frames) // n
        for d in range(n):
            g = self.groups[d]
            g.prefill_encoder(self._slot_caches(cache, g), frames[d * per:(d + 1) * per])
        return cache

    def decode_step(self, cache, tokens):
        """tokens (B, 1) -> (logits (B, 1, V) whole on the first device,
        cache), each slot's cache written in place."""
        n = self.rows(len(tokens), 1)
        per = len(tokens) // n
        logits = []
        for d in range(n):
            g = self.groups[d]
            out, _ = g.decode_step(self._slot_caches(cache, g), tokens[d * per:(d + 1) * per])
            logits.append(out.gather(self.device))
        return (torch.cat(logits) if n > 1 else logits[0]), cache
