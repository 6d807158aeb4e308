"""Minimal parameter-spec system: shapes + logical axes + init.

Counterpart of the reference's ``models/params.py``.  A model is described
by a nested dict of ``P`` leaves.  From the same spec tree we derive:
  * materialised parameters  (``init_params``, drawn from an explicit
    ``torch.Generator``)
  * abstract parameters      (``abstract_params``: tensors on the ``meta``
    device, shapes and dtypes with no allocation)
  * logical axes             (``axes_tree``; ``parallel.sharding.pspec``
    maps them to mesh axes)

A model's spec stacks its layers on a leading axis (``layers``,
``encoder``, ``decoder``: :data:`STACKED`), as the reference's
``lax.scan`` reads them.  The port's modules hold one :class:`ParamTree`
per layer instead, each leaf with the unstacked shape, in an
``nn.ModuleList``; :class:`SpecModule` maps between the two.

A :class:`SpecModule` built with a :class:`ModelBlock` is one shard of the
model: it holds one ``model``-axis slot's block of each leaf
(:func:`model_shardings`: the reference's layout with every axis but
``model`` dropped), drawn as the block of the whole model's draw
(:func:`draw_blocks`).  A :class:`SpecModule` on the ``meta`` device holds
no parameters: its config, spec, names and shapes stand for the model, as
the reference's stateless model object does, where a model is laid out
over a mesh (``models/tensor_parallel.lay_out``) or trained over one.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.core.dispatcher import resolve_device

# spec keys whose leaves carry a leading per-layer axis
STACKED = ("layers", "encoder", "decoder")


class P(NamedTuple):
    shape: tuple
    axes: tuple  # logical axis name per dim (or None)
    init: str = "normal"  # normal | zeros | ones

    def with_leading(self, n: int, axis_name: str | None = "layers"):
        return P((n, *self.shape), (axis_name, *self.axes), self.init)


class ModelBlock(NamedTuple):
    """One slot of a mesh's ``model`` axis: ``k``, its index along the axis,
    under ``rules`` over the reference's."""

    mesh: object
    k: int
    rules: dict | None = None


def model_shardings(spec, mesh, rules=None) -> dict:
    """For each path of ``spec``, the layout of its leaf over ``mesh``'s
    ``model`` axis alone: ``parallel.sharding.param_shardings``'s spec with
    every other mesh axis dropped (a dimension split over several axes
    keeps ``model`` only where it is the outermost, so that the block holds
    the finer blocks of the other axes)."""
    from repro_torch.parallel import sharding

    flat = {}
    for path, leaf in tree_paths(spec):
        full = sharding.pspec(leaf.axes, rules=dict(sharding.DEFAULT_RULES, **(rules or {})),
                              mesh=mesh, shape=leaf.shape)
        parts = []
        for entry in full:
            axes = sharding._axes_of(entry)
            if "model" in axes[1:]:
                raise NotImplementedError(f"{'/'.join(path)}: {full!r} splits a dimension over "
                                          f"'model' inside another axis")
            parts.append("model" if axes[:1] == ("model",) else None)
        flat[path] = sharding.NamedSharding(mesh, sharding.PartitionSpec(*parts))
    return flat


def block_slices(spec, block: ModelBlock) -> dict:
    """For each path of ``spec``, the slices of its whole leaf that the
    ``model`` slot ``block`` holds."""
    mesh = block.mesh
    index = tuple(block.k if a == "model" else 0 for a in mesh.axis_names)
    return {path: sh.block(index, tuple(get_path(spec, path).shape))
            for path, sh in model_shardings(spec, mesh, block.rules).items()}


def is_leaf(x):
    return isinstance(x, P)


def tree_paths(spec):
    """Deterministic (path, leaf) list."""
    out = []

    def rec(node, path):
        if is_leaf(node):
            out.append((path, node))
            return
        for k in sorted(node):
            rec(node[k], path + (k,))

    rec(spec, ())
    return out


def stack_spec(one: dict, n: int) -> dict:
    """``one`` layer's spec with a leading axis of ``n`` on every leaf."""
    return _unflatten({path: leaf.with_leading(n) for path, leaf in tree_paths(one)})


def model_device(device) -> torch.device:
    """A model's device: ``meta`` (a model that holds no parameters), else
    ``resolve_device``'s (default ``'cuda'``)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _draw(leaf: P, generator: torch.Generator, device):
    """The whole leaf's float32 draw on ``device`` (the reference's law:
    normal / sqrt(fan_in), fan_in from the stacked leaf); ``None`` for a
    constant leaf, which draws nothing."""
    if leaf.init in ("zeros", "ones"):
        return None
    fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
    std = 1.0 / math.sqrt(max(1, fan_in))
    x = torch.randn(leaf.shape, generator=generator, dtype=torch.float32, device=device)
    return x.mul_(std)


def _init_one(leaf: P, generator: torch.Generator, dtype, device):
    x = _draw(leaf, generator, device)
    if x is None:
        return torch.full(leaf.shape, float(leaf.init == "ones"), dtype=dtype, device=device)
    return x.to(dtype)


@torch.no_grad()
def draw_blocks(modules: list, seed: int):
    """Draw the whole model's leaves from ``seed`` into ``modules`` (whole
    models or shards of one config, each keeping its block): each device
    draws every leaf once, in :func:`tree_paths` order, from a generator on
    it seeded ``seed``, as :meth:`SpecModule.init` does, and every module on
    that device copies its block of the float32 draw, cast to its dtype.
    The draw is freed before the next leaf, so a device's peak is what its
    modules hold plus one leaf's float32 draw."""
    by_device: dict = {}
    for m in modules:
        by_device.setdefault(m.device, []).append(m)
    gens = {dev: torch.Generator(device=dev).manual_seed(seed) for dev in by_device}
    for path, leaf in tree_paths(modules[0].whole_spec()):
        for dev, mods in by_device.items():
            x = _draw(leaf, gens[dev], dev)
            for m in mods:
                m.fill_leaf(path, leaf, x)
            del x


def init_params(spec, generator: torch.Generator, dtype=torch.float32, device=None):
    """Materialised parameters of ``spec`` (a nested dict of tensors), drawn
    leaf by leaf in :func:`tree_paths` order from ``generator``, which lives
    on ``device`` (default ``'cuda'``)."""
    device = resolve_device(device)
    flat = {path: _init_one(leaf, generator, dtype, device) for path, leaf in tree_paths(spec)}
    return _unflatten(flat)


def abstract_params(spec, dtype=torch.float32):
    """Shapes and dtypes of ``spec``'s parameters as ``meta`` tensors."""
    flat = {path: torch.empty(leaf.shape, dtype=dtype, device="meta")
            for path, leaf in tree_paths(spec)}
    return _unflatten(flat)


def axes_tree(spec):
    flat = {path: leaf.axes for path, leaf in tree_paths(spec)}
    return _unflatten(flat)


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return root


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def map_with_axes(fn, params, spec):
    """Map ``fn(param_leaf, logical_axes)`` over a params tree."""
    return _unflatten({path: fn(get_path(params, path), leaf.axes)
                       for path, leaf in tree_paths(spec)})


class ParamTree(nn.Module):
    """The parameters of one nested spec dict, each leaf an ``nn.Parameter``
    of its shape, each inner dict a child ``ParamTree``.  ``tree[key]`` reads
    a leaf or a child, so the layer functions take a ``ParamTree`` where the
    reference's take a dict."""

    def __init__(self, spec: dict, device, dtype):
        super().__init__()
        for k in sorted(spec):
            v = spec[k]
            if is_leaf(v):
                self.register_parameter(
                    k, nn.Parameter(torch.empty(v.shape, dtype=dtype, device=device)))
            else:
                self.add_module(k, ParamTree(v, device, dtype))

    def __getitem__(self, key):
        return getattr(self, key)


def _unstacked(stacked: dict) -> dict:
    return _unflatten({path: P(leaf.shape[1:], leaf.axes[1:], leaf.init)
                       for path, leaf in tree_paths(stacked)})


class SpecModule(nn.Module):
    """A model whose parameters follow its config's spec.

    A subclass sets ``build_spec`` (``cfg`` -> the reference's spec, layers
    stacked; :meth:`spec` applies it to the model's config).  Each
    top-level key becomes an attribute: a :class:`ParamTree`, or for the
    keys of :data:`STACKED` an ``nn.ModuleList`` of one ``ParamTree`` a
    layer with the unstacked shapes.  Parameters are stored in ``dtype``
    (default float32, as the reference's ``init``) on ``device`` (default
    ``'cuda'``; ``'cpu'`` on request) and drawn from ``generator`` (default:
    one seeded 0 on that device); compute runs in ``cfg.dtype``.  On
    ``'meta'`` the module holds no parameters and draws nothing: it stands
    for the model where one is laid out or trained over a mesh.  The
    layers run in a Python loop over the ``ModuleList``, the counterpart of
    the reference's ``scan_or_unroll``, so ``cfg.scan_layers`` is ignored;
    under ``cfg.remat`` a forward that records a gradient recomputes each
    layer's activations in the backward pass (``layers.remat``), and a
    forward without one (serving) is unchanged.

    With ``block`` (a :class:`ModelBlock`) the module is that ``model``
    slot's shard: :meth:`spec` gives the block shapes, each parameter holds
    its block (``block_slices``), left unset (``torch.empty``) for its
    caller to fill; :meth:`init` (or :func:`draw_blocks`, once a device
    for many shards) draws the whole model's leaves and keeps the blocks.
    """

    build_spec = None

    def __init__(self, cfg, device=None, dtype=torch.float32, generator=None, block=None):
        super().__init__()
        self.cfg = cfg
        self.device = model_device(device)
        self.param_dtype = dtype
        self.block = block
        self.block_slices = None if block is None else block_slices(self.whole_spec(), block)
        for key, node in self.spec().items():
            if key in STACKED:
                one = _unstacked(node)
                n = tree_paths(node)[0][1].shape[0]
                self.add_module(key, nn.ModuleList(
                    ParamTree(one, self.device, dtype) for _ in range(n)))
            else:
                self.add_module(key, ParamTree(node, self.device, dtype))
        if block is not None or self.device.type == "meta":  # filled by its caller
            return
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init(generator)

    @classmethod
    def empty(cls, cfg, device=None, dtype=torch.float32):
        """A whole model with its parameters allocated on ``device`` and
        left unset, for its caller to fill."""
        model = cls(cfg, device="meta", dtype=dtype).to_empty(device=resolve_device(device))
        model.device = resolve_device(device)
        return model

    def meta(self):
        """A model of the same config, dtype and block on ``meta``: the
        names and shapes, no parameters."""
        return type(self)(self.cfg, device="meta", dtype=self.param_dtype, block=self.block)

    def whole_spec(self) -> dict:
        """The reference's spec of the whole model (layers stacked)."""
        return self.build_spec(self.cfg)

    def spec(self) -> dict:
        """The spec of what this module holds: the whole model's, or one
        ``model`` slot's blocks."""
        whole = self.whole_spec()
        if self.block is None:
            return whole
        return _unflatten({path: P(tuple(s.stop - s.start for s in self.block_slices[path]),
                                   leaf.axes, leaf.init)
                           for path, leaf in tree_paths(whole)})

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """Draw every parameter anew from ``generator`` (on the model's
        device), leaf by leaf as :func:`init_params` (a shard keeps its
        blocks of the whole leaves, sliced from the float32 draw before the
        cast); returns ``self``."""
        for path, leaf in tree_paths(self.whole_spec()):
            self.fill_leaf(path, leaf, _draw(leaf, generator, self.device))
        return self

    @torch.no_grad()
    def fill_leaf(self, path: tuple, leaf: P, draw):
        """Set the parameter(s) at ``path`` from ``draw``, the whole
        (stacked) leaf's float32 draw, or from ``leaf``'s constant where
        ``draw`` is ``None``; a shard takes its block."""
        if draw is None:
            target = self.leaf(path)
            for p in target if isinstance(target, list) else [target]:
                p.fill_(float(leaf.init == "ones"))
            return
        self.load_leaf(path, draw if self.block is None else draw[self.block_slices[path]])

    def leaf(self, path: tuple):
        """The parameter at a spec path; for a stacked path the list of the
        layers' parameters."""
        node = getattr(self, path[0])
        if path[0] in STACKED:
            return [get_path(layer, path[1:]) for layer in node]
        return get_path(node, path[1:])

    @torch.no_grad()
    def load_leaf(self, path: tuple, value: torch.Tensor):
        """Copy ``value``, shaped as the spec's (stacked) leaf, into the
        parameter(s) at ``path``."""
        target = self.leaf(path)
        if isinstance(target, list):
            if value.shape[0] != len(target) or tuple(value.shape[1:]) != tuple(target[0].shape):
                raise ValueError(f"{'/'.join(path)}: shape {tuple(value.shape)} against "
                                 f"{len(target)} x {tuple(target[0].shape)}")
            for p, v in zip(target, value):
                p.copy_(v)
        else:
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{'/'.join(path)}: shape {tuple(value.shape)} against "
                                 f"{tuple(target.shape)}")
            target.copy_(value)
