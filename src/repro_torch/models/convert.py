"""Weights and training state to and from the reference's trees.

The reference's ``model.init(key)`` gives a nested dict whose leaves stack
the layers on a leading axis (``layers``, ``encoder``, ``decoder``); the
port's modules hold one parameter a layer, named as
``model.named_parameters()`` names them (``layers.3.attn.wq``).
:func:`params_from_reference` loads such a dict of arrays into a port
module, :func:`params_to_reference` gives it back; :func:`grads_to_reference`
gives the parameters' ``.grad`` the same way, and
:func:`opt_state_to_reference` / :func:`opt_state_from_reference` carry the
optimizer's moments and step.  Every round trip is exact.  The tests use
them so that both packages compute with the same weights, and the trainer's
checkpoint holds the reference's layout (:func:`host_tree`, the one
assembly of that layout on the host, from whole tensors or from the
blocks of a model laid out over a mesh), so a checkpoint either package
writes restores in the other.  A model laid out
over a mesh (``models/tensor_parallel.LaidOutModel``) holds no whole
model: :func:`blocks_from_reference` (which :func:`params_from_reference`
calls for one) gives each slot its blocks of each array and no more, and
:func:`params_to_reference` gathers the first data row's blocks into a
whole model on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import STACKED, _unflatten, get_path, tree_paths
from repro_torch.models.tensor_parallel import LaidOutModel


def _param_names(model, path: tuple) -> list:
    """The parameter names of a spec path: one a layer for a stacked path."""
    if path[0] in STACKED:
        rest = ".".join(path[1:])
        return [f"{path[0]}.{i}.{rest}" for i in range(len(getattr(model, path[0])))]
    return [".".join(path)]


def stack_named(model, named: dict) -> dict:
    """``named`` (parameter names to tensors, as the parameters, gradients
    or moments) as the reference's nested dict: the layers stacked on their
    leading axis (a new tensor), any other leaf the tensor itself."""
    flat = {}
    for path, _ in tree_paths(model.spec()):
        names = _param_names(model, path)
        flat[path] = (torch.stack([named[n] for n in names]) if path[0] in STACKED
                      else named[names[0]])
    return _unflatten(flat)


def _unstack_named(model, tree: dict, device=None, dtype=None) -> dict:
    """The reference's nested dict (numpy arrays or tensors) as parameter
    names to new tensors on ``device`` (default the model's), in ``dtype``
    (default the leaf's own)."""
    device = model.device if device is None else device
    out = {}
    for path, _ in tree_paths(model.spec()):
        value = get_path(tree, path)
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.asarray(value))
        value = value.to(device=device, dtype=dtype or value.dtype, copy=True)
        names = _param_names(model, path)
        parts = value.unbind(0) if path[0] in STACKED else [value]
        if len(parts) != len(names):
            raise ValueError(f"{'/'.join(path)}: {len(parts)} layers against {len(names)}")
        out.update(zip(names, parts))
    return out


def whole(named: dict):
    """``pieces_of`` for :func:`host_tree` over tensors held whole:
    ``named`` maps each parameter name to its tensor."""
    return lambda name: [((...,), named[name])]


def host_tree(model, pieces_of) -> dict:
    """The reference's nested dict of numpy arrays on the host, each spec
    path's leaf (the layers stacked on its leading axis) assembled from
    ``pieces_of(name)``: pairs of (slices of the port's parameter ``name``,
    a tensor holding that region), one pair for a tensor held whole
    (:func:`whole`), one a block for a model laid out over a mesh.  Each
    piece is copied to the host as it comes, so no whole leaf is made on a
    device; a bf16 piece widens to float32 on the host (numpy has no
    bfloat16), and the arrays share no storage with the pieces."""
    flat = {}
    for path, leaf in tree_paths(model.spec()):
        out = None
        for i, name in enumerate(_param_names(model, path)):
            for cut, t in pieces_of(name):
                x = t.detach()
                if x.dtype == torch.bfloat16:
                    x = x.to("cpu")
                if out is None:
                    out = torch.empty(leaf.shape, dtype=torch.float32 if
                                      x.dtype == torch.bfloat16 else x.dtype)
                (out[i] if path[0] in STACKED else out)[cut].copy_(x)
        flat[path] = out.numpy()
    return _unflatten(flat)


def leaf_reader(tree: dict, take=None):
    """``read(name, slices, device)`` over ``tree`` (the reference's nested
    dict): the block ``slices`` of the port's parameter ``name`` (one layer
    of a stacked leaf), read by ``take(path, leaf, region, device)`` from
    the region of the whole (stacked) leaf; by default the leaf (a numpy
    array, memory-mapped too, or a tensor) is sliced before it is copied,
    on the host, and the caller's ``copy_`` moves the block."""
    def read(name, cut, device=None):
        parts = name.split(".")
        stacked = parts[0] in STACKED
        path = (parts[0], *parts[2:]) if stacked else tuple(parts)
        if stacked:
            cut = (slice(int(parts[1]), int(parts[1]) + 1), *cut)
        leaf = get_path(tree, path)
        if take is not None:
            value = take(path, leaf, cut, device)
        else:
            value = leaf[cut]
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value))
        return value[0] if stacked else value

    return read


def blocks_from_reference(laid, tree: dict):
    """Load ``tree`` (the reference's nested dict) into ``laid`` (a
    ``LaidOutModel``): each slot copies only its block of each array
    (:func:`leaf_reader`).  Returns ``laid``."""
    for path, leaf in tree_paths(laid.groups[0].slots[0].whole_spec()):
        got = tuple(get_path(tree, path).shape)
        if got != tuple(leaf.shape):
            raise ValueError(f"{'/'.join(path)}: shape {got} against {tuple(leaf.shape)}")
    return laid.load(leaf_reader(tree))


def params_from_reference(model, tree: dict):
    """Copy every leaf of ``tree`` (the reference's nested dict, numpy
    arrays or tensors) into ``model``'s parameters, unstacking the layer
    axes; every path of the model's spec must be there with its shape (a
    laid-out model: :func:`blocks_from_reference`).  Returns ``model``."""
    if isinstance(model, LaidOutModel):
        return blocks_from_reference(model, tree)
    for path, _ in tree_paths(model.spec()):
        value = get_path(tree, path)
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.asarray(value))
        model.load_leaf(path, value)
    return model


def params_to_reference(model) -> dict:
    """``model``'s parameters as the reference's nested dict of numpy arrays,
    the layers stacked on their leading axis; bf16 widens to float32 (a
    laid-out model's first data row gathered on the CPU)."""
    model = model.gather() if isinstance(model, LaidOutModel) else model
    return host_tree(model, whole(dict(model.named_parameters())))


def grads_to_reference(model) -> dict:
    """The parameters' ``.grad`` as :func:`params_to_reference` gives the
    parameters; a parameter without one gives zeros, as the reference's
    gradient of an unused leaf."""
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    return host_tree(model, whole(grads))


def opt_state_to_reference(model, state):
    """``state`` (the port's ``OptState``) in the reference's layout: the
    step as a 0-d int32 array, the moments as stacked nested dicts of numpy
    arrays (bf16 widened)."""
    return type(state)(np.asarray(state.step.detach().cpu().numpy(), np.int32),
                       host_tree(model, whole(state.m)), host_tree(model, whole(state.v)))


def opt_state_from_reference(model, state, device=None, dtype=None):
    """An optimizer state in the reference's layout (its ``OptState`` or the
    port's, arrays or tensors) as the port's ``OptState``, on ``device``
    (default the model's), the moments in ``dtype`` (default their own)."""
    from repro_torch.train.optimizer import OptState  # train imports this module

    device = model.device if device is None else device
    step = torch.as_tensor(np.asarray(state.step) if not isinstance(state.step, torch.Tensor)
                           else state.step).to(device=device, dtype=torch.int32, copy=True)
    return OptState(step.reshape(()), _unstack_named(model, state.m, device, dtype),
                    _unstack_named(model, state.v, device, dtype))
