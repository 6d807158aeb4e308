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
checkpoint holds the reference's layout (:func:`stack_named`), so a
checkpoint either package writes restores in the other.  A model laid out
over a mesh (``models/tensor_parallel.LaidOutModel``) goes through its
whole model: :func:`params_from_reference` loads that and places it over
the mesh, :func:`params_to_reference` gathers the first data row's blocks
into it first, and the optimizer state's functions read its names.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import STACKED, _unflatten, get_path, tree_paths
from repro_torch.models.tensor_parallel import LaidOutModel


def _whole(model):
    """The whole model of a laid-out one; any other model itself."""
    return model.model if isinstance(model, LaidOutModel) else model


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
    model = _whole(model)
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
    model = _whole(model)
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


def _numpy(tree):
    """A nested dict of tensors as numpy arrays on the host; bf16 widens to
    float32 (numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    t = tree.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_reference(model, tree: dict):
    """Copy every leaf of ``tree`` (the reference's nested dict, numpy
    arrays or tensors) into ``model``'s parameters, unstacking the layer
    axes; every path of the model's spec must be there with its shape (a
    laid-out model: its whole model's, then placed).  Returns ``model``."""
    whole = _whole(model)
    for path, _ in tree_paths(whole.spec()):
        value = get_path(tree, path)
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.asarray(value))
        whole.load_leaf(path, value)
    if whole is not model:
        model.place()
    return model


def params_to_reference(model) -> dict:
    """``model``'s parameters as the reference's nested dict of numpy arrays,
    the layers stacked on their leading axis; bf16 widens to float32 (a
    laid-out model's first data row gathered)."""
    model = model.gather() if isinstance(model, LaidOutModel) else model
    return _numpy(stack_named(model, dict(model.named_parameters())))


def grads_to_reference(model) -> dict:
    """The parameters' ``.grad`` as :func:`params_to_reference` gives the
    parameters; a parameter without one gives zeros, as the reference's
    gradient of an unused leaf."""
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    return _numpy(stack_named(model, grads))


def opt_state_to_reference(model, state):
    """``state`` (the port's ``OptState``) in the reference's layout: the
    step as a 0-d int32 array, the moments as stacked nested dicts of numpy
    arrays (bf16 widened)."""
    return type(state)(np.asarray(state.step.detach().cpu().numpy(), np.int32),
                    _numpy(stack_named(model, state.m)), _numpy(stack_named(model, state.v)))


def opt_state_from_reference(model, state, device=None, dtype=None):
    """An optimizer state in the reference's layout (its ``OptState`` or the
    port's, arrays or tensors) as the port's ``OptState``, on ``device``
    (default the model's), the moments in ``dtype`` (default their own)."""
    from repro_torch.train.optimizer import OptState  # train imports this module

    model = _whole(model)
    device = model.device if device is None else device
    step = torch.as_tensor(np.asarray(state.step) if not isinstance(state.step, torch.Tensor)
                           else state.step).to(device=device, dtype=torch.int32, copy=True)
    return OptState(step.reshape(()), _unstack_named(model, state.m, device, dtype),
                    _unstack_named(model, state.v, device, dtype))
