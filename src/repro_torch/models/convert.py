"""Weights to and from the reference's parameter trees.

The reference's ``model.init(key)`` gives a nested dict whose leaves stack
the layers on a leading axis (``layers``, ``encoder``, ``decoder``); the
port's modules hold one parameter a layer.  :func:`params_from_reference`
loads such a dict of numpy arrays (``np.asarray`` of each leaf) into a
port module, :func:`params_to_reference` gives it back; the round trip is
exact.  The tests use them so that both packages compute with the same
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import _unflatten, get_path, tree_paths


def params_from_reference(model, tree: dict):
    """Copy every leaf of ``tree`` (the reference's nested dict, numpy
    arrays) into ``model``'s parameters, unstacking the layer axes; every
    path of the model's spec must be there with its shape.  Returns
    ``model``."""
    for path, _ in tree_paths(model.spec()):
        value = np.asarray(get_path(tree, path))
        model.load_leaf(path, torch.tensor(value, device=model.device))
    return model


def params_to_reference(model) -> dict:
    """``model``'s parameters as the reference's nested dict of numpy arrays,
    the layers stacked on their leading axis; bf16 widens to float32."""
    flat = {}
    for path, _ in tree_paths(model.spec()):
        t = model.leaf(path)
        t = torch.stack(list(t)) if isinstance(t, list) else t
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        flat[path] = t.numpy()
    return _unflatten(flat)
