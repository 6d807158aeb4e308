"""Int8 error-feedback gradient compression for the data-parallel reduction.

Counterpart of the reference's ``parallel/compression.py``: 4x compression
(f32 -> int8) of the gradient all-reduce, a 1-bit-Adam-family scheme with
k = 8 bits:

    residual e_t carried per leaf (error feedback)
    g' = g + e_t
    q  = clip(round(g' / scale), -127, 127), scale = max|g'| / 127  per leaf
    wire format int8; reduction upcasts to int32 (no overflow for <= 2^24
    participants); dequantised mean applied, e_{t+1} = g' - q * scale

Error feedback makes the quantisation noise telescope: the accumulated
applied update tracks the true gradient sum.  ``torch.round`` rounds half
to even, as ``jnp.round`` does, so on the CPU the payload, the scale and
the new error equal the reference's bit for bit.

:func:`compressed_psum_tree` runs inside a ``parallel.sharding.
shard_map_compat`` slot over a named axis (the shared scale a ``pmax``,
the payloads an int32 ``psum``), or with ``axis_name=None`` as the
single-process path.  A gradient tree is a tensor or nested dicts, lists
and tuples of tensors; leaves are taken in the reference's order.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import sharding


def _shared_scale(g32, axis_name=None):
    """One scale for every worker: quantising with per-worker scales and
    dequantising the wire-sum with any single scale is a biased reduction,
    so the scale is agreed before quantising (one scalar ``pmax``)."""
    amax = torch.amax(torch.abs(g32))
    if axis_name is not None:
        amax = sharding.pmax(amax, axis_name)
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def compress_leaf(g, err, scale=None):
    """Returns ``(int8 payload, scale, new_error)``."""
    g32 = g.to(torch.float32) + err
    if scale is None:
        scale = _shared_scale(g32)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, g32 - deq


def reduce_compressed(q, scale, axis_name=None):
    """Mean-reduce quantised gradients over the data-parallel workers of
    ``axis_name``; ``scale`` must be the same on every worker."""
    qi = q.to(torch.int32)
    if axis_name is None:
        return qi.to(torch.float32) * scale
    total = sharding.psum(qi, axis_name)  # int32 wire-sum of int8 payloads
    n = sharding.psum(torch.ones((), dtype=torch.int32, device=q.device), axis_name)
    return total.to(torch.float32) * scale / n.to(torch.float32)


def compressed_psum_tree(grads, err_tree, axis_name=None):
    """Error-feedback int8 psum over a gradient tree.

    Returns ``(reduced_grads, new_err_tree)``, both shaped as ``grads``.
    """
    leaves = sharding.tree_leaves(grads)
    errs = sharding.tree_leaves(err_tree)
    outs, new_errs = [], []
    for g, e in zip(leaves, errs):
        g32 = g.to(torch.float32) + e
        scale = _shared_scale(g32, axis_name)
        q, scale, ne = compress_leaf(g, e, scale=scale)
        outs.append(reduce_compressed(q, scale, axis_name).to(g.dtype))
        new_errs.append(ne)
    return sharding.tree_unflatten(grads, outs), sharding.tree_unflatten(grads, new_errs)


def init_error_state(params):
    """Zero float32 residuals shaped as ``params``, on each leaf's device."""
    return sharding.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
