"""GPipe-style pipeline parallelism over the 'pod' mesh axis.

Counterpart of the reference's ``parallel/pipeline.py``.  The layer stack
is split into one stage a ``pod`` slot; only (microbatch, seq, d_model)
activations cross from one stage to the next, once a microbatch.

Implementation: ``parallel.sharding.shard_map_compat`` over the ``pod``
axis, one host thread a slot; each slot holds its stage's stacked layers on
its own device.  The GPipe schedule runs ``n_micro + n_stages - 1`` ticks
in a Python loop (the reference's ``lax.scan``): at each tick every stage
processes one microbatch slot and hands its output to the next stage with
``ppermute``.  Bubble fraction = (S-1)/(M+S-1).  A stage skips the ticks
where it holds no microbatch (the reference computes on a clipped or
zero input there and discards the result), and still takes part in each
tick's ``ppermute``.  The last stage's outputs are ``psum``-replicated to
every slot, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import PartitionSpec as P


def pipeline_stages(n_layers: int, n_stages: int):
    """Evenly partition layers into contiguous stages."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} stages")
    per = n_layers // n_stages
    return [(s * per, (s + 1) * per) for s in range(n_stages)]


def gpipe(stage_fn, n_stages: int, *, axis: str = "pod"):
    """Build the per-slot GPipe schedule body.

    ``stage_fn(stage_params, x) -> x`` applies this stage's layer block to
    one microbatch of activations (B_micro, S, d).  Returns ``run(
    stage_params, micro_x) -> micro_y`` for use under ``shard_map_compat``
    where ``axis`` indexes the stage:

        micro_x: (n_micro, B_micro, S, d)  read by stage 0
        micro_y: (n_micro, B_micro, S, d)  the last stage's, on every slot
    """

    def run(stage_params, micro_x):
        sid = sharding.axis_index(axis)
        n_micro = micro_x.shape[0]
        buf = torch.zeros_like(micro_x)  # output slots (filled on the last stage)
        inflight = torch.zeros_like(micro_x[0])
        perm = [(i, i + 1) for i in range(n_stages - 1)]
        for t in range(n_micro + n_stages - 1):
            # stage 0 injects microbatch t; the others take the activation
            # handed over by the previous stage at the last tick
            x_in = micro_x[min(t, n_micro - 1)] if sid == 0 else inflight
            busy = 0 <= t - sid < n_micro
            y = stage_fn(stage_params, x_in) if busy else x_in
            inflight = sharding.ppermute(y, axis, perm)
            out_slot = t - (n_stages - 1)
            if sid == n_stages - 1 and out_slot >= 0:
                buf[out_slot] = y
        # only the last stage holds outputs; psum replicates them
        return sharding.psum(buf, axis)

    return run


def pipeline_forward(layer_fn, params_stacked, x, mesh, *, n_micro: int, axis: str = "pod"):
    """Full pipeline forward: split the batch into microbatches, run GPipe.

    ``layer_fn(layer_params, x) -> x``; ``params_stacked``: a tree of
    tensors with a leading (n_layers, ...) dim, split into one stage a slot
    of ``axis``.  ``x``: (B, S, d) with B % n_micro == 0.  Returns (B, S, d)
    on the mesh's first slot.
    """
    n_stages = mesh.shape[axis]
    b, s, d = x.shape
    if b % n_micro:
        raise ValueError(f"a batch of {b} does not split into {n_micro} microbatches")
    micro = x.reshape(n_micro, b // n_micro, s, d)

    def stage_fn(stage_params, xm):
        # the local view keeps a leading stage dim of 1
        for i in range(sharding.tree_leaves(stage_params)[0].shape[1]):
            xm = layer_fn(sharding.tree_map(lambda p: p[0, i], stage_params), xm)
        return xm

    run = gpipe(stage_fn, n_stages, axis=axis)
    n_layers = sharding.tree_leaves(params_stacked)[0].shape[0]
    per = n_layers // n_stages
    pipeline_stages(n_layers, n_stages)  # raises where the stages are uneven
    # layers as (n_stages, per, ...) so that each slot gets its stage
    staged = sharding.tree_map(lambda p: p.reshape(n_stages, per, *p.shape[1:]),
                               params_stacked)
    shmap = sharding.shard_map_compat(
        run,
        mesh=mesh,
        in_specs=(sharding.tree_map(lambda _: P(axis), staged),
                  P()),  # microbatches replicated in; stage 0 reads them
        out_specs=P(),
        check=False,
    )
    return shmap(staged, micro).reshape(b, s, d)
