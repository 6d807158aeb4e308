"""What the entry drivers share, and the loader that finds one by name.

A traffic mix names the program entry it drives (``entry``); the harness
loads ``radbench/entries/<entry>.py`` and builds its ``Driver`` with
``(config, mix, pool, device, seed)``.  A driver builds the program's
entry object, and has:

* ``setup()``: warm every shape its window will use;
* ``window(seconds, mark)``: run the window, return ``(cases completed,
  seconds)``; ``mark(name)`` wraps a host span in a traced run;
* ``answers()``: ``(pool index, row)`` of every answer due in the window;
* ``failed()``: answers that failed or never came;
* ``replay_units()``: ``(weight, call)`` that replay the window's work for
  the roofline census (``[]`` where the entry cannot replay it);
* ``close()``;
* ``counters``: what the per-layer readers read, ``spans``: the program
  callables a traced run wraps in host spans (``radbench/trace.py``), and
  ``row``: ``"split"`` (a batched row, ``check.split_row``) or
  ``"single"`` (``execute``'s features, ``check.single_row``);
* optionally ``latencies_s()``: each request's latency, for the readers.

A new entry is a new file under ``entries/``, found by its name.
"""
from __future__ import annotations

import collections
import importlib.util
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
EXECUTOR = "repro_torch.core.executor"


def load(entry: str, root: Path = HERE):
    """The ``Driver`` class of ``radbench/entries/<entry>.py`` under ``root``
    (the ``radbench`` folder)."""
    path = root / "entries" / f"{entry}.py"
    spec = importlib.util.spec_from_file_location(
        f"radbench_entry_{entry.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Driver


def depth_buckets(most: int) -> list[int]:
    """The power-of-two batch depths up to the one holding ``most``."""
    out = [1]
    while out[-1] < most:
        out.append(out[-1] * 2)
    return out


def prewarm_keys(pool, config, device, depth_of) -> int:
    """Resolve, through the program's own dispatcher, every kernel
    configuration a batched window over ``pool`` can ask for: the
    compaction tile and the static target's diameter configuration of each
    vertex cap the pool's cases plan to, at every batch depth up to
    ``depth_of(cases with that cap)``, the unpruned sweep of each cap of
    the ladder at depth 1 (the collect's re-sweeps), and each intensity
    family's block for each shape bucket.  A cached key is a lookup; a
    missing one is swept here, in set-up, and not in the window.  Returns
    the keys resolved."""
    from repro_torch.core import dispatcher
    from repro_torch.core import plan as planlib

    caps, shapes = collections.Counter(), collections.Counter()
    for c in pool:
        caps[planlib.vertex_bucket(planlib.vertex_hint(c.bbox, c.spacing))] += 1
        shapes[planlib.shape_bucket(c.bbox)] += 1
    dev = torch.device(device)
    n = 0
    if "shape" in config["families"]:
        for cap, count in sorted(caps.items()):
            target = planlib.static_bucket(cap)
            for d in depth_buckets(depth_of(count)):
                dispatcher.compact_config(dev, cap, "auto", batch=d)
                if target is None:
                    dispatcher.diameter_config(dev, cap, "auto", batch=d)
                else:
                    dispatcher.diameter_config(dev, target, "auto", batch=d, static=True)
                n += 2
        ladder = planlib.MIN_VERTEX_BUCKET
        while ladder <= max(caps):
            dispatcher.diameter_config(dev, ladder, "auto", batch=1)
            ladder *= 2
            n += 1
    for fam, fn in (("firstorder", dispatcher.firstorder_config),
                    ("glcm", dispatcher.glcm_config)):
        if fam not in config["families"]:
            continue
        for shape, count in sorted(shapes.items()):
            for d in depth_buckets(depth_of(count)):
                fn(dev, shape, "auto", batch=d)
                n += 1
    return n


def batched(config, device):
    """The configuration's ``BatchedExtractor``."""
    from repro_torch.core.pipeline import BatchedExtractor

    return BatchedExtractor(device=device, families=tuple(config["families"]),
                            n_bins=config["n_bins"], **config["extractor"])


def has_nan(row) -> bool:
    return not np.all(np.isfinite(np.asarray(row, np.float64)))
