"""``single``: ``ShapeFeatureExtractor().execute(image, mask, spacing)``,
closed loop, one client, the pool in seeded permutations."""
from __future__ import annotations

import collections
import contextlib
import math
import time

from radbench import traffic

SHAPE = "repro_torch.core.shape_features"


class Driver:
    row = "single"
    spans = [(SHAPE, "crop_to_roi", "radbench.crop_to_roi"),
             (SHAPE, "ShapeFeatureExtractor.mesh_features", "radbench.mesh_features"),
             (SHAPE, "ShapeFeatureExtractor.diameter_features", "radbench.diameter_features")]

    def __init__(self, config, mix, pool, device, seed):
        from repro_torch.core.shape_features import ShapeFeatureExtractor

        self.ext = ShapeFeatureExtractor(device=device)
        self.pool = pool
        self.order = traffic.job_order(len(pool), int(mix["passes"]), seed)
        self.done = []  # (pool index, features)
        self.counters = {"preprocess_ms": 0.0, "total_ms": 0.0}

    def setup(self):
        for c in self.pool:
            self.ext.execute(*c.triple)

    def window(self, seconds: float, mark=contextlib.nullcontext):
        t0 = time.perf_counter()
        k = 0
        while True:
            i = self.order[k % len(self.order)]
            with mark("radbench.execute"):
                feats, times = self.ext.execute(*self.pool[i].triple, with_times=True)
            self.done.append((i, feats))
            self.counters["preprocess_ms"] += times.preprocess_ms
            self.counters["total_ms"] += times.total_ms
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return k, time.perf_counter() - t0

    def answers(self):
        return self.done

    def failed(self) -> int:
        return sum(any(not math.isfinite(v) for k, v in f.items() if not k.startswith("_"))
                   for _, f in self.done)

    def replay_units(self):
        """``(weight, call)``: each distinct case of the window once more,
        weighted by the times the window ran it."""
        counts = collections.Counter(i for i, _ in self.done)
        return [(n, lambda i=i: self.ext.execute(*self.pool[i].triple))
                for i, n in sorted(counts.items())]

    def close(self):
        self.ext = None
