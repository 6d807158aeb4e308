"""``stream``: ``BatchedExtractor(...).extract_stream(cases, window=W)``,
closed loop, one job after another.

A job is ``passes`` permutations of the pool, the same job every time, so
set-up's one job warms every window the measurement runs.  ``window`` is
handed to the entry as the mix states it (a number, or ``"auto"`` for the
cost model's windows).
"""
from __future__ import annotations

import contextlib
import math
import time

from radbench import drivers, traffic


class Driver:
    row = "split"
    spans = [(drivers.EXECUTOR, "PlanExecutor.submit_window", "radbench.submit_window"),
             (drivers.EXECUTOR, "PlanExecutor.collect_window", "radbench.collect_window"),
             (drivers.EXECUTOR, "crop_to_roi", "radbench.crop_to_roi")]

    def __init__(self, config, mix, pool, device, seed):
        self.ext = drivers.batched(config, device)
        self.stream_window = mix["window"]
        self.job = traffic.job_order(len(pool), int(mix["passes"]), seed)
        self.cases = [pool[i].triple for i in self.job]
        self.pool_bbox = [c.bbox for c in pool]
        self.counters = {"plan": [], "fetches": 0, "windows": 0, "job_s": []}
        self.jobs = []

    def run_job(self, plan_stats=None):
        cb = None if plan_stats is None else (lambda i, st: plan_stats.append(st))
        return list(self.ext.extract_stream(self.cases, window=self.stream_window,
                                            stats_callback=cb))

    def setup(self):
        self.run_job()

    def window(self, seconds: float, mark=contextlib.nullcontext):
        log = self.ext.executor.transfer_log
        fetch0 = sum(log.values())
        t0 = time.perf_counter()
        ends = []
        while True:
            with mark("radbench.job"):
                self.jobs.append(self.run_job(self.counters["plan"]))
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        self.counters["job_s"] = [b - a for a, b in zip([0.0] + ends, ends)]
        self.counters["fetches"] = sum(log.values()) - fetch0
        self.counters["windows"] = len(self.counters["plan"])
        # each stream window's ROI voxels (crop and its one-voxel pad), the
        # weights of the plan's pad-waste shares: the windows take the
        # job's cases in order, each as many as its plan holds
        roi, k = [], 0
        for st in self.counters["plan"]:
            idx = [self.job[(k + j) % len(self.job)] for j in range(st["cases"])]
            roi.append(sum(math.prod(b + 2 for b in self.pool_bbox[i]) for i in idx))
            k += st["cases"]
        self.counters["roi_voxels"] = roi
        return len(self.jobs) * len(self.job), ends[-1]

    def answers(self):
        return [(i, row) for rows in self.jobs for i, row in zip(self.job, rows)]

    def failed(self) -> int:
        return sum(drivers.has_nan(r) for rows in self.jobs for r in rows)

    def replay_units(self):
        """``(weight, call)``: one more job stands for every job of the window."""
        return [(len(self.jobs), self.run_job)]

    def close(self):
        self.ext = None
