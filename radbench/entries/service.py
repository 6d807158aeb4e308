"""``service``: ``BatchedExtractor(...).serve()``, one case a request,
tenants taking turns.

Under a closed loop (``loop: closed``) ``clients`` clients keep one request
in flight each, each request timed from its submit; under an open one
(``loop: open``) requests come at the mix's fixed mean rate on its rate
profile (``radbench/traffic.py``), each timed from its due time.  Either
way a request's time ends when its client holds its rows.
"""
from __future__ import annotations

import collections
import contextlib
import math
import queue
import threading
import time

from radbench import drivers, traffic


class Driver:
    row = "split"
    spans = [(drivers.EXECUTOR, "PlanExecutor.prep_case", "radbench.prep_case"),
             (drivers.EXECUTOR, "PlanExecutor.submit_prepped", "radbench.submit_prepped"),
             (drivers.EXECUTOR, "PlanExecutor.collect_window", "radbench.collect_window"),
             (drivers.EXECUTOR, "crop_to_roi", "radbench.crop_to_roi")]
    WAIT_PAST_CLOSE_S = 60.0

    def __init__(self, config, mix, pool, device, seed):
        self.config, self.mix, self.pool, self.device, self.seed = config, mix, pool, device, seed
        self.closed = mix.get("loop") == "closed"
        self.rate = float(mix.get("rate_per_s", 0.0))
        self.tenants = int(mix["tenants"])
        self.svc = drivers.batched(config, device).serve()
        self.requests = []  # (pool index, due, done or None, row or None, error)
        self.counters = {"window_cases": [], "late_s": [], "keys": 0}

    def _submit(self, i, tenant):
        return self.svc.submit([self.pool[i].triple], tenant=f"tenant-{tenant}")

    @staticmethod
    def _outcome(fut, i, due, timeout):
        try:
            res = fut.result(timeout=max(0.0, timeout))
        except TimeoutError:
            return i, due, None, None, "no answer within a minute of the close"
        now = time.monotonic()
        return i, due, now, (res.rows[0] if res.rows else None), res.errors.get(0)

    def _paced(self, plan, t0, mark):
        """Submit ``plan``'s ``(offset, pool index, tenant)`` at ``t0 + offset``;
        a collector thread stamps each request when its rows are held."""
        done, pending = queue.Queue(), queue.Queue()

        def collect():
            while (item := pending.get()) is not None:
                fut, due, i = item
                done.put(self._outcome(fut, i, due, t0 + self.horizon - time.monotonic()))

        th = threading.Thread(target=collect, name="radbench-collector", daemon=True)
        th.start()
        try:
            for off, i, tenant in plan:
                due = t0 + off
                wait = due - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                self.counters["late_s"].append(time.monotonic() - due)
                with mark("radbench.submit_request"):
                    fut = self._submit(i, tenant)
                pending.put((fut, due, i))
        finally:
            pending.put(None)
            th.join()
        return [done.get() for _ in range(done.qsize())]

    def _clients(self, seconds, mark):
        """``clients`` closed-loop clients, one request in flight each, until
        ``seconds`` have passed: one thread sends each client's next case
        when the client's last one's rows come back.  The service resolves
        requests in submit order (one FIFO, windows in turn), so waiting on
        the oldest request in flight sees each completion as it comes."""
        n = int(self.mix["clients"])
        orders = traffic.client_orders(len(self.pool), n, self.seed)
        sent = [0] * n
        inflight = collections.deque()
        t0 = time.monotonic()
        stop = t0 + seconds

        def send(k):
            i = orders[k][sent[k] % len(orders[k])]
            sent[k] += 1
            due = time.monotonic()
            with mark("radbench.submit_request"):
                inflight.append((k, i, due, self._submit(i, k % self.tenants)))

        for k in range(n):
            send(k)
        out = []
        while inflight:
            k, i, due, fut = inflight.popleft()
            out.append(self._outcome(fut, i, due, stop + self.WAIT_PAST_CLOSE_S - due))
            if out[-1][2] is not None and time.monotonic() < stop:
                send(k)
        return out, t0

    def setup(self):
        clients = int(self.mix.get("clients", 0))
        # a closed loop's window holds at most one case a client
        self.counters["keys"] = drivers.prewarm_keys(
            self.pool, self.config, self.device,
            (lambda n: clients) if self.closed else (lambda n: 2 * n))
        rate = self.rate or 20.0
        warm = [(k / rate, i, k % self.tenants)
                for k, i in enumerate(traffic.job_order(len(self.pool), 1, self.seed))]
        self.horizon = warm[-1][0] + self.WAIT_PAST_CLOSE_S
        self._paced(warm, time.monotonic(), contextlib.nullcontext)
        self.counters["late_s"] = []

    def window(self, seconds: float, mark=contextlib.nullcontext):
        n0 = len(self.svc.stats()["window_cases"])
        self.counters["late_s"] = []
        if self.closed:
            self.requests, t0 = self._clients(seconds, mark)
            ends = [r[2] for r in self.requests if r[2] is not None]
            elapsed = (max(ends) if ends else time.monotonic()) - t0
        else:
            plan = traffic.arrivals(self.rate, seconds, len(self.pool), self.tenants, self.seed,
                                    self.mix.get("profile"))
            self.horizon = seconds + self.WAIT_PAST_CLOSE_S
            t0 = time.monotonic()
            self.requests = self._paced(plan, t0, mark)
            elapsed = time.monotonic() - t0
        self.counters["window_cases"] = self.svc.stats()["window_cases"][n0:]
        return len(self.requests), elapsed

    def latencies_s(self) -> list[float]:
        """From due time (an open loop) or submit (a closed one) to rows, every
        request of the window; one that failed or never came reads infinity."""
        return [math.inf if (done is None or err is not None) else done - due
                for _, due, done, _, err in self.requests]

    def answers(self):
        return [(i, row) for i, _, _, row, err in self.requests if row is not None]

    def failed(self) -> int:
        return sum(1 for _, _, done, row, err in self.requests
                   if done is None or err is not None or drivers.has_nan(row))

    def replay_units(self):
        return []

    def close(self):
        if self.svc is not None:
            self.svc.close(timeout=120)
            self.svc = None
