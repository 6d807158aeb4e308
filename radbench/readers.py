"""Arithmetic the metric readers (``metrics/<name>.py``) share."""
from __future__ import annotations

import math

from radbench import yardstick as ys


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1) of every value: the
    ``ceil(q * n)``-th smallest."""
    vals = sorted(values)
    if not vals:
        return math.nan
    return vals[max(0, math.ceil(q * len(vals)) - 1)]


def latency_ms(run, q: float):
    """The ``q`` quantile, in ms, of an open loop's due-to-rows latencies;
    a request that failed or never came counts as the longest wait the
    run allows (the window and a minute past its close)."""
    if run.latencies_s is None or not run.latencies_s:
        return None
    cap = run.window_s + 60.0
    return 1e3 * percentile([min(x, cap) for x in run.latencies_s], q)


def roofline_share(run, kernel: str):
    """``kernel``'s share of its roofline, in %: the least time of the work
    the traced window handed it (``radbench/work``), the larger of its
    operations over the FP32 peak and its bytes over the bandwidth, taken
    over the window's totals, which never exceeds the sum of each launch's
    own bound; over the device seconds of the kernel's launches in the
    trace.  Nothing when the trace holds no launch of it."""
    if run.trace is None or not run.work or kernel not in run.work:
        return None
    device_s = sum(s for name, s in run.trace.kernel_s.items() if ys.kernel_of(name) == kernel)
    if device_s <= 0:
        return None
    least, _ = ys.least_seconds(run.work[kernel])
    return 100.0 * least / device_s


def idle_share(run):
    """1 - the union of device activity over the traced window, in %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * run.trace.idle_share


def pad_waste(run, key: str):
    """A plan pad-waste share over the window's stream windows, in %, each
    window weighted by its padded voxels (its ROI voxels over one minus its
    mask pad waste)."""
    plans, roi = run.counters.get("plan"), run.counters.get("roi_voxels")
    if not plans or not roi:
        return None
    num = den = 0.0
    for st, r in zip(plans, roi):
        padded = r / max(1e-12, 1.0 - st["mask_pad_waste"])
        num += padded * st[key]
        den += padded
    return 100.0 * num / den if den else None
