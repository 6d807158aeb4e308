"""Cost model: measured autotune tables + plan censuses -> scheduling decisions.

Counterpart of ``repro.runtime.costmodel``.  The executor's mechanisms
(the counted and static schedules, fixed stream windows) leave their
choice to knobs; this module chooses for the auto knobs, from two sources
that exist before any device work of a window runs:

* the **autotune cache** (``runtime/autotune``): the winner's device time
  ``us`` of every ``diameter/<device>/M<bucket>/B<depth>`` record (a
  launch of ``depth`` probe lists, each valid over
  ``autotune.probe_extent(bucket)`` slots), the ``sync/<device>`` fetch
  latency and the ``hw/<device>`` roofline profile;
* the **plan census** (``core/plan``): each case's shape bucket, vertex
  cap and vertex count (or hint).

Decisions (wired through ``core/executor``):

``choose_schedule(metas)``
    Counted or static for one window.  Both sweep a list over its extent
    only (``seqacc`` and ``nomask`` stop at the last valid slot,
    ``tri_prefetch`` skips empty tiles), so a launch is priced by the
    extent the plan expects in each list, ``max(2, n_vertices *
    assumed_keep)``, at the bucket it runs in: the counted schedule pays
    one fetch per cap group and sweeps each case at its tight bucket, the
    static schedule sweeps it at the cap's static target.  The
    reference prices both at their buckets' caps, which is right for its
    full-bucket Pallas sweep and not for these kernels; where the choices
    differ, ``ROADMAP.md`` (Queue 3, deliberate divergences) says so.
``should_close(census, meta)``
    Closes an ``extract_stream(window='auto')`` window early when the
    incoming case opens a new shape or cap group while every group is
    already at or past its break-even depth, or when the window reaches
    its memory (``REPRO_STREAM_MEM_MB``, default 512 MiB of staged masks
    and vertex lists) or case (``REPRO_STREAM_MAX_CASES``, 256) budget.
``break_even_depth(cap)``
    The smallest measured depth whose per-case cost is within
    :data:`BREAK_EVEN_SLACK` of the best measured depth of the bucket;
    with fewer than two measured depths, :data:`DEFAULT_BREAK_EVEN_DEPTH`.
``deadline_at_risk(census, slack_us)``
    The service's latency rule: the open window's modeled cost
    (:meth:`CostModel.window_cost_us`, priced at each group's cap, a
    deliberate over-estimate) times :data:`DEADLINE_SAFETY` against the
    slack before the oldest pending deadline.

Estimate ladder of one bucket's price: a measured record (the nearest
shallower measured depth next); else the roofline bound of
``runtime/roofline.diameter_cost`` under the device's profile; else, with
no profile (``REPRO_ROOFLINE=0``), the analytic ``(cap/1024)^2 *
PAIR_SWEEP_US``.  A measured record is used only when it carries the
current ``kernels/diameter.REVISION``, the tuner's own rule.

Determinism: with probing off (``REPRO_AUTOTUNE=0``, or the CPU) every
decision is a pure function of (device type, cache file, metadata) and
nothing is written.  On the card the probes run once, when
:meth:`CostModel.resolve` is called; the executor calls it before it
prepares a window, so no probe's sync lands inside a submit.
"""
from __future__ import annotations

import os
import warnings

import torch

from repro_torch.core import plan as planlib
from repro_torch.kernels import diameter as _diam
from repro_torch.runtime import autotune
from repro_torch.runtime import roofline as rooflib

# analytic price of an unmeasured bucket with no hardware profile: the
# pair sweep is O(cap^2), ~PAIR_SWEEP_US per (1024)^2-pair launch; only
# ratios between buckets matter to the decisions
PAIR_SWEEP_US = 200.0

# fraction of pre-prune vertices assumed to survive the exact bound when
# no count exists yet (the compaction probe keeps the same ~25%)
ASSUMED_KEEP_FRACTION = 0.25

# a depth is past break-even when its measured per-case cost is within
# this factor of the bucket's best measured depth
BREAK_EVEN_SLACK = 1.25
DEFAULT_BREAK_EVEN_DEPTH = 4
MAX_PROBED_DEPTH = 64

DEFAULT_WINDOW_MEM_MB = 512.0
DEFAULT_WINDOW_MAX_CASES = 256

# margin on the modeled window cost against a deadline: the model sees the
# diameter sweeps and the fetches, not MC, staging or the drain
DEADLINE_SAFETY = 2.0

_warned_env: set = set()  # variables already warned about in this process


def _env_float(name: str, default: float) -> float:
    """A float from the environment; a malformed value warns once per
    variable and process, then gives ``default`` (unset or empty: the
    default, silently)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        if name not in _warned_env:
            _warned_env.add(name)
            warnings.warn(f"malformed {name}={raw!r} in the environment; "
                          f"falling back to the default {default!r}",
                          RuntimeWarning, stacklevel=2)
        return default


class CostModel:
    """Decision layer over the autotune cache for one device.

    ``device`` is a device or its name (``'cuda'``, ``'cuda:N'``,
    ``'cpu'``); the cache keys carry its type.  Lookups are memoised per
    instance, so a long stream reads each key of the cache once.
    """

    def __init__(self, device, cache: autotune.AutotuneCache | None = None, *,
                 assumed_keep: float = ASSUMED_KEEP_FRACTION,
                 break_even_default: int = DEFAULT_BREAK_EVEN_DEPTH,
                 window_mem_bytes: float | None = None,
                 window_max_cases: int | None = None):
        self.device = torch.device(device)
        self.backend = self.device.type
        self.cache = cache or autotune.AutotuneCache()
        self.assumed_keep = assumed_keep
        self.break_even_default = break_even_default
        if window_mem_bytes is None:
            window_mem_bytes = _env_float("REPRO_STREAM_MEM_MB", DEFAULT_WINDOW_MEM_MB) * 2**20
        self.window_mem_bytes = float(window_mem_bytes)
        if window_max_cases is None:
            window_max_cases = int(_env_float("REPRO_STREAM_MAX_CASES",
                                              DEFAULT_WINDOW_MAX_CASES))
        self.window_max_cases = int(window_max_cases)
        self._sync_us: float | None = None
        self._hw_profile: dict | None | str = "unresolved"
        self._diam_us: dict = {}
        self._break_even: dict = {}

    # -- measured lookups ---------------------------------------------------

    def resolve(self) -> "CostModel":
        """Resolves the sync cost and the hardware profile now (probing the
        card on a cold cache), so no later decision syncs."""
        self.sync_cost_us()
        self.hw_profile()
        return self

    def sync_cost_us(self) -> float:
        """Per-fetch device-to-host latency (``dispatcher.sync_cost``)."""
        if self._sync_us is None:
            from repro_torch.core import dispatcher  # local import: avoids a cycle

            self._sync_us = dispatcher.sync_cost(self.device, cache=self.cache)
        return self._sync_us

    def hw_profile(self) -> dict | None:
        """The device's roofline profile (``dispatcher.hw_profile``; None:
        no profile)."""
        if self._hw_profile == "unresolved":
            from repro_torch.core import dispatcher

            self._hw_profile = dispatcher.hw_profile(self.device, cache=self.cache)
        return self._hw_profile

    def _measured_us(self, key: str) -> float | None:
        hit = self.cache.get(key)
        if hit is None or hit.get("revision") != _diam.REVISION:
            return None
        try:
            us = float(hit["us"])
        except (KeyError, TypeError, ValueError):
            return None
        return us if us > 0 else None

    def _measured_case_us(self, cap: int, depth: int) -> float | None:
        """Per-case device time of the measured record at ``(cap, depth)``
        (its ``us`` is the whole launch: divided by the depth bucket), the
        nearest shallower measured depth next; None when none is measured."""
        memo = (cap, depth)
        if memo not in self._diam_us:
            out, probe = None, depth
            while probe >= 1 and out is None:
                us = self._measured_us(autotune.sweep_key(cap, self.backend, probe))
                if us is not None:
                    out = us / probe
                probe //= 2
            self._diam_us[memo] = out
        return self._diam_us[memo]

    def diameter_case_us(self, cap: int, depth: int = 1) -> float:
        """Modeled per-case cost of a sweep launch at a (bucket, depth) pair,
        its lists as full as the tuner's probe (``autotune.probe_extent``).

        A measured ``diameter/<device>/M<cap>/B<depth>`` record wins (the
        nearest shallower measured depth next); an unmeasured bucket takes
        the roofline bound at the probe's extent; with no profile, the
        analytic constant at the cap.
        """
        return self.diameter_extent_us(cap, depth, None)

    def diameter_extent_us(self, cap: int, depth: int, extent: int | None) -> float:
        """Modeled per-case cost of sweeping a list of ``extent`` valid
        slots (None: the probe's extent) in a launch at ``(cap, depth)``.

        The ladder of :meth:`diameter_case_us`: a measured price scales
        with the pairs, ``(extent / probe_extent(cap))^2``; the roofline
        step evaluates ``runtime/roofline.diameter_cost`` at ``extent``;
        the analytic constant is ``(extent / 1024)^2 * PAIR_SWEEP_US``.
        """
        cap = int(cap)
        probe = autotune.probe_extent(cap)
        ext = probe if extent is None else max(1, min(int(extent), cap))
        measured = self._measured_case_us(cap, autotune.batch_bucket(max(1, depth)))
        if measured is not None:
            return measured if extent is None else measured * (ext / probe) ** 2
        profile = self.hw_profile()
        if profile is not None:
            flops, nbytes = rooflib.diameter_cost(cap, 1, ext)
            return rooflib.roofline_us(flops, nbytes, profile)
        return ((cap if extent is None else ext) / 1024.0) ** 2 * PAIR_SWEEP_US

    def break_even_depth(self, cap: int) -> int:
        """Smallest measured depth within BREAK_EVEN_SLACK of the best; the
        default with fewer than two measured depths."""
        cap = int(cap)
        if cap in self._break_even:
            return self._break_even[cap]
        per_case = {}
        d = 1
        while d <= MAX_PROBED_DEPTH:
            us = self._measured_us(autotune.sweep_key(cap, self.backend, d))
            if us is not None:
                per_case[d] = us / d
            d *= 2
        if len(per_case) < 2:
            out = self.break_even_default
        else:
            best = min(per_case.values())
            out = next(d for d in sorted(per_case) if per_case[d] <= BREAK_EVEN_SLACK * best)
        self._break_even[cap] = out
        return out

    # -- decision: counted vs static schedule --------------------------------

    def schedule_costs(self, metas) -> dict:
        """Modeled ``{"counted": us, "static": us}`` of one window's pass 2b.

        Per cap group: counted pays one fetch (the ``(B, 2)`` counts) and
        sweeps each case at its tight bucket ``min(vertex_bucket(kept),
        cap)``; static sweeps it at the group's target
        (``plan.static_bucket``, the cap itself for a floor-cap group).
        Each case is priced at its expected extent ``kept = max(2,
        n_vertices * assumed_keep)`` (:meth:`diameter_extent_us`), at the
        group's depth bucket.
        """
        sync_us = self.sync_cost_us()
        groups: dict[int, list] = {}
        for m in metas:
            if not getattr(m, "empty", False) and m.vertex_cap:
                groups.setdefault(int(m.vertex_cap), []).append(m)
        counted = static = 0.0
        for cap, group in groups.items():
            depth = autotune.batch_bucket(len(group))
            counted += sync_us
            target = planlib.static_bucket(cap) or cap
            for m in group:
                kept = max(2, int(m.n_vertices * self.assumed_keep))
                tight = min(planlib.vertex_bucket(kept), cap)
                counted += self.diameter_extent_us(tight, depth, kept)
                static += self.diameter_extent_us(target, depth, kept)
        return {"counted": counted, "static": static, "groups": len(groups)}

    def choose_schedule(self, metas) -> str:
        """``'counted'`` or ``'static'`` for one window (ties and windows
        with nothing to sweep go to counted, the zero-latency default)."""
        costs = self.schedule_costs(metas)
        if not costs["groups"]:
            return "counted"
        return "counted" if costs["counted"] <= costs["static"] else "static"

    # -- decision: latency vs throughput (the service) -----------------------

    def window_cost_us(self, census: planlib.WindowCensus) -> float:
        """Modeled collect-side cost of the open window (microseconds): per
        cap group one fetch and its cases' sweeps priced at the cap
        (:meth:`diameter_case_us`), an over-estimate of the extent-priced
        sweep and an under-estimate of the wall (no MC, staging or drain)."""
        total = 0.0
        for cap, depth in census.cap_depths.items():
            d = autotune.batch_bucket(max(1, depth))
            total += self.sync_cost_us()
            total += depth * self.diameter_case_us(cap, d)
        return total

    def deadline_at_risk(self, census: planlib.WindowCensus, slack_us: float | None,
                         safety: float = DEADLINE_SAFETY) -> bool:
        """Must the open window close now for its oldest deadline?  True once
        ``window_cost_us * safety`` reaches ``slack_us``; an expired
        deadline (slack <= 0) always closes; no deadline, never."""
        if census.cases == 0 or slack_us is None:
            return False
        if slack_us <= 0:
            return True
        return self.window_cost_us(census) * safety >= slack_us

    # -- decision: adaptive stream windows -----------------------------------

    def window_budget_cases(self, census: planlib.WindowCensus) -> int:
        """Memory-budgeted case cap of the open window (>= 1)."""
        if census.cases and census.bytes:
            per_case = census.bytes / census.cases
            return max(1, min(self.window_max_cases, int(self.window_mem_bytes // per_case)))
        return self.window_max_cases

    def should_close(self, census: planlib.WindowCensus, meta: planlib.CaseMeta) -> bool:
        """Close the open window before admitting ``meta``?

        True at the memory or case budget, or when ``meta`` opens a new
        shape or cap group while every current group is at or past its
        break-even depth; a still-shallow window keeps absorbing
        heterogeneity.
        """
        if census.cases == 0:
            return False
        if census.cases >= self.window_budget_cases(census):
            return True
        if census.bytes + planlib.meta_bytes(meta) > self.window_mem_bytes:
            return True
        if not census.fragments(meta):
            return False
        depths = list(census.shape_depths.values()) + list(census.cap_depths.values())
        if not depths:  # only empty-mask cases so far: nothing to fragment
            return False
        break_even = (max(self.break_even_depth(cap) for cap in census.cap_depths)
                      if census.cap_depths else self.break_even_default)
        return min(depths) >= break_even

