"""Resilience layer: resumable manifests, fault injection, retry, preemption.

Counterpart of ``repro.runtime.resilience``.  A cohort of ~40 000 CTs on a
shared cluster outlives any one process: jobs get preempted, a window
stalls, one poisoned case must not cost hours of work.  This module runs
the port's plan/executor pipeline under those faults:

* :class:`RunManifest` -- a resumable run manifest.  A case's identity is
  a content hash of its mask bytes, shape, dtype and spacing
  (:meth:`RunManifest.case_id`), so a resume survives renames,
  reorderings and regenerated inputs; the file is append-only JSONL, one
  ``write`` per record, and :meth:`RunManifest.resume` builds the
  done-set and repairs a torn tail (a record cut mid-write by a kill) by
  truncating back to the last complete line.  ``record`` is idempotent:
  a case id already done is never written twice, which is what makes
  re-running the in-flight window safe.  The format is the reference's
  byte for byte, so a manifest written by the JAX package's runner
  resumes here with the same ids (``tests/test_torch_resilience.py``).

* :class:`FaultPlan` -- seeded fault injection: per-case load errors and
  NaN- or empty-mask poisoned cases (keyed by ``(seed, case index)``, so a
  resumed run sees the same faults), one-shot collect faults raised
  through the executor's ``transfer_callback`` (the retry path), a real
  ``SIGTERM`` at a chosen case (:class:`~repro_torch.runtime.
  fault_tolerance.PreemptionHandler`), and added latency in chosen
  windows (the straggler census).

* :class:`RetryPolicy` -- per-window retry with exponential backoff,
  read by ``PlanExecutor.collect_window``: a failed collect re-submits
  the window from its prepped device state (``resubmit_window``, bitwise
  a first submit) and drains it again, up to ``max_retries`` times.  An
  error of the card (``executor.DEVICE_ERRORS``) is not retried: it
  poisons the CUDA context, so the executor re-raises it at once.

* :class:`ResilientRunner` -- the run loop: window k+1 submitted before
  window k is drained, as ``extract_stream`` does; done cases skipped by
  content id before any prep; a poisoned case an ``error`` record, not a
  window abort; manifest rows written as each window drains; preemption
  checked at every case (at most one window of work is redone after a
  kill); each window's collect time observed by a
  :class:`~repro_torch.runtime.fault_tolerance.StragglerDetector`.

Manifest record format (one JSON object a line, sorted keys)::

    {"id": "<blake2b-128 of mask bytes+shape+dtype+spacing>",
     "name": "<optional caller-supplied case name>",
     "status": "done" | "error",
     "features": {"MeshVolume": ..., ...},     # status == "done"
     "error": "<quarantine reason>",           # status == "error"
     "window": <window ordinal that produced the row>}

Resume guarantees (``tests/test_torch_resilience.py``, ``chip_smoke.py``
phase 11): a run preempted mid-stream and resumed writes the record set
of an uninterrupted run, bitwise; no case id is lost or duplicated; at
most one window of extraction work is redone.

On the card, under ``schedule='static'`` and ``prep='hint'``, a whole
:meth:`ResilientRunner.run` makes no host sync but the collects' counted
fetches: the loads, the hashing and the manifest writes are host work on
host arrays, the submits queue launches and copies only, and a retry's
backoff and re-submit sync nothing (``PlanExecutor.strict_syncs``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import time
from pathlib import Path

import numpy as np

from repro_torch.core.plan import feature_names as _plan_feature_names
from repro_torch.runtime.fault_tolerance import PreemptionHandler, StragglerDetector

# the default shape-only row's column names; pass ``plan.feature_names(
# families)`` as ``feature_names=`` for wider rows
FEATURE_NAMES = _plan_feature_names()


class InjectedFault(RuntimeError):
    """A fault raised by :class:`FaultPlan` (told apart from real bugs)."""


# ---------------------------------------------------------------------------
# resumable run manifest
# ---------------------------------------------------------------------------


class RunManifest:
    """Append-only JSONL run manifest with a content-hashed done-set.

    See the module docstring for the record format and the resume
    guarantees.  ``fsync=True`` also fsyncs every record (safe against
    power loss, much slower on many small rows; the default flush per
    record already survives a process kill, the preemption threat).
    """

    def __init__(self, path, fsync: bool = False):
        self.path = Path(path)
        self.fsync = fsync
        self._done: dict[str, dict] = {}
        self._f = None
        self._loaded = False

    # -- identity ------------------------------------------------------------

    @staticmethod
    def case_id(mask, spacing) -> str:
        """Content hash of one case: mask bytes + shape + dtype + spacing.

        Independent of the case's name, its position and its loader, and
        an integrity check: a changed input hashes to a new case.  ``mask``
        is a host array (numpy, or a CPU tensor): hashing never touches
        the card.
        """
        m = np.ascontiguousarray(np.asarray(mask))
        h = hashlib.blake2b(digest_size=16)
        h.update(repr((m.shape, str(m.dtype))).encode())
        h.update(m.tobytes())
        h.update(np.asarray(spacing, np.float64).tobytes())
        return h.hexdigest()

    # -- read / resume -------------------------------------------------------

    def resume(self) -> set[str]:
        """Load the manifest; return the done-set of case ids.

        Repairs a torn tail: a process killed mid-write leaves a last line
        with no terminator or with invalid JSON; every complete record
        before it is kept, the torn bytes are truncated away so the next
        append starts on a clean line, and the cut case runs again (it was
        never committed).
        """
        self.close()
        self._done = {}
        self._loaded = True
        if not self.path.exists():
            return set()
        data = self.path.read_bytes()
        good_end = 0
        pos = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl < 0:
                break  # unterminated tail: a torn write
            try:
                rec = json.loads(data[pos:nl])
                rid = rec["id"]
            except (ValueError, KeyError, TypeError):
                break  # a corrupt line: everything after it is suspect
            self._done.setdefault(rid, rec)
            pos = good_end = nl + 1
        if good_end < len(data):  # the repair: truncate the torn tail
            with open(self.path, "r+b") as f:
                f.truncate(good_end)
        return set(self._done)

    @property
    def done(self) -> dict:
        """``{case id: record}`` of committed rows (after :meth:`resume`)."""
        return self._done

    def rows(self) -> list[dict]:
        """Committed records, in first-written order."""
        return list(self._done.values())

    # -- write ---------------------------------------------------------------

    def record(self, case_id: str, status: str, *, name=None, features=None,
               error=None, window=None) -> bool:
        """Append one record; returns False (and writes nothing) if the id
        is already done.

        The idempotence is the manifest's dedup guarantee: a re-run window
        whose rows were partly committed before a kill records only the
        missing cases.  One ``write`` a record on an append stream keeps
        each line whole against other writers, and the torn-tail repair
        handles a line cut by a kill.
        """
        if not self._loaded:
            self.resume()
        if case_id in self._done:
            return False
        rec = {"id": case_id, "status": status}
        if name is not None:
            rec["name"] = name
        if status == "done":
            rec["features"] = {k: float(v) for k, v in (features or {}).items()}
        if error is not None:
            rec["error"] = str(error)
        if window is not None:
            rec["window"] = int(window)
        if self._f is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "ab")
        self._f.write((json.dumps(rec, sort_keys=True) + "\n").encode())
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._done[case_id] = rec
        return True

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        self.resume()
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

# the executor's fetch stages of a window's collect (a transient fault
# targets these, so a submit never dies half-planned; under static + hint
# they are the only fetch stages there are)
COLLECT_STAGES = frozenset(
    ("pass2", "pass2a", "pass2b", "pass2b_counts", "pass2b_retry",
     "collect_counts", "hint_retry")
)


@dataclasses.dataclass
class FaultPlan:
    """Seeded, deterministic fault injection.

    Every per-case decision is keyed by ``(seed, case index)`` and every
    per-window one by ``(seed, window ordinal)``, so a resumed run replays
    the same faults, and a faulted, preempted and resumed manifest can be
    held equal to the faulted uninterrupted one.

    * ``load_error_rate``: the case raises :class:`InjectedFault` at load
      (a corrupt file, a dead mount) -> quarantined by name;
    * ``poison_nan_rate``: the mask becomes a float copy with NaNs in it
      -> quarantined by the executor's validation, an ``error`` record;
    * ``poison_empty_rate``: the mask is zeroed -> an all-zero row (not an
      error);
    * ``window_fault_rate`` / ``fail_windows``: one transient
      :class:`InjectedFault` in each chosen window, raised from the
      executor's ``transfer_callback`` in its collect -> the
      :class:`RetryPolicy` path;
    * ``preempt_at_case``: at this case ordinal the runner sends the
      process a real ``SIGTERM`` (once), which the installed
      :class:`PreemptionHandler` takes as a cluster's preemption notice;
    * ``straggle_windows`` + ``straggle_seconds``: latency added inside
      those windows' timed collect, for the :class:`StragglerDetector`.
    """

    seed: int = 0
    load_error_rate: float = 0.0
    poison_nan_rate: float = 0.0
    poison_empty_rate: float = 0.0
    window_fault_rate: float = 0.0
    fail_windows: tuple = ()
    preempt_at_case: int | None = None
    straggle_windows: tuple = ()
    straggle_seconds: float = 0.0

    def __post_init__(self):
        self._preempted = False
        self._pending_fault = None
        self._spent_windows: set[int] = set()

    # -- per-case faults -----------------------------------------------------

    def inject_case(self, index: int, case):
        """Apply this plan's per-case faults to ``(image, mask, spacing)``.

        Raises :class:`InjectedFault` for a load-error case; returns the
        (possibly poisoned) case otherwise.  Deterministic per index.
        """
        r = np.random.default_rng((self.seed, 101, index)).random(3)
        if r[0] < self.load_error_rate:
            raise InjectedFault(f"load error injected at case {index}")
        image, mask, spacing = case
        if r[1] < self.poison_nan_rate:
            bad = np.asarray(mask, np.float32).copy()
            flat = bad.reshape(-1)
            idx = np.random.default_rng((self.seed, 102, index)).integers(
                0, flat.size, size=max(1, flat.size // 64)
            )
            flat[idx] = np.nan
            return image, bad, spacing
        if r[2] < self.poison_empty_rate:
            return image, np.zeros_like(np.asarray(mask)), spacing
        return image, mask, spacing

    # -- per-window faults ---------------------------------------------------

    def begin_window(self, widx: int):
        """Arm (at most) one transient collect fault for window ``widx``."""
        if widx in self._spent_windows:
            return
        armed = widx in self.fail_windows
        if not armed and self.window_fault_rate:
            armed = (
                np.random.default_rng((self.seed, 103, widx)).random()
                < self.window_fault_rate
            )
        if armed:
            self._pending_fault = widx

    def transfer_hook(self, stage: str, x):
        """The executor's ``transfer_callback``: raise the armed fault once."""
        if self._pending_fault is not None and stage in COLLECT_STAGES:
            w, self._pending_fault = self._pending_fault, None
            self._spent_windows.add(w)
            raise InjectedFault(
                f"transient collect fault injected (window {w}, stage {stage})"
            )

    def maybe_straggle(self, widx: int):
        """Sleep inside window ``widx``'s timed region (a straggler)."""
        if widx in self.straggle_windows and self.straggle_seconds > 0:
            time.sleep(self.straggle_seconds)

    def should_preempt(self, index: int) -> bool:
        """True exactly once, when the case ordinal reaches the trigger."""
        if self.preempt_at_case is None or self._preempted:
            return False
        if index >= self.preempt_at_case:
            self._preempted = True
            return True
        return False


# ---------------------------------------------------------------------------
# retry / backoff policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-window retry with exponential backoff (no jitter: deterministic).

    Read by ``PlanExecutor.collect_window``: a window whose collect raises
    is re-submitted from its prepped device state and drained again after
    ``base_delay * multiplier^k`` seconds (at most ``max_delay``), up to
    ``max_retries`` times; the last failure re-raises.  ``timeout_s`` is
    advisory: a collect over it is flagged in the window stats
    (``collect_timeout``), since a blocking fetch cannot be interrupted.
    """

    max_retries: int = 2
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    timeout_s: float | None = None

    def delay(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based)."""
        return min(self.base_delay * self.multiplier ** attempt, self.max_delay)


# ---------------------------------------------------------------------------
# the resilient run driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunReport:
    """What one :meth:`ResilientRunner.run` call did."""

    status: str = "complete"  # 'complete' | 'preempted'
    skipped: int = 0          # cases already in the manifest (or re-recorded)
    processed: int = 0        # rows written this run (done + error)
    quarantined: int = 0      # of processed: row-level error records
    windows: int = 0          # windows collected this run
    window_retries: int = 0   # collect retries the executor performed
    stragglers: list = dataclasses.field(default_factory=list)
    seconds: float = 0.0

    @property
    def cases_per_second(self) -> float:
        return self.processed / self.seconds if self.seconds > 0 else 0.0


class ResilientRunner:
    """Drive an extractor over a case stream with full resilience.

    ``cases`` yields ``(name, image, mask, spacing)`` tuples or lazy
    ``(name, loader)`` pairs (``loader() -> (image, mask, spacing)``); a
    lazy loader keeps a load fault a per-case quarantine.  The runner
    submits window k+1 before it drains window k, as ``extract_stream``
    does, and does its duties at the window boundaries:

    * the done-set skip by content id, before any prep;
    * per-case quarantine through the executor's safe prep (a poisoned
      case becomes an ``error`` record, never a window abort);
    * one manifest ``record`` a row as each window drains (a kill loses
      at most the in-flight window);
    * a preemption check at every case: on ``SIGTERM`` the open buffer is
      dropped and, with ``drain_on_preempt=True`` (a grace period), the
      submitted window is still drained and committed, so at most one
      window of work is ever redone;
    * each window's collect time observed by the straggler detector and
      passed to ``stats_callback(widx, census)``.

    ``preemption``: a :class:`PreemptionHandler` to read; without one, the
    run installs its own on ``SIGTERM`` and removes it at the end, which
    CPython allows from the main thread only (see
    :class:`PreemptionHandler`).
    """

    def __init__(self, extractor, manifest: RunManifest, *, window: int = 16,
                 fault_plan: FaultPlan | None = None,
                 straggler: StragglerDetector | None = None,
                 preemption: PreemptionHandler | None = None,
                 drain_on_preempt: bool = True, stats_callback=None,
                 feature_names=FEATURE_NAMES):
        if not isinstance(window, int) or window < 1:
            raise ValueError(f"window must be a positive int, got {window!r}")
        self.extractor = extractor
        self.ex = getattr(extractor, "executor", extractor)
        self.manifest = manifest
        self.window = window
        self.fault_plan = fault_plan
        self.straggler = straggler or StragglerDetector(
            window=8, warmup=1, min_samples=4
        )
        self.preemption = preemption
        self.drain_on_preempt = drain_on_preempt
        self.stats_callback = stats_callback
        self.feature_names = tuple(feature_names)

    # -- internals -----------------------------------------------------------

    def _load(self, index: int, item):
        """Materialise one case; faults (injected or real) raise here."""
        if len(item) == 2 and callable(item[1]):
            case = item[1]()
        else:
            case = tuple(item[1:])
        if self.fault_plan is not None:
            case = self.fault_plan.inject_case(index, case)
        if len(case) != 3:
            raise ValueError(f"case must be (image, mask, spacing), "
                             f"got {len(case)} elements")
        return case

    def _collect(self, pending, report: RunReport):
        """Drain one submitted window; write its manifest rows."""
        widx, state, recs = pending
        fp = self.fault_plan
        if fp is not None:
            fp.begin_window(widx)
        t0 = time.perf_counter()
        if fp is not None:
            fp.maybe_straggle(widx)  # inside the timed region
        rows, stats = self.ex.collect_window(state)
        dt = time.perf_counter() - t0
        slow = self.straggler.observe(widx, dt)
        if slow:
            report.stragglers.append((widx, dt))
        errors = stats.get("errors", {})
        for j, ((cid, name), row) in enumerate(zip(recs, rows)):
            # quarantine is keyed off the executor's window-relative
            # ``errors`` map, not off a NaN in the row: a real feature row
            # may hold a NaN value and is still ``done``
            if j in errors:
                wrote = self.manifest.record(
                    cid, "error", name=name, error=errors[j], window=widx
                )
                if wrote:
                    report.processed += 1
                    report.quarantined += 1
                else:
                    report.skipped += 1
                continue
            wrote = self.manifest.record(
                cid, "done", name=name,
                features=dict(zip(self.feature_names, np.asarray(row))),
                window=widx,
            )
            if wrote:
                report.processed += 1
            else:
                report.skipped += 1
        report.windows += 1
        if self.stats_callback is not None:
            census = dict(state.plan.stats())
            census.update(
                window=widx, seconds=dt, straggler=slow,
                quarantined=stats.get("quarantined_cases", 0),
                straggler_median=self.straggler.median,
            )
            self.stats_callback(widx, census)

    # -- driving -------------------------------------------------------------

    def run(self, cases) -> RunReport:
        """Stream ``cases`` through the extractor with full resilience."""
        ex = self.ex
        man = self.manifest
        if not man._loaded:
            man.resume()
        handler = self.preemption or PreemptionHandler()
        own_handler = self.preemption is None
        handler.install()
        report = RunReport()
        retries0 = getattr(ex, "window_retries", 0)
        t0 = time.perf_counter()
        pending = None  # (widx, submitted window, [(case id, name)])
        buf: list = []  # [(case id, name, prepped)]
        widx = 0
        preempted = False
        fp = self.fault_plan
        try:
            for index, item in enumerate(cases):
                if fp is not None and fp.should_preempt(index):
                    os.kill(os.getpid(), signal.SIGTERM)  # the real signal
                if handler.requested:
                    preempted = True
                    break
                name = item[0]
                try:
                    case = self._load(index, item)
                    cid = RunManifest.case_id(case[1], case[2])
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:
                    # a load error has no content to hash: it is quarantined
                    # under a name-keyed id, so a resume over a filtered or
                    # reordered stream recognises the record; the stream
                    # index is the tiebreaker of anonymous cases only
                    eid = f"load-error:{name}" if name else f"load-error:@{index}"
                    if man.record(eid, "error", name=name,
                                  error=f"{type(e).__name__}: {e}"):
                        report.processed += 1
                        report.quarantined += 1
                    else:
                        report.skipped += 1
                    continue
                if cid in man.done:
                    report.skipped += 1
                    continue
                buf.append((cid, name, ex.prep_case(case)))
                if len(buf) >= self.window:
                    # submit k+1 before draining k: the stream's overlap
                    state = ex.submit_prepped([p for _, _, p in buf])
                    if pending is not None:
                        self._collect(pending, report)
                    pending = (widx, state, [(c, n) for c, n, _ in buf])
                    buf = []
                    widx += 1
            if not preempted and buf:
                state = ex.submit_prepped([p for _, _, p in buf])
                if pending is not None:
                    self._collect(pending, report)
                pending = (widx, state, [(c, n) for c, n, _ in buf])
                buf = []
                widx += 1
            if pending is not None and (not preempted or self.drain_on_preempt):
                # the grace-period drain: committing the submitted window
                # bounds the redo to the dropped open buffer
                self._collect(pending, report)
                pending = None
            # drain_on_preempt=False models a hard kill: the in-flight
            # window is dropped uncollected and redone by the resume.  Its
            # copies into pinned memory may still be running; the pinned
            # cache hands those blocks out again only after the copies
            # land (``executor._Staged``), so a resume in this process
            # neither reads nor reuses them early (chip_smoke.py 11b).
        finally:
            if own_handler:
                handler.uninstall()
            man.flush()
        report.status = "preempted" if (preempted or handler.requested) \
            else "complete"
        report.seconds = time.perf_counter() - t0
        report.window_retries = getattr(ex, "window_retries", 0) - retries0
        return report
