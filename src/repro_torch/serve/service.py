"""Radiomics as a service: a persistent multi-tenant extraction service.

Counterpart of ``repro.serve.service``.  The batch pipeline answers
"extract these cases"; this module answers "keep extracting, for everyone".
Under ``prep='hint'`` and ``schedule='static'`` a window is submitted
without a host sync, so cases of unrelated clients can be fused into
shared windows and the card never waits on one client.

Architecture (one driver thread does all device work)::

    client threads                 driver thread (inside torch.cuda.device
    --------------                 of the executor's card, for its life)
    submit(cases, deadline_s=..)   loop:
      |  admission control           pull queued cases (FIFO across
      |  (bounded queue BYTES          tenants: arrival order is the
      |   via plan.meta_bytes;         fusion order)
      |   block / Overloaded)        expired request? -> deadline error,
      v                                no window slot occupied
    [FIFO queue of (req, case)]      prep (executor.prep_case) + census
      ...                            close the open window when:
    future.result()  <---------        * CostModel.should_close (the
         rows + errors,                  throughput rule), or
         input order                   * CostModel.deadline_at_risk (the
                                         latency rule, the oldest pending
                                         deadline), or
                                       * the queue went idle
                                     submit window k+1 before collecting
                                       window k (extract_stream's
                                       overlap), demux rows to futures

Contracts:

* **parity**: served rows equal ``extract_stream``'s and ``run``'s on the
  same cases, bitwise (``tests/test_torch_service.py``);
* **backpressure**: admission is bounded by estimated queue bytes
  (``plan.meta_bytes`` of a metadata-only ``CaseMeta`` at the uncropped
  shape, an over-estimate): a full queue blocks the submitter or raises
  :class:`ServiceOverloaded` (``block=False``); a request larger than the
  whole budget is admitted alone, against an empty queue;
* **deadlines**: ``deadline_s`` is relative to submit.  A request whose
  deadline passes while it is queued completes with a
  :class:`DeadlineExceeded` error and a NaN row per unprocessed case and
  never occupies a window slot; a request admitted to a window is always
  delivered (``ServeResult.late`` if after its deadline);
* **quarantine**: a poisoned or unloadable case gives the executor's NaN
  row and message, in ``ServeResult.errors`` at the request's own case
  index; its co-tenants' rows are unchanged;
* **failure**: a Python-level error while collecting a window becomes
  error rows of that window's requests only.  A ``RuntimeError`` from a
  launch or a copy (a CUDA error; in a case's prep, the executor's
  ``DEVICE_ERRORS``) stops the driver: every in-flight and queued request
  fails, and :meth:`ExtractionService.close` and the next
  :meth:`ExtractionService.submit` raise it as the service's failure.

``BatchedExtractor.serve()`` is the facade's entry point and
``python -m repro_torch.launch.serve`` the CLI.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import numpy as np
import torch

from repro_torch.core import plan as planlib


class ServiceError(RuntimeError):
    """Base class of service-level failures."""


class ServiceClosed(ServiceError):
    """The service no longer accepts requests (closed, or its driver failed)."""


class ServiceOverloaded(ServiceError):
    """Admission control refused the request (the queue byte budget is full)."""


class DeadlineExceeded(ServiceError):
    """The request's deadline passed before its cases reached a window."""


DEFAULT_MAX_QUEUE_MB = 256.0
# byte charge of a loader case whose shape is unknown at admission (callers
# that know their shapes pass ``shape_hints=``), sized like a mid-range
# Table-2 case so loader-heavy traffic still meets backpressure
DEFAULT_LOADER_CASE_BYTES = 8 << 20


def _peek_loader_shape(loader):
    """``(shape, spacing)`` from the NIfTI path a loader carries, if any.

    A loader that wants byte-accurate admission exposes the mask file it
    will read as ``path``, ``nifti_path`` or ``mask_path`` (an attribute, or
    a ``functools.partial`` keyword); only the 352-byte header is read.  Any
    failure gives ``(None, None)``, the flat charge: admission never raises
    on an odd loader.
    """
    for attr in ("path", "nifti_path", "mask_path"):
        path = getattr(loader, attr, None)
        if path is None:
            kw = getattr(loader, "keywords", None)  # functools.partial
            path = kw.get(attr) if isinstance(kw, dict) else None
        if path is None:
            continue
        try:
            from repro_torch.data.nifti import read_nifti_header

            hdr = read_nifti_header(path)
        except Exception:
            continue
        return tuple(int(s) for s in hdr.shape3), np.asarray(hdr.spacing, np.float32)
    return None, None


def estimate_case_bytes(case, needs_intensity: bool = False, shape_hint=None) -> int:
    """Admission-control byte estimate of one queued case.

    ``plan.meta_bytes`` of a :class:`plan.CaseMeta` built from the uncropped
    mask shape (its hint-sized vertex cap, the image too with an intensity
    family): known before any prep runs, and an over-estimate, since pass 0
    crops first.  A loader is sized by ``shape_hint`` or by a NIfTI header
    peek (:func:`_peek_loader_shape`), else charged
    :data:`DEFAULT_LOADER_CASE_BYTES`.
    """
    shape = spacing = None
    if shape_hint is not None:
        shape = tuple(int(s) for s in shape_hint)
    elif callable(case):
        shape, spacing = _peek_loader_shape(case)
    else:
        try:
            _, mask, spacing = case
            shape = tuple(int(s) for s in np.shape(mask))
        except (TypeError, ValueError):
            shape = None
    if shape is None or len(shape) != 3:
        return DEFAULT_LOADER_CASE_BYTES
    hint = planlib.vertex_hint(shape, spacing)
    meta = planlib.CaseMeta(shape=planlib.shape_bucket(shape), roi_shape=shape,
                            vertex_cap=planlib.vertex_bucket(hint), n_vertices=hint,
                            intensity=needs_intensity)
    return planlib.meta_bytes(meta)


@dataclasses.dataclass
class ServeResult:
    """What one request got back: rows in the request's own case order."""

    rows: list  # one (n_features,) float32 row per case
    errors: dict  # {case index: message}: quarantine, deadline or failure
    latency_s: float = 0.0  # submit -> last row resolved
    late: bool = False  # delivered after its deadline

    @property
    def ok(self) -> bool:
        return not self.errors


class ServeFuture:
    """The handle a client waits on for one submitted request."""

    def __init__(self, request: "_Request"):
        self._req = request

    def done(self) -> bool:
        return self._req.event.is_set()

    def result(self, timeout: float | None = None) -> ServeResult:
        """Blocks until the request resolves; ``TimeoutError`` after
        ``timeout`` seconds."""
        if not self._req.event.wait(timeout):
            raise TimeoutError(f"request {self._req.rid} not resolved within {timeout}s")
        r = self._req
        return ServeResult(rows=list(r.rows), errors=dict(r.errors),
                           latency_s=r.done_t - r.submit_t,
                           late=(r.deadline is not None and r.done_t > r.deadline))


class _Request:
    """Driver-side state of one submitted request."""

    __slots__ = ("rid", "tenant", "deadline", "submit_t", "done_t", "rows", "errors",
                 "remaining", "case_bytes", "event")

    def __init__(self, rid: int, tenant: str, n_cases: int, deadline: float | None,
                 case_bytes: list):
        self.rid = rid
        self.tenant = tenant
        self.deadline = deadline  # absolute time.monotonic()
        self.submit_t = time.monotonic()
        self.done_t = 0.0
        self.rows: list = [None] * n_cases
        self.errors: dict = {}
        self.remaining = n_cases
        self.case_bytes = case_bytes
        self.event = threading.Event()


class ExtractionService:
    """Persistent multi-tenant extraction service over one executor.

    See the module docstring for the architecture and contracts.  Client
    threads only estimate bytes and enqueue; the driver thread, started at
    construction, does every prep, launch and fetch, inside
    ``torch.cuda.device`` of the executor's card.  ``close()`` (or the
    context manager) drains what is queued and joins it.

    ``max_queue_bytes`` bounds the estimated bytes of queued, unresolved
    cases; ``idle_tick_s`` is how long the driver waits for more traffic
    before it ships a non-empty window, and its deadline-check cadence.
    """

    def __init__(self, extractor, *, max_queue_bytes: float | None = None,
                 idle_tick_s: float = 0.002,
                 loader_case_bytes: int = DEFAULT_LOADER_CASE_BYTES):
        self.ex = getattr(extractor, "executor", extractor)
        if max_queue_bytes is None:
            max_queue_bytes = DEFAULT_MAX_QUEUE_MB * 2**20
        self.max_queue_bytes = float(max_queue_bytes)
        self.idle_tick_s = float(idle_tick_s)
        self.loader_case_bytes = int(loader_case_bytes)
        self._needs_intensity = planlib.needs_intensity(self.ex.families)

        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._queue_bytes = 0
        self._rid = itertools.count()
        self._closing = False
        self._failure: BaseException | None = None

        # census (snapshot via .stats())
        self._windows: list = []  # [(cases, tenants)] per window
        self._served_cases = 0
        self._expired_cases = 0
        self._quarantined_cases = 0
        self._requests = 0

        self._driver = threading.Thread(target=self._drive, name="repro-torch-serve-driver",
                                        daemon=True)
        self._driver.start()

    # -- client surface ------------------------------------------------------

    def submit(self, cases, *, tenant: str = "default", deadline_s: float | None = None,
               shape_hints=None, block: bool = True,
               timeout: float | None = None) -> ServeFuture:
        """Enqueue a batch of cases; returns a :class:`ServeFuture`.

        Each case is an ``(image, mask, spacing)`` tuple or a zero-argument
        loader.  ``deadline_s`` is relative to now; ``shape_hints`` (one mask
        shape per case) sizes loader cases.  A full queue blocks
        (``block=True``, up to ``timeout`` seconds) or raises
        :class:`ServiceOverloaded`.
        """
        cases = list(cases)
        if not cases:
            raise ValueError("submit() needs at least one case")
        hints = list(shape_hints) if shape_hints is not None else [None] * len(cases)
        if len(hints) != len(cases):
            raise ValueError("shape_hints must match cases 1:1")
        case_bytes = [
            self.loader_case_bytes if (callable(c) and h is None)
            else estimate_case_bytes(c, self._needs_intensity, h)
            for c, h in zip(cases, hints)
        ]
        need = sum(case_bytes)
        deadline = None if deadline_s is None else time.monotonic() + deadline_s
        t_wait0 = time.monotonic()
        with self._cond:
            # a request over the whole budget can never fit beside other
            # traffic: it is admitted alone, when the queue has drained
            while self._queue_bytes + need > self.max_queue_bytes and self._queue_bytes > 0:
                self._raise_if_down()
                if not block:
                    raise ServiceOverloaded(
                        f"queue at {self._queue_bytes}B + {need}B would exceed the "
                        f"{int(self.max_queue_bytes)}B budget")
                remaining = None if timeout is None else timeout - (time.monotonic() - t_wait0)
                if remaining is not None and remaining <= 0:
                    raise ServiceOverloaded(f"queue still over budget after {timeout}s")
                self._cond.wait(remaining if remaining is not None else self.idle_tick_s * 50)
            self._raise_if_down()
            req = _Request(next(self._rid), tenant, len(cases), deadline, case_bytes)
            self._requests += 1
            self._queue_bytes += need
            for ci, case in enumerate(cases):
                self._queue.append((req, ci, case))
            self._cond.notify_all()
        return ServeFuture(req)

    def submit_case(self, case, **kw) -> ServeFuture:
        """Single-case form of :meth:`submit`."""
        return self.submit([case], **kw)

    def stats(self) -> dict:
        """Snapshot of the service census (windows, fusion, expiries)."""
        with self._cond:
            return {
                "requests": self._requests,
                "served_cases": self._served_cases,
                "expired_cases": self._expired_cases,
                "quarantined_cases": self._quarantined_cases,
                "windows": len(self._windows),
                "window_cases": [n for n, _ in self._windows],
                "window_tenants": [t for _, t in self._windows],
                "queue_bytes": self._queue_bytes,
            }

    def close(self, timeout: float | None = None):
        """Stop accepting requests, drain what is queued, join the driver.

        Raises :class:`ServiceError` chained to the driver's failure if the
        driver died (a CUDA error in a launch or a copy), on every call.
        """
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        self._driver.join(timeout)
        if self._driver.is_alive():
            raise TimeoutError("service driver did not drain in time")
        if self._failure is not None:
            raise ServiceError(f"service driver failed: {self._failure!r}") from self._failure

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- driver internals ----------------------------------------------------

    def _raise_if_down(self):
        if self._failure is not None:
            raise ServiceClosed(f"service driver failed: {self._failure!r}") from self._failure
        if self._closing:
            raise ServiceClosed("service is closed")

    def _next_item(self, timeout: float | None):
        """Pops one queued case; None on an idle timeout or a drained close."""
        with self._cond:
            while not self._queue:
                if self._closing:
                    return None
                if timeout is not None:
                    self._cond.wait(timeout)
                    if not self._queue:
                        return None
                else:
                    self._cond.wait()
            return self._queue.popleft()

    def _resolve(self, req: _Request, ci: int, row, error: str | None):
        """Delivers one case's outcome to its request (driver thread)."""
        if row is None:
            row = np.full(self.ex.n_features, np.nan, np.float32)
        req.rows[ci] = np.asarray(row)
        if error is not None:
            req.errors[ci] = str(error)
        req.remaining -= 1
        done = req.remaining == 0
        if done:
            req.done_t = time.monotonic()
        with self._cond:
            self._queue_bytes -= req.case_bytes[ci]
            if error is None:
                self._served_cases += 1
            elif error.startswith("DeadlineExceeded"):
                self._expired_cases += 1
            else:
                self._served_cases += 1
                self._quarantined_cases += 1
            self._cond.notify_all()  # bytes freed: unblock submitters
        if done:
            req.event.set()

    @staticmethod
    def _oldest_slack_us(buf, now: float) -> float | None:
        deadlines = [r.deadline for r, _, _ in buf if r.deadline is not None]
        if not deadlines:
            return None
        return (min(deadlines) - now) * 1e6

    def _drive(self):
        ex = self.ex
        device = (torch.cuda.device(ex.device) if ex.device.type == "cuda"
                  else contextlib.nullcontext())
        buf: list = []  # [(req, ci, prepped)]
        census = planlib.WindowCensus()
        pending = None  # (submitted window, [(req, ci)])
        draining: list = []  # the [(req, ci)] of the window being collected
        prepping: list = []  # the (req, ci) whose case is being prepped

        def drain(entry):
            state, recs = entry
            draining[:] = recs
            try:
                rows, stats = ex.collect_window(state)
            except (KeyboardInterrupt, SystemExit, RuntimeError):
                raise  # a CUDA error is the service's failure, not a row's
            except Exception as e:  # a Python-level failure: this window's requests
                draining.clear()
                for req, ci in recs:
                    self._resolve(req, ci, None, f"{type(e).__name__}: {e}")
                return
            draining.clear()
            errors = stats.get("errors", {})
            for j, (req, ci) in enumerate(recs):
                self._resolve(req, ci, rows[j], errors.get(j))

        def flush():
            nonlocal buf, census, pending
            state = ex.submit_prepped([p for _, _, p in buf])
            recs = [(r, ci) for r, ci, _ in buf]
            with self._cond:
                self._windows.append((len(buf), len({r.tenant for r, _, _ in buf})))
            prev, pending = pending, (state, recs)
            buf, census = [], planlib.WindowCensus()
            if prev is not None:
                drain(prev)  # window k+1 submitted before window k drains

        try:
            with device:
                cm = ex.cost_model.resolve()  # any probe syncs here, before a window
                while True:
                    busy = bool(buf) or pending is not None
                    item = self._next_item(self.idle_tick_s if busy else None)
                    now = time.monotonic()
                    if buf and cm.deadline_at_risk(census, self._oldest_slack_us(buf, now)):
                        flush()  # the latency rule: ship before the deadline
                    if item is None:
                        if buf:
                            flush()  # the queue went idle: nothing to fuse
                        elif pending is not None:
                            drain(pending)
                            pending = None
                        elif self._closing and not self._queue:
                            return
                        continue
                    req, ci, case = item
                    if req.deadline is not None and now >= req.deadline:
                        # expired while queued: a deadline error, no window slot
                        self._resolve(req, ci, None,
                                      f"DeadlineExceeded: expired "
                                      f"{(now - req.deadline) * 1e3:.1f}ms before reaching "
                                      f"a window")
                        continue
                    prepping[:] = [(req, ci)]
                    p = ex.prep_case(case)
                    meta = ex.case_meta(p)
                    if buf and cm.should_close(census, meta):
                        flush()  # the throughput rule (as window='auto')
                    buf.append((req, ci, p))
                    prepping.clear()
                    census.add(meta)
        except BaseException as e:  # the driver never dies silently
            with self._cond:
                self._failure = e
                leftovers = list(self._queue)
                self._queue.clear()
                self._cond.notify_all()
            msg = f"ServiceFailed: {e!r}"
            unresolved = {(id(r), ci): (r, ci) for r, ci in itertools.chain(
                prepping, draining, [] if pending is None else pending[1],
                ((r, ci) for r, ci, _ in itertools.chain(buf, leftovers)))}
            for req, ci in unresolved.values():
                self._resolve(req, ci, None, msg)
            if not isinstance(e, Exception):
                raise  # an exception is reported by close() and submit()
