"""The traced window: host spans around the program's layers, the device
trace, and their reduction to busy time, launches, kernel time and idle gaps.

``spans(patches)`` wraps program callables in ``record_function`` spans
named ``radbench.<layer>`` for a traced run only (the untraced run calls
the program unwrapped).  ``Trace`` runs ``torch.profiler`` over the window
(CPU and CUDA activities) and ``Trace.summary()`` reduces its events:

* device activity: kernels, copies and sets (``kernel``, ``gpu_memcpy``,
  ``gpu_memset``), clipped to the ``radbench.window`` span;
* ``busy_s``: the length of the union of those intervals;
* ``launches``: their count;
* ``kernel_s``: device seconds by trace name;
* ``idle``: the seconds of each gap between device activity, named by the
  innermost ``radbench.*`` host span that covers the gap's midpoint
  (``radbench.none``: no span, the host waiting for work).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "radbench.window"


@contextlib.contextmanager
def spans(patches):
    """Wrap each ``(module, dotted attribute, span name)`` of ``patches`` in a
    ``record_function`` span while the context is open."""
    undo = []
    try:
        for module, attr, name in patches:
            owner = importlib.import_module(module)
            *path, leaf = attr.split(".")
            for p in path:
                owner = getattr(owner, p)
            orig = owner.__dict__[leaf] if leaf in getattr(owner, "__dict__", {}) \
                else getattr(owner, leaf)
            fn = orig.__func__ if isinstance(orig, staticmethod) else orig

            def wrapped(*a, _fn=fn, _name=name, **k):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **k)

            functools.update_wrapper(wrapped, fn)
            setattr(owner, leaf, staticmethod(wrapped) if isinstance(orig, staticmethod)
                    else wrapped)
            undo.append((owner, leaf, orig))
        yield
    finally:
        for owner, leaf, orig in reversed(undo):
            setattr(owner, leaf, orig)


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    launches: int
    kernel_s: dict  # trace name -> device seconds
    idle: dict  # host span -> idle device seconds

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s if self.window_s > 0 else 0.0

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[short_name(k), v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def short_name(name: str) -> str:
    """A trace name without its argument list, at most 120 characters."""
    return name.split("(")[0][:120]


class Trace:
    """``torch.profiler`` over a window; the window itself is the span
    ``radbench.window`` that :meth:`window` opens."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self.events = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            kw = {}
            try:  # spans of every thread: the service's driver and its clients too
                kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
                    profile_all_threads=True)
            except (AttributeError, TypeError):
                pass  # a PyTorch without the option traces the calling thread's spans
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self.events = [event_tuple(e) for e in self._prof.profiler.kineto_results.events()]
            self._prof = None

    def window(self):
        return (torch.profiler.record_function(WINDOW_SPAN) if self.enabled
                else contextlib.nullcontext())

    def summary(self) -> Summary | None:
        if not self.events:
            return None
        return summarize(self.events)


def _activity(kind: str) -> str:
    return kind.split(".")[-1].lower()


def event_tuple(e) -> tuple:
    """``(name, activity, start ns, end ns, device type)`` of a kineto event.
    Where the event does not carry its activity type, it is told from the
    device type and the name: a host event named ``radbench.*`` is a user
    annotation, a device event a kernel, copy or set unless it is the
    device's echo of an annotation."""
    name, dev = e.name(), str(e.device_type())
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        kind = str(kind())
    elif dev.endswith("CPU"):
        kind = "user_annotation" if name.startswith("radbench.") else "cpu_op"
    elif name.startswith("radbench."):
        kind = "gpu_user_annotation"
    elif name.startswith("Memcpy"):
        kind = "gpu_memcpy"
    elif name.startswith("Memset"):
        kind = "gpu_memset"
    else:
        kind = "kernel"
    start = int(e.start_ns())
    return name, kind, start, start + int(e.duration_ns()), dev


def summarize(events) -> Summary | None:
    """Reduce ``(name, activity, start ns, end ns, device type)`` events."""
    host = [(n, s, e) for n, a, s, e, d in events
            if _activity(a) == "user_annotation" and n.startswith("radbench.")]
    win = [(s, e) for n, s, e in host if n == WINDOW_SPAN]
    if not win:
        return None
    w0, w1 = min(s for s, _ in win), max(e for _, e in win)
    dev = sorted((max(s, w0), min(e, w1), n) for n, a, s, e, d in events
                 if _activity(a) in DEVICE_ACTIVITIES and e > w0 and s < w1)
    kernel_s: dict = {}
    for s, e, n in dev:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) * 1e-9
    gaps = []  # (midpoint, seconds)
    busy = 0
    cursor = w0
    for s, e, _ in dev + [(w1, w1, None)]:
        if s > cursor:
            gaps.append(((s + cursor) // 2, (s - cursor) * 1e-9))
        busy += max(0, e - max(s, cursor))
        cursor = max(cursor, e)
    return Summary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, launches=len(dev),
                   kernel_s=kernel_s, idle=name_gaps(gaps, host))


def name_gaps(gaps, host) -> dict:
    """Idle seconds by the innermost ``radbench.*`` span (other than the
    window) covering each gap's midpoint, by a sweep over time."""
    points = [(s, 0, i) for i, (_, s, _) in enumerate(host) if host[i][0] != WINDOW_SPAN]
    points += [(e, 2, i) for i, (_, _, e) in enumerate(host) if host[i][0] != WINDOW_SPAN]
    points += [(mid, 1, j) for j, (mid, _) in enumerate(gaps)]
    active: dict = {}
    idle: dict = {}
    for _, kind, i in sorted(points):
        if kind == 0:
            active[i] = host[i][2] - host[i][1]
        elif kind == 2:
            active.pop(i, None)
        else:
            name = host[min(active, key=active.get)][0] if active else "radbench.none"
            idle[name] = idle.get(name, 0.0) + gaps[i][1]
    return idle
