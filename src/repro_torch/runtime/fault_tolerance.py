"""Fault tolerance of a long extraction run: stragglers, preemption and
the surviving mesh.

The port's own copy of the pieces of ``repro.runtime.fault_tolerance``
that the resilience layer (``runtime/resilience``) and a multi-card run
need, without its JAX imports:

  * :class:`StragglerDetector` keeps the median of recent window (or
    step) wall-times and flags one slower than ``threshold x`` that
    median;
  * :class:`PreemptionHandler` turns a ``SIGTERM`` (a cluster's
    preemption notice) into a flag the runner reads at each case;

  * :class:`StepTimer` times one training step on the host's clock (the
    trainer reads the step's loss inside it, so on the card the time
    includes the device work);

and :func:`surviving_mesh`, the largest well-formed ``(data, model)``
mesh (``parallel/sharding.Mesh``) of the cards that survive, and
:func:`elastic_remesh`, which restores the latest checkpoint (of a
training run, say) onto such a mesh, each leaf laid out by the
shardings the caller gives for it.
"""
from __future__ import annotations

import signal
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class StragglerDetector:
    """Median-based outlier detection over step (or window) wall-times.

    ``warmup`` observations are swallowed entirely -- neither flagged nor
    admitted to the median window -- because the first window of a run
    pays its cold start (kernel builds, autotune lookups) and would
    otherwise both be flagged as a spurious straggler and inflate the
    median every real straggler is compared against.  ``min_samples``
    overrides the default ``max(8, window // 4)`` flagging threshold for
    short runs (a 13-window job should still flag its stalled 9th window).
    """

    window: int = 50
    threshold: float = 2.0
    warmup: int = 0
    min_samples: int | None = None
    _times: deque = field(default_factory=lambda: deque(maxlen=256))
    slow_steps: list = field(default_factory=list)
    _seen: int = field(default=0, repr=False)

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; returns True if this step was a straggler."""
        self._seen += 1
        if self._seen <= self.warmup:
            return False  # cold-start grace: excluded from the median too
        self._times.append(seconds)
        need = self.min_samples if self.min_samples is not None \
            else max(8, self.window // 4)
        if len(self._times) < max(2, need):
            return False
        med = sorted(self._times)[len(self._times) // 2]
        if seconds > self.threshold * med:
            self.slow_steps.append((step, seconds, med))
            return True
        return False

    @property
    def median(self):
        if not self._times:
            return 0.0
        return sorted(self._times)[len(self._times) // 2]


class PreemptionHandler:
    """SIGTERM -> request a graceful stop at the next step/window boundary.

    ``install`` CHAINS any pre-existing Python SIGTERM handler (it still
    fires after ours -- two independent layers both get their preemption
    notice) and is idempotent: a second ``install`` is a no-op rather
    than making the handler its own predecessor.  ``uninstall`` restores
    exactly what was installed before -- including ``SIG_DFL``/``SIG_IGN``
    dispositions and the C-level ``None`` case (restored as ``SIG_DFL``,
    the closest Python can express).

    CPython sets a signal handler from the main thread only
    (``signal.signal`` raises ``ValueError`` elsewhere), as in the
    reference: a runner driven from another thread (the service's driver)
    must be given a handler installed on the main thread, or none.
    """

    def __init__(self):
        self.requested = False
        self._prev = None
        self._installed = False

    def install(self):
        if self._installed:
            return self

        def handler(signum, frame):
            self.requested = True
            prev = self._prev
            if callable(prev) and prev is not handler:
                prev(signum, frame)

        self._prev = signal.signal(signal.SIGTERM, handler)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        prev = self._prev if self._prev is not None else signal.SIG_DFL
        signal.signal(signal.SIGTERM, prev)
        self._prev = None
        self._installed = False

    def reset(self):
        """Clear a consumed preemption notice (e.g. between runner calls)."""
        self.requested = False


def surviving_mesh(axis_names=("data", "model"), model_parallel: int = 1, devices=None):
    """The largest well-formed mesh of the surviving devices.

    Drops trailing devices so the data axis stays a whole number: ``n``
    devices give a ``(n // model_parallel, model_parallel)`` mesh over the
    first ``model_parallel * (n // model_parallel)`` of them.  At scale the
    survivors come from a coordinator's health service; here ``devices``
    defaults to every visible card (raising without one).
    """
    import torch

    from repro_torch.core.dispatcher import resolve_device
    from repro_torch.launch.mesh import grid_mesh

    if devices is None:
        resolve_device("cuda")  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return grid_mesh(devices, model_parallel, axis_names)


def elastic_remesh(ckpt_manager, skeleton, make_shardings, *, devices=None,
                   model_parallel: int = 1):
    """Resume the latest checkpoint on a smaller (surviving) mesh.

    Builds :func:`surviving_mesh` of ``devices`` (default every visible
    card), reads the newest readable checkpoint of ``ckpt_manager`` (a
    ``runtime/checkpoint.CheckpointManager``) into ``skeleton``'s structure
    memory-mapped on the host, and lays each leaf out by the
    ``parallel/sharding.NamedSharding`` at its place in
    ``make_shardings(mesh)``, in the skeleton leaf's dtype: each leaf
    becomes the object array of its shards (``NamedSharding.place``, each
    slot copying only its block of the file; ``NamedSharding.gather``
    rebuilds it), so no whole leaf is made on a card.
    Returns ``(mesh, step, tree, extras)``, or ``None`` when no checkpoint
    exists.  With ``train/trainer.checkpoint_shardings`` as
    ``make_shardings``, a ``Trainer`` on the returned mesh trains on from
    that tree: ``Trainer(..., mesh=mesh).train(restored=(step, tree))``.
    """
    import torch

    from repro_torch.parallel.sharding import tree_map

    mesh = surviving_mesh(model_parallel=model_parallel, devices=devices)
    out = ckpt_manager.restore_latest(skeleton, mmap=True)
    if out is None:
        return None
    step, tree, extras = out
    placed = tree_map(lambda x, skel, sh: sh.place(x, skel.dtype if torch.is_tensor(skel)
                                                   else None),
                      tree, skeleton, make_shardings(mesh))
    return mesh, step, placed, extras


class StepTimer:
    """``with StepTimer() as t: ...`` leaves the block's wall seconds in
    ``t.seconds``."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.seconds = time.perf_counter() - self.t0
