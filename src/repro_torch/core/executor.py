"""Executor layer: runs :class:`~repro_torch.core.plan.ExtractionPlan`s with a
device-resident data plane on the card.

Counterpart of ``repro.core.executor`` for the counted and static
schedules with count- or hint-sized prep.  ``submit_window`` turns one
window of cases into device launches, ``collect_window`` drains the
results, ``extract_stream`` pipelines windows; the thin
:class:`~repro_torch.core.pipeline.BatchedExtractor` facade sits on top.

Data plane of one window:

* **pass 0 (prep):** each case is cropped, padded to its shape bucket and
  staged on the device once; its dedup vertex fields and count are
  computed there.  ``prep='count'`` fetches the count (one host sync per
  non-empty case) to size the case's vertex cap; ``prep='hint'`` sizes
  it from ``plan.vertex_hint`` metadata alone and leaves the count on the
  device for the collector.  The stable active-first compaction then
  fills a ``(cap, 3)`` vertex list on the device;
* **pass 1:** per cap group, one batched pruning bound
  (``prune.keep_mask_batch``) and the compaction kernel
  (``kernels/compact``); the vertex data never leaves the card.  Under
  ``schedule='counted'`` one ``(B, 2)`` count fetch sizes each case's
  pruned bucket (``prune.plan_compaction``), with one compaction launch
  per target bucket.  Under ``schedule='static'`` the group compacts
  straight into the plan's static target (``plan.static_bucket``, the
  counted schedule's re-bucketing boundary) and its counts stay on the
  device: pass 1 makes no host fetch;
* **pass 2a:** one batched marching-cubes launch per shape bucket, sliced
  straight off a device pool of the staged masks;
* **pass 2b:** one batched diameter launch per pruned vertex bucket, off
  the pass-1 stacks.

Deferred collect, as in the reference: under the static schedule each
group's counts are fetched at collect (stage ``pass2b_counts``) and give
the counted schedule's decision; a case that decision keeps at its
original cap is re-swept there from the retained stacks (``pass2b_retry``).
Under hint prep each case's count is fetched at collect
(``collect_counts``); a case whose count overflowed its hint cap re-runs
count-sized through the single-case stages (``hint_retry``).  Both give
the counted, count-sized rows bitwise.

Drains that do not wait for later launches: the last step of a submit
queues a ``non_blocking`` copy of every result the collector will fetch
into pinned host memory and records one CUDA event behind them, so a
window's fetches wait for that event alone, not for the launches of
windows submitted after it (``extract_stream`` submits window k+1 before
it collects window k).  Launches made at collect time (the re-sweeps)
are fetched directly and do queue behind later windows.

Feature families (``core/plan.FAMILIES``): any subset of shape,
first-order and GLCM.  With an intensity family, pass 0 stages each
case's cropped, bucket-padded intensity volume once beside its mask; one
intensity pool per shape bucket (the image stack, the mask stack that pass
2a also reads, and each case's masked range) is shared by both families,
and one first-order (``kernels/firstorder``) and one GLCM
(``kernels/glcm``) launch per shape bucket chunk are queued before pass 1.  Each family
drains under its own stage, so the shape stages' fetches do not change;
the host turns each fetched payload into its feature columns.  An
intensity-only request runs no vertex stage and no shape pass.  Rows are
``plan.row_width(families)`` wide, in canonical family order.

Every launch of passes 2a and 2b and of the families is queued before
any result is drained, and each chunk is drained with one fetch.
``batch_size`` cuts a group into chunks of at most that many cases
(rounded up to a multiple of a mesh's data axis).  PyTorch runs eagerly, so there
is no compile cache and a short last chunk is launched as it is.

Every device-to-host copy of the executor goes through :meth:`_fetch`,
under the reference's stage names (``prep``, ``pass1``, ``pass2a``,
``pass2b``, ``pass2``, ``firstorder``, ``glcm``, ``pass2b_counts``,
``pass2b_retry``, ``collect_counts``, ``hint_retry``), and every host-to-device
copy is queued from pinned memory (``dispatcher.to_device``), so on the default path and the
one-pass path ``transfer_log`` counts every host sync; the tests hold it
equal to the reference's, and on the card hold ``submit_window`` to no
other sync.  The host-compaction baseline also pulls each cap group's
keep mask inside ``ops.prune_candidates_batch``, uncounted, as the
reference does.

Parity baselines, as in the reference: ``device_compact=False`` fetches
each case's vertex list in pass 0 and compacts the survivors on the host;
``prune=False`` runs the one-pass path (caps from ``plan.vertex_hint``,
no pruning).  Both give the same rows as the default, bitwise.

A case that fails to load or validate (a NaN-poisoned mask, a bad
spacing, a loader that raises, and with an intensity family a missing,
mismatched or non-finite image) is quarantined as an all-NaN row with an
``errors`` entry in the window stats; an empty mask gives a zero row; the
rest of the window is unchanged.  An error of the card in pass 0 (a CUDA
error or an out-of-memory, ``DEVICE_ERRORS``) is raised, not quarantined.

Kernel configurations resolve per launch, as in the reference:
``_resolve_diameter(cap, depth)``, ``_resolve_compact(cap_in, depth)``
and ``_resolve_family_block(family, shape, depth)`` ask
``core/dispatcher`` for the launch's (bucket, batch depth), which on the
card reads the measured autotune cache (``runtime/autotune``, sweeping
once on a miss) and on the CPU gives the defaults.  ``variant`` is
``'auto'`` or any of ``kernels.diameter.VARIANTS``; ``'auto'`` chooses
only among the direct variants, which give the same bits, so batched rows
equal ``extract_one``'s whatever each depth's winner.  The marching-cubes
block and ``mc_chunk`` stay fixed (``_resolve_mc``): ``mc_chunk`` sets the
order of its partial sums, the block no bit.

The out-of-core engine (``core/tiled``) runs on an executor: its device,
its kernel choices (``_resolve_mc``, ``_resolve_diameter``), its family row
derivation and its ``_fetch`` census.  ``mc_chunk`` is the z-granule of the
marching-cubes partial layout that the in-core passes and the tiles share.

The auto knobs (``runtime/costmodel``): ``schedule='auto'`` resolves
counted or static per window in :meth:`PlanExecutor.submit_prepped`
(``CostModel.choose_schedule`` on the window's metadata; the run stats say
``'auto'``, the plan's stats the resolved schedule), and
``extract_stream(window='auto')`` preps case by case into a
``plan.WindowCensus`` and closes each window where
``CostModel.should_close`` says, window k+1 submitted before window k is
collected.  Both give the fixed knobs' rows bitwise.  The cost model's
sync cost and hardware profile are resolved before a window is prepared
(at construction under ``schedule='auto'``, at the start of an auto
stream), so a probe's sync never lands inside a submit.

Retry (``retry=``, a ``runtime/resilience.RetryPolicy``, duck-typed): a
window whose collect raises is re-submitted from its prepped device state
(:meth:`PlanExecutor.resubmit_window`) and drained again after the
policy's backoff, up to ``max_retries`` times; ``window_retries`` counts
the retries.  An error of the card (:data:`DEVICE_ERRORS`) is re-raised at
once: a CUDA error poisons the context, so a re-submit would fail too.
Every retry re-stages the window's results, so a re-submitted window
collects like a first submit under every schedule and prep.

Data parallelism (``mesh=``, a ``parallel/sharding.Mesh``, and
``data_axis``, default ``'data'``): every batched device pass shards over
the mesh's data axis, as the reference's ``_dp_map`` does -- pass 1's
bound and compaction (both schedules), pass 2a, pass 2b and its collect
re-sweeps, the one-pass launch, and the intensity families with their
masked range.  Each launch's stacks are padded to a multiple of the axis
size with copies of row 0, split into one contiguous shard a slot, run on
the slot's device and stream, and gathered on the mesh's first device,
which is the executor's device (:meth:`PlanExecutor._sharded`); the
padding rows are cut off before anything reads them.  A shard is a batch
of its own, and a case's row does not depend on its batch, so a mesh run's
rows equal the unsharded run's bitwise; it makes the same host fetches
and no other host sync.  Pass 0 stages every case on the first device and
shards are sliced off its stacks.  Each launch resolves its kernel
configuration at the depth one slot launches (the shard depth).  The host
compaction of ``device_compact=False`` and the single-case stages of
``extract_one`` and the hint retry's prune stay unsharded.  Without a
``mesh``, the executor adopts the ambient ``sharding.use_mesh`` mesh when
it has the data axis.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core import dispatcher
from repro_torch.core import plan as planlib
from repro_torch.core.dispatcher import resolve_device, to_device
from repro_torch.core.shape_features import crop_to_roi
from repro_torch.kernels import diameter as _diam
from repro_torch.kernels import firstorder as _fo
from repro_torch.kernels import glcm as _glcm
from repro_torch.kernels import marching_cubes as _mc
from repro_torch.kernels import ops
from repro_torch.kernels import masked_range as _range
from repro_torch.kernels import prune as prune_kernels
from repro_torch.kernels import ref as _ref
from repro_torch.parallel import sharding


@contextlib.contextmanager
def _sync_allowed():
    """Lifts a CUDA sync debug mode (see :meth:`PlanExecutor.strict_syncs`)
    for one counted fetch."""
    prev = torch.cuda.get_sync_debug_mode()
    if prev:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if prev:
            torch.cuda.set_sync_debug_mode(prev)


def _compact_at(fields, cap: int):
    """The stable compaction of ``fields`` into ``cap`` slots: ``(verts,
    vmask)``.  A cap past the field's slot count (a hint cap of a tiny
    volume) pads with invalid zero rows, which no stage reads."""
    verts, vmask, _ = ops.compact_vertices(fields, cap)
    short = cap - verts.shape[0]
    if short > 0:
        verts = torch.nn.functional.pad(verts, (0, 0, 0, short))
        vmask = torch.nn.functional.pad(vmask, (0, short))
    return verts, vmask


_END = object()  # the end of an auto stream's cases
# errors of the card, not of a case: never quarantined
DEVICE_ERRORS = (getattr(torch, "AcceleratorError", torch.cuda.OutOfMemoryError),
                 torch.cuda.OutOfMemoryError)


def check_window(window) -> None:
    """Raises ``ValueError`` unless ``window`` is a positive int (a stream's
    fixed window) or ``'auto'`` (windows closed by the cost model)."""
    if window == "auto":
        return
    if isinstance(window, bool) or not isinstance(window, int) or window < 1:
        raise ValueError(f"window must be a positive int or 'auto', got {window!r}")


@dataclasses.dataclass
class _Prepped:
    """Pass-0 state for one case (None mask = empty-mask or quarantined case).

    ``mask`` is the bucket-padded mask, staged on the device (the pool
    entry); ``image`` the bucket-padded intensity volume, staged beside it
    when an intensity family is requested; ``verts``/``vmask`` stay on the
    device on the device-compaction path and are host numpy on the host
    path.
    """

    mask: torch.Tensor | None = None
    image: torch.Tensor | None = None
    spacing: np.ndarray | None = None
    shape: tuple | None = None  # padded shape bucket (MC group key)
    roi_shape: tuple | None = None  # pre-pad cropped shape (pad stats)
    verts: object | None = None
    vmask: object | None = None
    n_vertices: int = 0  # pre-prune dedup vertex count (a feature)
    vertex_cap: int = 0  # vertex bucket the diameter sweep runs at
    prune_info: object | None = None
    # hint prep: the true dedup count, left on the device for every submit
    # of the case (each stages its own copy, ``_Window.hint_counts``)
    n_dev: object | None = None
    hint: int = 0  # hint prep: the metadata count the pass-0 cap was sized from
    error: str | None = None  # quarantined case: the row degrades to NaNs


@dataclasses.dataclass
class _Window:
    """One submitted window: every launch issued, nothing drained yet."""

    prepped: list
    plan: planlib.ExtractionPlan
    mc_futs: list
    diam_futs: list
    fused_futs: list
    t_prune: float
    family_futs: dict  # {family: [(idxs, future)]}: the intensity launches
    static_aux: list = dataclasses.field(default_factory=list)
    # [(cap, idxs, counts, verts, masks)]: the static groups' deferred counts
    hint_counts: list = dataclasses.field(default_factory=list)
    # [(case index, staged count)]: hint prep's deferred counts


@dataclasses.dataclass
class _Staged:
    """A result whose copy to host memory was queued at submit.

    ``host`` is the pinned destination of a ``non_blocking`` copy and
    ``done`` the event recorded behind the window's copies (None on the
    CPU, where ``host`` is the result itself).  A window dropped before its
    collect (a preempted run's in-flight window) may leave its copies
    running: PyTorch's pinned-memory cache records the copy's stream on
    the block and hands it out again only once the copy has landed, so a
    later window never reads or reuses it early.
    """

    host: torch.Tensor
    done: object | None = None


class PlanExecutor:
    """Plan-driven batched extraction engine (see the module docstring).

    Owns the submit/collect loops and the ``transfer_log`` host-sync
    census.  ``device`` defaults to ``'cuda'`` and raises without a card;
    ``device='cpu'`` runs the plain versions of the kernels.
    ``variant`` (a diameter variant) and ``compact_block`` accept
    ``'auto'``, the measured choice per launch (see the module
    docstring); the intensity families always take their tuned ``block``.
    ``mc_block='auto'`` is the marching-cubes kernel's fixed default.
    ``mc_chunk`` is the z-granule, in cell planes, of the
    marching-cubes partial layout (default ``marching_cubes.
    DEFAULT_CHUNK_Z`` = 8, the reference's Pallas brick depth); the
    in-core passes and the tiled engine (``core/tiled.py``) use the same
    value, so their rows agree bitwise.  ``families`` is any request
    ``plan.resolve_families`` takes; ``n_bins`` the intensity families'
    bin count.  ``schedule`` is ``'counted'``, ``'static'`` or ``'auto'``
    (the cost model's choice per window); ``cost_model`` replaces the
    lazily built ``runtime/costmodel.CostModel`` of the auto knobs.
    ``mesh`` (a ``parallel/sharding.Mesh``; default the ambient
    ``use_mesh`` mesh when it has ``data_axis``) shards every batched pass
    over its ``data_axis``; the executor's device is then the mesh's first
    device (``device=None`` takes it, another device raises).
    """

    N_FEATURES = planlib.row_width(planlib.DEFAULT_FAMILIES)
    # [vol, area, d3, dxy, dxz, dyz, n_vertices]
    SCHEDULES = (*planlib.SCHEDULES, "auto")

    def __init__(self, device=None, variant="auto", mesh=None, data_axis: str = "data",
                 prune: bool = True, mc_block="auto", mc_chunk: int | None = None,
                 k_dirs: int = 16, device_compact: bool = True, compact_block="auto",
                 schedule: str = "counted", prep: str = "count", cost_model=None,
                 transfer_callback=None, retry=None, families=None, n_bins: int = 32):
        if mesh is None:
            # adopt the ambient mesh only where it can shard the batch
            ambient = sharding.active_mesh()
            if ambient is not None and data_axis in ambient.shape:
                mesh = ambient
        elif not isinstance(mesh, sharding.Mesh):
            raise TypeError(f"mesh must be a repro_torch.parallel.sharding.Mesh, got {mesh!r}")
        self.mesh = mesh
        self.data_axis = data_axis
        self.n_data = sharding.axis_size(mesh, data_axis)
        sharded = mesh is not None and data_axis in mesh.shape
        self.device = resolve_device(mesh.home if device is None and sharded else device)
        if sharded and sharding.slot_device(self.device) != mesh.home:
            raise ValueError(f"a mesh's batches gather on its first device {mesh.home}, which "
                             f"is the executor's device; got device={device!r}")
        if schedule not in self.SCHEDULES:
            raise ValueError(f"schedule must be one of {self.SCHEDULES}, got {schedule!r}")
        if schedule in ("static", "auto") and not (prune and device_compact):
            raise ValueError(f"schedule={schedule!r} is (or may resolve to) a device-resident "
                             "schedule: it requires prune=True and device_compact=True")
        if prep not in ("count", "hint"):
            raise ValueError(f"prep must be one of ('count', 'hint'), got {prep!r}")
        if prep == "hint" and not (prune and device_compact):
            raise ValueError("prep='hint' is a device-resident prep: it requires "
                             "prune=True and device_compact=True")
        self.families = planlib.resolve_families(families)
        if variant != "auto":
            _diam.check_variant(variant)
        self.n_features = planlib.row_width(self.families)
        self.n_bins = int(n_bins)
        _ref.check_bins(self.n_bins)
        self._shape_on = "shape" in self.families
        self._needs_intensity = planlib.needs_intensity(self.families)
        self.variant = variant
        self.prune = prune
        self.mc_block = _mc.DEFAULT_BLOCK if mc_block == "auto" else int(mc_block)
        self.mc_chunk = _mc.DEFAULT_CHUNK_Z if mc_chunk is None else int(mc_chunk)
        if self.mc_chunk < 1:
            raise ValueError(f"mc_chunk must be a positive number of cell planes, "
                             f"got {mc_chunk}")
        self.k_dirs = k_dirs
        self.device_compact = device_compact
        self.compact_block = compact_block
        self.schedule = schedule
        self.prep = prep
        self.transfer_log = collections.Counter()
        self._transfer_cb = transfer_callback
        self.retry = retry  # runtime/resilience.RetryPolicy (duck-typed)
        self.window_retries = 0  # collect retries performed
        self._cost_model = cost_model
        if schedule == "auto":
            self.cost_model.resolve()  # any probe syncs here, not in a submit

    @property
    def cost_model(self):
        """The auto knobs' decision layer (``runtime/costmodel.CostModel``),
        built on first use: fixed-knob runs never read the autotune cache
        through it."""
        if self._cost_model is None:
            from repro_torch.runtime import costmodel  # local import: avoids a cycle

            self._cost_model = costmodel.CostModel(self.device)
        return self._cost_model

    # -- host-sync accounting ----------------------------------------------

    def _fetch(self, stage: str, x) -> np.ndarray:
        """The ONLY device-to-host copy point of the executor.

        Counts every host materialisation per stage in ``transfer_log``.
        A :class:`_Staged` result waits for its window's copy event and
        reads its host buffer; a device tensor is copied here.
        """
        self.transfer_log[stage] += 1
        if isinstance(x, _Staged):
            if x.done is not None:
                with _sync_allowed():
                    x.done.synchronize()
            x = x.host
        if self._transfer_cb is not None:
            self._transfer_cb(stage, x)
        if isinstance(x, torch.Tensor) and x.is_cuda:
            with _sync_allowed():
                return x.cpu().numpy()
        if isinstance(x, torch.Tensor):
            return x.numpy()
        return np.asarray(x)

    @staticmethod
    @contextlib.contextmanager
    def strict_syncs():
        """Context in which a CUDA host sync outside :meth:`_fetch` raises.

        Sets PyTorch's CUDA sync debug mode to ``'error'``; :meth:`_fetch`
        lifts it for its own copy.  The check behind the claim that
        ``transfer_log`` counts every host sync of a submitted window.
        """
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    def _stage_results(self, window: _Window) -> _Window:
        """Queue the host copy of every result ``window``'s collect fetches.

        The last step of a submit: each copy goes ``non_blocking`` into
        pinned memory behind the window's own launches, and one event is
        recorded behind the copies, so :meth:`_fetch` waits for this
        window alone however many windows were submitted after it.
        """
        done = torch.cuda.Event() if self.device.type == "cuda" else None

        def stage(x):
            if done is None:
                return _Staged(x)
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            return _Staged(host, done)

        def stage_all(futs):
            return [(idxs, stage(f)) for idxs, f in futs]

        window.mc_futs = stage_all(window.mc_futs)
        window.diam_futs = stage_all(window.diam_futs)
        window.fused_futs = stage_all(window.fused_futs)
        window.family_futs = {k: stage_all(v) for k, v in window.family_futs.items()}
        window.static_aux = [(cap, idxs, stage(counts), verts, masks)
                             for cap, idxs, counts, verts, masks in window.static_aux]
        # the device counts stay on the prepped cases: a re-submit stages them again
        window.hint_counts = [(i, stage(p.n_dev)) for i, p in enumerate(window.prepped)
                              if p.n_dev is not None]
        if done is not None:
            done.record(torch.cuda.current_stream(self.device))
        return window

    # -- launches ------------------------------------------------------------

    def _resolve_mc(self, shape=None):
        """``(block, chunk_z)`` of the MC kernel: fixed for every shape, as
        the tiled path's bitwise agreement with the in-core path needs."""
        return self.mc_block, self.mc_chunk

    def _resolve_diameter(self, cap, depth: int = 1, static: bool = False):
        """``(variant, block)`` of a diameter launch over ``depth`` lists of
        ``cap`` slots (``static``: a static schedule's target, whose lists
        hold the pruning survivors of a bucket twice its size)."""
        return dispatcher.diameter_config(self.device, cap, self.variant, batch=depth,
                                          static=static)

    def _resolve_compact(self, cap_in, depth: int = 1) -> int:
        """The tile of a compaction launch over ``depth`` lists of ``cap_in``
        slots."""
        return dispatcher.compact_config(self.device, cap_in, self.compact_block, batch=depth)

    def _resolve_family_block(self, family: str, shape, depth: int = 1) -> int:
        """``block`` of an intensity-family launch over ``depth`` volumes of
        the padded ``shape``."""
        resolver = (dispatcher.firstorder_config if family == "firstorder"
                    else dispatcher.glcm_config)
        return resolver(self.device, shape, "auto", batch=depth)

    def _shard_depth(self, n: int) -> int:
        """Rows one slot's launch takes from a chunk of ``n`` cases: the
        batch depth its kernel configuration resolves at."""
        return -(-n // self.n_data)

    def _sharded(self, fn, *arrays):
        """``fn`` over the leading (case) axis of ``arrays``, sharded over the
        mesh's data axis (``sharding.data_parallel_map``): padded to a
        multiple of the axis size with copies of row 0, split into one
        contiguous shard a slot, launched on the slots whose shards hold a
        real row, gathered on the executor's device, and the padding rows
        cut off.  Without a mesh, the plain call."""
        if self.mesh is None:
            return fn(*arrays)
        n = len(arrays[0])
        out = sharding.data_parallel_map(fn, self.mesh, self.data_axis)(
            *sharding.pad_batch(arrays, n, self.mesh, self.data_axis), rows=n)
        return tuple(o[:n] for o in out) if isinstance(out, tuple) else out[:n]

    def _mc_launch(self, shape, masks, spacings):
        """Pass 2a: batched MC over one chunk of a shape bucket's pool."""
        def batch(masks, spacings):
            return ops.mc_volume_area_batch(masks, 0.5, spacings, device=masks.device,
                                            block=self.mc_block, chunk_z=self.mc_chunk)

        return self._sharded(batch, masks, spacings)

    def _diam_launch(self, key, verts, vmasks):
        """Pass 2b: batched diameter sweep over one chunk of a vertex bucket.

        ``key`` is the bucket, or ``("static", target)`` for a static
        schedule's target, which resolves its configuration under a key of
        its own (``autotune.static_key``)."""
        static = isinstance(key, tuple)
        cap = key[1] if static else key
        variant, block = self._resolve_diameter(cap, self._shard_depth(len(verts)),
                                                static=static)

        def batch(verts, vmasks):
            return ops.max_diameters_batch(verts, vmasks, device=verts.device, block=block,
                                           variant=variant)

        return self._sharded(batch, verts, vmasks)

    def _family_fn(self, family: str, shape, depth: int):
        """One intensity family's batched op over ``depth`` volumes of the
        padded ``shape``, at its resolved block: ``(images, masks, lo, hi)``
        to packed stats rows (first-order) or count matrices (GLCM), left on
        the device."""
        op = ops.firstorder_packed_batch if family == "firstorder" else ops.glcm_matrix_batch
        block = self._resolve_family_block(family, shape, depth)

        def batch(images, masks, lo, hi):
            return op(images, masks, device=images.device, n_bins=self.n_bins, block=block,
                      value_range=(lo, hi))

        return batch

    def _family_launch(self, family: str):
        """The launch of one intensity family over one chunk of a shape
        bucket's intensity pool (:meth:`_family_fn`, sharded)."""
        def launch(shape, images, masks, lo, hi):
            fn = self._family_fn(family, shape, self._shard_depth(len(images)))
            return self._sharded(fn, images, masks, lo, hi)

        return launch

    def _fused_launch(self, bucket: planlib.Bucket, masks, spacings):
        """The one-pass path (``prune=False``): (B, 7) rows of one chunk.

        Batched MC, then per case the vertex fields and the stable
        compaction into the bucket's hint-sized cap, then one batched
        sweep over the unpruned lists; the count rides along on the device.
        """
        variant, block = self._resolve_diameter(bucket.vertex_cap,
                                                self._shard_depth(len(masks)))

        def batch(masks, spacings):
            mc = ops.mc_volume_area_batch(masks, 0.5, spacings, device=masks.device,
                                          block=self.mc_block, chunk_z=self.mc_chunk)
            verts, vmasks, counts = zip(*(
                ops.compact_vertices(ops.vertex_fields(m, 0.5, sp), bucket.vertex_cap)
                for m, sp in zip(masks, spacings)
            ))
            d = ops.max_diameters_batch(torch.stack(verts), torch.stack(vmasks),
                                        device=masks.device, block=block, variant=variant)
            n = torch.stack(counts).to(torch.float32)[:, None]
            return torch.cat([mc, d, n], dim=1)

        return self._sharded(batch, masks, spacings)

    # -- submit/drain loops ------------------------------------------------

    def _submit(self, entries, launch, make_chunk, batch_size=None):
        """Launch every chunk of every entry; returns ``[(idxs, future)]``.

        ``entries`` yields ``(group key, case indices, payload)``;
        ``make_chunk(payload, start, chunk)`` gives one chunk's stacked
        inputs and ``launch(key, *inputs)`` queues its kernels.  CUDA
        launches are asynchronous, so the whole window is queued before
        the collector drains anything.
        """
        futs = []
        for gkey, idxs, payload in entries:
            # a multiple of the data axis, as the reference's chunks; the
            # launch pads a short last chunk (:meth:`_sharded`)
            bs = -(-(batch_size or len(idxs)) // self.n_data) * self.n_data
            for s in range(0, len(idxs), bs):
                chunk = idxs[s : s + bs]
                futs.append((chunk, launch(gkey, *make_chunk(payload, s, chunk))))
        return futs

    def _drain(self, futs, stage: str) -> dict:
        """Fetch submitted futures into ``{case index: np row}``."""
        out: dict[int, np.ndarray] = {}
        for idxs, fut in futs:
            o = self._fetch(stage, fut)
            for j, i in enumerate(idxs):
                out[i] = o[j]
        return out

    @staticmethod
    def _stacked_chunk(arrays, s, chunk):
        """Chunk maker over stacked groups (pools, pass-1 output): slices."""
        return tuple(a[s : s + len(chunk)] for a in arrays)

    def _host_chunk(self, arrays_for_case):
        """Chunk maker over host per-case arrays (the host-compaction feed)."""

        def make(_, s, chunk):
            cols = zip(*(arrays_for_case(i) for i in chunk))
            return tuple(to_device(np.stack(c), self.device) for c in cols)

        return make

    def _pool(self, prepped, idxs):
        """Device pool of one shape group: (stacked masks, (B, 3) host spacings)."""
        return (
            torch.stack([prepped[i].mask for i in idxs]),
            np.stack([prepped[i].spacing for i in idxs]),
        )

    def _ipool(self, images, masks):
        """Intensity pool of one shape group: ``(images, masks, lo, hi)``,
        the stacks and each case's masked range (``csrc/masked_range.cu``
        on the card, sharded), taken once and shared by every intensity
        family."""
        lo, hi = self._sharded(_range.masked_range_batch, images, masks)
        return images, masks, lo, hi

    def _submit_families(self, plan, prepped, pools, batch_size=None) -> dict:
        """Queue every intensity-family launch of a planned window.

        One launch per (family, shape bucket, chunk), all queued before
        anything is drained; no host fetch happens here.  ``pools`` holds
        the shape groups' mask stacks, which pass 2a shares.
        """
        families = [f for f in plan.families if f != "shape"]
        if not families:
            return {}
        entries = [
            (shape, idxs, self._ipool(torch.stack([prepped[i].image for i in idxs]),
                                      pools[shape][0]))
            for shape, idxs in plan.shape_groups.items()
        ]
        return {
            family: self._submit(entries, self._family_launch(family),
                                 self._stacked_chunk, batch_size)
            for family in families
        }

    # -- pass 0: prep + device staging --------------------------------------

    def _prep_case(self, image, mask, spacing, fields: bool = True,
                   prep: str | None = None) -> _Prepped:
        """Crop, bucket-pad, stage and compact one case (pass 0).

        ``fields=False`` (the one-pass path, which computes the vertex
        fields in its own launch) sizes the cap from ``plan.vertex_hint``
        instead of the measured count.  ``prep`` (default: the executor's)
        sizes the cap of the two-pass path: ``'count'`` fetches the
        measured count, ``'hint'`` takes ``plan.vertex_hint`` and leaves the
        count on the device (``n_dev``) for the collector, which retries a
        case whose count overflowed the cap.  With an intensity family, the
        image is checked (present, of the mask's shape, finite), cropped
        with the mask and staged once beside it; a shape-only request
        never reads it.  An intensity-only request stops after staging:
        no vertex stage runs, and the shape bucket still keys the family
        launches.
        """
        sp = np.asarray(spacing, np.float32)
        if not np.any(mask):
            return _Prepped(spacing=sp)  # empty mask: all-zero feature row
        if self._needs_intensity:
            img = None if image is None else np.asarray(image)
            if img is None or img.shape != np.shape(mask):
                raise ValueError("intensity families requested but the case has no "
                                 "matching intensity image")
            if np.issubdtype(img.dtype, np.floating) and not np.isfinite(img).all():
                raise ValueError("non-finite intensity image (poisoned case)")
            im, m, _ = crop_to_roi(img, mask)
        else:
            _, m, _ = crop_to_roi(mask, mask)
        roi_shape = m.shape
        bshape = planlib.shape_bucket(tuple(s - 2 for s in roi_shape))
        pad = [(0, bs - ms) for bs, ms in zip(bshape, roi_shape)]
        mdev = to_device(np.pad(m, pad), self.device)  # the pool entry
        # staged once; shared by every intensity family
        idev = to_device(np.pad(im, pad), self.device) if self._needs_intensity else None
        if not self._shape_on:
            return _Prepped(mask=mdev, image=idev, spacing=sp, shape=bshape,
                            roi_shape=roi_shape)
        if not fields:
            hint = planlib.vertex_hint(tuple(s - 2 for s in roi_shape), sp)
            return _Prepped(mask=mdev, image=idev, spacing=sp, shape=bshape,
                            roi_shape=roi_shape, n_vertices=hint,
                            vertex_cap=planlib.vertex_bucket(hint))
        f = ops.vertex_fields(mdev, 0.5, sp)
        if (prep or self.prep) == "hint":
            hint = planlib.vertex_hint(tuple(s - 2 for s in roi_shape), sp)
            cap = planlib.vertex_bucket(hint)
            verts, vmask = _compact_at(f, cap)
            return _Prepped(mask=mdev, image=idev, spacing=sp, shape=bshape,
                            roi_shape=roi_shape, verts=verts, vmask=vmask, n_vertices=hint,
                            vertex_cap=cap, n_dev=ops.count_vertices(f), hint=hint)
        n = int(self._fetch("prep", ops.count_vertices(f)))
        cap = planlib.vertex_bucket(n)
        verts, vmask = _compact_at(f, cap)
        if not self.device_compact:  # host path: pull the list per case
            verts = self._fetch("prep", verts)
            vmask = self._fetch("prep", vmask)
        return _Prepped(mask=mdev, image=idev, spacing=sp, shape=bshape,
                        roi_shape=roi_shape, verts=verts, vmask=vmask, n_vertices=n,
                        vertex_cap=cap)

    def _prep_case_safe(self, case, fields: bool = True) -> _Prepped:
        """Quarantining wrapper around :meth:`_prep_case` (pass 0).

        ``case`` is an ``(image, mask, spacing)`` tuple or a zero-argument
        loader returning one.  Any exception -- a loader error, a
        non-finite mask or spacing, a crop failure -- quarantines the case:
        its row is all-NaN, its message rides the window stats, and the
        rest of the window is untouched.  With an intensity family, a
        missing, mismatched or non-finite image quarantines it too.  An
        error of the card (:data:`DEVICE_ERRORS`: a CUDA error, an
        out-of-memory) is raised: it is not the case's fault.
        """
        try:
            if callable(case):
                case = case()
            image, mask, spacing = case
            m = np.asarray(mask)
            if np.issubdtype(m.dtype, np.floating) and not np.isfinite(m).all():
                raise ValueError("non-finite mask (poisoned case)")
            sp = np.asarray(spacing, np.float64)
            if sp.shape != (3,) or not np.isfinite(sp).all() or (sp <= 0).any():
                raise ValueError(f"invalid spacing {spacing!r}")
            return self._prep_case(image, mask, spacing, fields=fields)
        except (KeyboardInterrupt, SystemExit, *DEVICE_ERRORS):
            raise
        except Exception as e:  # the row-level error record
            return _Prepped(error=f"{type(e).__name__}: {e}")

    def _meta(self, p: _Prepped) -> planlib.CaseMeta:
        if p.mask is None:
            return planlib.CaseMeta(None, None, 0, 0)
        return planlib.CaseMeta(p.shape, p.roi_shape, p.vertex_cap, p.n_vertices,
                                intensity=p.image is not None)

    def prep_case(self, case) -> _Prepped:
        """Pass-0 prep of one case, quarantining any load or validation
        failure (see :meth:`_prep_case_safe`)."""
        return self._prep_case_safe(case, fields=self.prune)

    def case_meta(self, p: _Prepped) -> planlib.CaseMeta:
        """Planning metadata of a prepped case."""
        return self._meta(p)

    # -- pass 1 --------------------------------------------------------------

    def _prune_pass(self, plan, prepped):
        """Pass 1 (host path): batched bound + per-case host compaction."""
        for _, idxs in plan.cap_groups.items():
            batch = ops.prune_candidates_batch(
                np.stack([prepped[i].verts for i in idxs]),
                np.stack([prepped[i].vmask for i in idxs]),
                k_dirs=self.k_dirs, device=self.device,
            )
            for i, (v2, m2, info) in zip(idxs, batch):
                prepped[i].verts, prepped[i].vmask = v2, m2
                prepped[i].vertex_cap = len(v2)
                prepped[i].prune_info = info

    def _pass1_counted(self, plan, prepped):
        """Pass 1 (device path): batched bound + device compaction.

        Per cap group, one bound over the stacked lists, one ``(B, 2)``
        count fetch that sizes the pruned buckets, and one compaction
        launch per target bucket.  Decisions come from
        ``prune.plan_compaction``, the rule the host path follows too.
        Returns the pass-2b feed: ``[(bucket, case indices, (verts, vmask))]``.
        """
        entries = []
        for cap, idxs in plan.cap_groups.items():
            verts = torch.stack([prepped[i].verts for i in idxs])
            masks = torch.stack([prepped[i].vmask for i in idxs])
            keep, counts = self._sharded(self._bound, verts, masks)
            # the one host sync of pass 1: a small (B, 2) matrix
            counts = self._fetch("pass1", counts)
            plans = [
                prune_kernels.plan_compaction(cap, int(mv), int(mk), planlib.vertex_bucket)
                for mv, mk in counts
            ]
            for i, (cap_out, info) in zip(idxs, plans):
                prepped[i].prune_info = info
                prepped[i].vertex_cap = cap_out or cap
            # keep-originals cases feed pass 2b at their input cap
            groups = planlib.group_indices(
                [cap_out if cap_out else ("orig", cap) for cap_out, _ in plans]
            )
            for gkey, js in groups.items():
                if len(js) == len(idxs):  # the whole group agrees: reuse the stacks
                    sub = (verts, masks, keep)
                else:
                    take = to_device(np.asarray(js, np.int64), self.device)
                    sub = tuple(a.index_select(0, take) for a in (verts, masks, keep))
                gidxs = [idxs[j] for j in js]
                if isinstance(gkey, tuple):  # unpruned: originals, input cap
                    entries.append((cap, gidxs, sub[:2]))
                    continue
                block = self._resolve_compact(cap, self._shard_depth(len(gidxs)))

                def compact(verts, keep, cap_out=gkey, block=block):
                    return ops.compact_survivors_batch(verts, keep, cap_out, device=verts.device,
                                                       block=block)[:2]

                entries.append((gkey, gidxs, self._sharded(compact, sub[0], sub[2])))
        return entries

    def _bound(self, verts, masks):
        """Pass 1's pruning bound over a stack: ``(keep, (B, 2) [m_valid,
        m_kept] counts)``, both on the stack's device."""
        keep, _ = prune_kernels.keep_mask_batch(verts, masks, self.k_dirs)
        return keep, torch.stack([masks.sum(1), keep.sum(1)], dim=1)

    def _pass1_static(self, plan, prepped):
        """Pass 1 (static schedule): no host fetch.

        Per cap group, one bound and one compaction launch into the plan's
        static target; the ``(B, 2)`` ``[m_valid, m_kept]`` counts stay on
        the device and ride to the collector in ``static_aux`` with the
        original stacks (for the keep-originals re-sweep).  A floor-cap
        group (no target: it can never re-bucket) runs no chain, feeds
        pass 2b its original stacks and takes a metadata-only
        ``PruneInfo``, as in the reference.  Returns ``(entries, aux)``.
        """
        entries, aux = [], []
        for cap, idxs in plan.cap_groups.items():
            target = plan.static_targets[cap]
            verts = torch.stack([prepped[i].verts for i in idxs])
            masks = torch.stack([prepped[i].vmask for i in idxs])
            if target is None:
                for i in idxs:
                    n = prepped[i].n_vertices
                    prepped[i].prune_info = prune_kernels.PruneInfo(cap, n, n, False)
                    prepped[i].vertex_cap = cap
                entries.append((cap, idxs, (verts, masks)))
                continue
            block = self._resolve_compact(cap, self._shard_depth(len(idxs)))

            def chain(verts, masks, target=target, block=block):
                keep, counts = self._bound(verts, masks)
                cv, cm, _ = ops.compact_survivors_batch(verts, keep, target, device=verts.device,
                                                        block=block)
                return cv, cm, counts

            cv, cm, counts = self._sharded(chain, verts, masks)
            entries.append((("static", target), idxs, (cv, cm)))
            aux.append((cap, idxs, counts, verts, masks))
        return entries, aux

    def _resolve_static_aux(self, window: _Window, d_out: dict) -> None:
        """Static collect: the deferred counts and the keep-originals re-sweep.

        Fetches each group's counts (``pass2b_counts``), takes the counted
        schedule's decision (``prune.plan_compaction``) and re-sweeps the
        cases it keeps at their input cap from the retained stacks, one
        launch per group, drained under ``pass2b_retry``.  Every other
        case's static result is already exact: the target is the counted
        schedule's re-bucketing boundary, so no survivor was dropped.
        """
        prepped = window.prepped
        retries = []
        for cap, idxs, counts, verts, masks in window.static_aux:
            counts = self._fetch("pass2b_counts", counts)
            retry_js = []
            for j, (i, (mv, mk)) in enumerate(zip(idxs, counts)):
                cap_out, info = prune_kernels.plan_compaction(cap, int(mv), int(mk),
                                                              planlib.vertex_bucket)
                prepped[i].prune_info = info
                prepped[i].vertex_cap = cap_out or cap
                if cap_out is None:
                    retry_js.append(j)
            if retry_js:
                take = to_device(np.asarray(retry_js, np.int64), self.device)
                retries.append((cap, [idxs[j] for j in retry_js],
                                (verts.index_select(0, take), masks.index_select(0, take))))
        if retries:
            futs = self._submit(retries, self._diam_launch, self._stacked_chunk)
            d_out.update(self._drain(futs, "pass2b_retry"))

    def _resolve_hint_counts(self, window: _Window, d_out: dict) -> None:
        """Hint-prep collect: the deferred counts and the overflow retry.

        Fetches each case's true count (``collect_counts``, a feature of
        the row).  A case whose count exceeds its hint cap lost vertices in
        pass 0: it re-runs count-sized through the single-case stages
        (vertex fields, compaction, ``ops.prune_candidates``) and sweeps as
        a batch of one through pass 2b's (sharded) launch, which runs it
        on the first slot alone, drained under ``hint_retry``; a batch of
        one is the single-case kernel, so this gives ``extract_one``'s
        diameters.  Its host compaction pulls the list uncounted, as the
        reference's does.  Runs after the static collect, so a retried row
        wins over both.  The counts are the
        window's staged copies; the case keeps its device count and its
        hint-sized list (unlike the reference, which swaps in the retried
        list), so :meth:`resubmit_window` re-plans it as its first submit.
        """
        for i, staged in window.hint_counts:
            p = window.prepped[i]
            n = int(self._fetch("collect_counts", staged))
            p.n_vertices = n
            if n <= p.verts.shape[0]:  # within the pass-0 cap: nothing was dropped
                continue
            verts, vmask = _compact_at(ops.vertex_fields(p.mask, 0.5, p.spacing),
                                       planlib.vertex_bucket(n))
            v2, m2, p.prune_info = ops.prune_candidates(verts, vmask, k_dirs=self.k_dirs)
            # a batch of one through pass 2b's launch (the first slot): the single-case bits
            d = self._diam_launch(len(v2), to_device(v2[None], self.device),
                                  to_device(m2[None], self.device))
            d_out[i] = self._fetch("hint_retry", d)[0]
            p.vertex_cap = len(v2)

    # -- window API ----------------------------------------------------------

    def submit_window(self, cases, batch_size=None) -> _Window:
        """Prep one window and issue every device launch for it (no drains).

        Each case is an ``(image, mask, spacing)`` tuple or a zero-argument
        loader; a case that fails to load or validate is quarantined.
        """
        prepped = [self._prep_case_safe(c, fields=self.prune) for c in cases]
        return self.submit_prepped(prepped, batch_size)

    def submit_prepped(self, prepped, batch_size=None) -> _Window:
        """Plan and submit already-prepped cases.

        ``schedule='auto'`` resolves here, per window
        (``CostModel.choose_schedule`` on the window's metadata).
        """
        metas = [self._meta(p) for p in prepped]
        schedule = self.schedule
        if schedule == "auto":
            schedule = self.cost_model.choose_schedule(metas)
        plan = planlib.build_plan(metas, schedule, families=self.families)
        # the shape groups' mask stacks, built once for the families and pass 2a
        pools = ({shape: self._pool(prepped, idxs) for shape, idxs in plan.shape_groups.items()}
                 if self._needs_intensity or self.prune else {})
        family_futs = self._submit_families(plan, prepped, pools, batch_size)
        if not self._shape_on:  # intensity only: the family launches are the window
            return self._stage_results(_Window(prepped, plan, [], [], [], 0.0, family_futs))
        if not self.prune:
            fused_entries = [
                (bucket, idxs, self._pool(prepped, idxs))
                for bucket, idxs in plan.fused_groups.items()
            ]
            fused_futs = self._submit(fused_entries, self._fused_launch,
                                      self._stacked_chunk, batch_size)
            return self._stage_results(_Window(prepped, plan, [], [], fused_futs, 0.0,
                                               family_futs))

        t1 = time.perf_counter()
        aux = []
        if not self.device_compact:
            self._prune_pass(plan, prepped)
            entries = None
        elif plan.schedule == "static":
            entries, aux = self._pass1_static(plan, prepped)
        else:
            entries = self._pass1_counted(plan, prepped)
        t_prune = time.perf_counter() - t1

        mc_entries = [(shape, idxs, pools[shape]) for shape, idxs in plan.shape_groups.items()]
        mc_futs = self._submit(mc_entries, self._mc_launch, self._stacked_chunk, batch_size)
        if entries is not None:
            diam_futs = self._submit(entries, self._diam_launch, self._stacked_chunk,
                                     batch_size)
        else:
            groups = planlib.group_indices(
                [None if p.mask is None else len(p.verts) for p in prepped]
            )
            diam_futs = self._submit(
                ((k, idxs, None) for k, idxs in groups.items()),
                self._diam_launch,
                self._host_chunk(lambda i: (prepped[i].verts, prepped[i].vmask)),
                batch_size,
            )
        return self._stage_results(_Window(prepped, plan, mc_futs, diam_futs, [], t_prune,
                                           family_futs, aux))

    def resubmit_window(self, window: _Window) -> _Window:
        """Re-submit a window from its prepped device state (the retry path).

        A collect may have overwritten each case's ``vertex_cap`` with its
        pass-2b bucket, attached a ``PruneInfo`` and, under hint prep, set
        the fetched count; all are reset to the prep-time state (the cap is
        the length of the retained vertex list, the count the hint) before
        re-planning.  The submit stages every result again, the hint
        counts from the device counts the cases keep, so the re-submitted
        window collects like a first submit, under every schedule and
        prep, however far the failed collect got.
        """
        for p in window.prepped:
            if p.mask is None or p.error is not None:
                continue
            if p.verts is not None:
                p.vertex_cap = int(p.verts.shape[0])
                p.prune_info = None
            if p.n_dev is not None:
                p.n_vertices = p.hint
        return self.submit_prepped(window.prepped)

    def collect_window(self, window: _Window):
        """Drain one submitted window; returns ``(rows, stats)`` in input order.

        The intensity families drain first (they were submitted first),
        each under its own stage; then the shape stages, the static
        schedule's deferred counts and re-sweeps, and hint prep's deferred
        counts and overflow retries.  The window's fetches wait for its own
        copy event only (see :meth:`_stage_results`).

        With a ``retry`` policy, a collect that raises re-submits the
        window (:meth:`resubmit_window`) and drains it again after
        ``policy.delay(attempt)`` seconds, up to ``max_retries`` times; the
        last failure re-raises.  An error of the card (:data:`DEVICE_ERRORS`)
        re-raises at once, without backoff: a CUDA error poisons the
        context, so every re-submit would fail too (the reference retries
        any exception).  ``timeout_s`` is advisory: a collect over it is
        flagged in the stats (``collect_timeout``), since a blocking fetch
        cannot be interrupted.  The backoff and the re-submit make no host
        sync, so a retried static/hint window stays sync-free but for its
        counted fetches.
        """
        policy = self.retry
        if policy is None:
            return self._collect_window(window)
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                rows, stats = self._collect_window(window)
            except (KeyboardInterrupt, SystemExit, *DEVICE_ERRORS):
                raise
            except Exception:
                if attempt >= policy.max_retries:
                    raise
                self.window_retries += 1
                time.sleep(policy.delay(attempt))
                window = self.resubmit_window(window)
                attempt += 1
                continue
            dt = time.perf_counter() - t0
            if policy.timeout_s is not None and dt > policy.timeout_s:
                stats["collect_timeout"] = dt
            if attempt:
                stats["window_retries"] = attempt
            return rows, stats

    def _collect_window(self, window: _Window):
        prepped = window.prepped
        fam_out = {family: self._drain(futs, family)
                   for family, futs in window.family_futs.items()}
        shape_out = {}
        if window.fused_futs:  # one-pass path
            shape_out = self._drain(window.fused_futs, "pass2")
        elif self._shape_on:
            mc_out = self._drain(window.mc_futs, "pass2a")
            d_out = self._drain(window.diam_futs, "pass2b")
            if window.static_aux:
                self._resolve_static_aux(window, d_out)
            self._resolve_hint_counts(window, d_out)
            shape_out = {i: self._shape_row(mc_out[i], d_out[i], prepped[i].n_vertices)
                         for i in mc_out}
        rows = [
            self._degenerate_row(p) if p.mask is None
            else self._assemble_row(i, shape_out.get(i), fam_out)
            for i, p in enumerate(prepped)
        ]
        return rows, self._window_stats(window)

    @staticmethod
    def _shape_row(mc, d, n_vertices) -> np.ndarray:
        """The shape row: [volume, area, 4 diameters, vertex count], float32."""
        return np.concatenate([np.asarray(mc, np.float32), np.asarray(d, np.float32),
                               np.asarray([n_vertices], np.float32)])

    def _family_row(self, family: str, payload) -> np.ndarray:
        """One case's fetched family payload as its feature columns, by the
        host derivations: packed stats -> 9 first-order features, count
        matrix -> 4 Haralick features."""
        if family == "firstorder":
            return _fo.features_from_packed_np(payload, self.n_bins)
        return _glcm.glcm_features_from_matrix_np(payload, self.n_bins)

    def _assemble_row(self, i, shape_row, fam_out) -> np.ndarray:
        """Concatenate one case's family parts in canonical family order."""
        parts = [
            np.asarray(shape_row, np.float32) if family == "shape"
            else self._family_row(family, fam_out[family][i])
            for family in self.families
        ]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _degenerate_row(self, p: _Prepped) -> np.ndarray:
        """Row of a case that ran no launches: zeros (empty mask) or NaNs
        (quarantined; the message rides the window stats)."""
        if p.error is not None:
            return np.full(self.n_features, np.nan, np.float32)
        return np.zeros(self.n_features, np.float32)

    def _window_stats(self, window: _Window) -> dict:
        prepped = window.prepped
        infos = [p.prune_info for p in prepped if p.prune_info is not None]
        pruned = [inf for inf in infos if inf.pruned]
        return {
            "families": list(self.families),
            "buckets": len(window.plan.shape_groups),
            "vertex_buckets": len({p.vertex_cap for p in prepped if p.vertex_cap}),
            "pruned_cases": len(pruned),
            "empty_cases": sum(1 for p in prepped if p.mask is None and p.error is None),
            "quarantined_cases": sum(1 for p in prepped if p.error is not None),
            "errors": {i: p.error for i, p in enumerate(prepped) if p.error is not None},
            "mean_keep_fraction": (
                float(np.mean([inf.keep_fraction for inf in infos])) if infos else 1.0
            ),
            "prune_seconds": window.t_prune,
            "plan": window.plan.stats(),
        }

    # -- public driving ------------------------------------------------------

    def run(self, cases: Sequence, batch_size: int | None = None):
        """Extract features for (image, mask, spacing) cases (one window).

        Returns a list of ``(plan.row_width(families),)`` float32 rows in
        input order (``plan.family_slices`` maps each family to its
        columns) plus stats.
        """
        t0 = time.perf_counter()
        fetches0 = dict(self.transfer_log)
        window = self.submit_window(list(cases), batch_size)
        results, stats = self.collect_window(window)
        dt = time.perf_counter() - t0
        stats.update(
            cases=window.plan.n_cases,
            seconds=dt,
            cases_per_second=window.plan.n_cases / dt if dt > 0 else float("inf"),
            data_parallel=self.n_data,
            two_pass=self.prune,
            device_compact=self.prune and self.device_compact,
            schedule=self.schedule,  # 'auto' here; stats['plan']['schedule'] is resolved
            prep=self.prep,
            host_fetches={
                k: v - fetches0.get(k, 0)
                for k, v in self.transfer_log.items()
                if v - fetches0.get(k, 0)
            },
        )
        return results, stats

    def extract_stream(self, cases: Iterable, window: int | str = 32,
                       batch_size: int | None = None, stats_callback=None):
        """Stream ``(image, mask, spacing)`` cases; yields rows in input order.

        Window k+1 is prepped and submitted before window k is collected,
        so the host prep of one window overlaps the card's work on the
        other, and window k's drain waits for its own copies only.
        ``stats_callback(window_index, plan_stats)`` is called at each
        submit.  ``window`` is a positive int or ``'auto'``, windows closed
        by the cost model (:meth:`_stream_auto`).  Rows equal ``run``'s
        bitwise.
        """
        check_window(window)
        if window == "auto":
            return self._stream_auto(iter(cases), batch_size, stats_callback)
        return self._stream(iter(cases), window, batch_size, stats_callback)

    def _stream(self, it, window, batch_size, stats_callback):
        pending = None
        for widx in itertools.count():
            chunk = list(itertools.islice(it, window))
            state = self.submit_window(chunk, batch_size) if chunk else None
            if state is not None and stats_callback is not None:
                stats_callback(widx, state.plan.stats())
            if pending is not None:
                yield from self.collect_window(pending)[0]
            if state is None:
                return
            pending = state

    def _stream_auto(self, it, batch_size, stats_callback):
        """Adaptive windows: each case is prepped as it arrives into an open
        window whose ``plan.WindowCensus`` feeds ``CostModel.should_close``;
        a closed window is submitted before the previous one is collected,
        as in :meth:`_stream`.  The cost model is resolved before the first
        case is prepared."""
        cm = self.cost_model.resolve()
        pending, widx = None, 0
        buf, census = [], planlib.WindowCensus()
        for case in itertools.chain(it, [_END]):
            if case is not _END:
                p = self._prep_case_safe(case, fields=self.prune)
                meta = self._meta(p)
            if buf and (case is _END or cm.should_close(census, meta)):
                state = self.submit_prepped(buf, batch_size)
                if stats_callback is not None:
                    stats_callback(widx, state.plan.stats())
                widx += 1
                buf, census = [], planlib.WindowCensus()
                if pending is not None:
                    yield from self.collect_window(pending)[0]
                pending = state
            if case is not _END:
                buf.append(p)
                census.add(meta)
        if pending is not None:
            yield from self.collect_window(pending)[0]

    def extract_one(self, image, mask, spacing) -> np.ndarray:
        """Single-case path with the pipeline's stages: the parity oracle.

        The same bucket padding, pruning and kernels, without batching:
        the single-case MC and diameter kernels and host compaction, and
        each intensity family at batch depth 1.  Returns a
        ``(plan.row_width(families),)`` row; an empty mask gives zeros.
        Batching never changes a row: ``run`` equals this bitwise, under
        either schedule and either prep (the oracle is always count-sized).
        """
        p = self._prep_case(image, mask, spacing, prep="count")
        if p.mask is None:
            return np.zeros(self.n_features, np.float32)
        shape_row = None
        if self._shape_on:
            verts = torch.as_tensor(p.verts, device=self.device)
            vmask = torch.as_tensor(p.vmask, device=self.device)
            if self.prune:
                verts, vmask, p.prune_info = ops.prune_candidates(verts, vmask,
                                                                  k_dirs=self.k_dirs)
            vol, area = ops.mc_volume_area(p.mask, 0.5, p.spacing, device=self.device,
                                           block=self.mc_block, chunk_z=self.mc_chunk)
            variant, block = self._resolve_diameter(len(verts))
            d = ops.max_diameters(verts, vmask, device=self.device, block=block,
                                  variant=variant)
            out = self._fetch("extract_one", torch.cat([torch.stack([vol, area]), d]))
            shape_row = self._shape_row(out[:2], out[2:], p.n_vertices)
        fam_out = {}
        if self._needs_intensity:
            image, mask = p.image[None], p.mask[None]
            lo, hi = _range.masked_range_batch(image, mask)
            fam_out = {family: self._fetch(family, self._family_fn(family, p.shape, 1)(
                           image, mask, lo, hi))
                       for family in self.families if family != "shape"}
        return self._assemble_row(0, shape_row, fam_out)
