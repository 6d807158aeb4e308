"""Batched multi-case extraction on the card: the public facade.

Counterpart of ``repro.core.pipeline.BatchedExtractor``.  The paper's
motivating workload is a cohort sweep over thousands of CT cases (the
xLUNGS scenario); single-case offload (``ShapeFeatureExtractor``) pays
its launches and host syncs per case, while this path pays them per
group of cases.  It is split, as in the reference, into

* ``core/plan``     -- shape buckets, cap groups and the pass schedule,
  pure functions of per-case metadata;
* ``core/executor`` -- runs a plan with a device-resident data plane:
  pass 0 stages and compacts each case, pass 1 runs the pruning bound and
  the compaction kernel per cap group, pass 2a the batched
  marching-cubes kernel per shape bucket, pass 2b the batched diameter
  kernel per pruned vertex bucket; the intensity families run the
  first-order and GLCM kernels per shape bucket in the same window.
  ``schedule='static'`` and ``prep='hint'`` make passes 0 and 1 fetch
  nothing, so ``extract_stream`` can submit window k+1 while the card
  still runs window k.

Usage::

    from repro_torch.core.pipeline import BatchedExtractor
    rows, stats = BatchedExtractor().run(cases)   # cases: (image, mask, spacing)
    # rows[i]: [MeshVolume, SurfaceArea, Maximum3DDiameter,
    #           Maximum2DDiameterSlice, Maximum2DDiameterRow,
    #           Maximum2DDiameterColumn, n_vertices]
    ext = BatchedExtractor(families=("shape", "firstorder", "glcm"))
    rows, stats = ext.run(cases)   # 20 columns: plan.family_slices(ext.families)

``run`` / ``extract_batch`` extract one window; ``extract_stream`` yields
the rows of a stream of cases, window by window, in input order;
``extract_one`` is the single-case parity oracle (identical stages, no
batching, bitwise the same row).  ``prune=False`` (one-pass, unpruned),
``device_compact=False`` (host compaction), ``schedule='counted'`` and
``prep='count'`` are the reference's parity baselines: every schedule,
prep and window gives the same rows, bitwise.  Empty masks give zero
rows; cases that fail to load or validate give NaN rows and an
``errors`` entry in the stats.

Streaming::

    ext = BatchedExtractor(families=("shape", "firstorder", "glcm"),
                           schedule="static", prep="hint")
    for row in ext.extract_stream(cases, window=20):   # any iterable
        ...

Out-of-core cases (``core/tiled``): a ``TiledCase`` always takes the tiled
engine, and with ``tiled=True`` so does a tuple whose staged frame would
exceed the tile budget (``tile_mem_mb``, default ``REPRO_TILE_MEM_MB``);
``run`` merges their rows back in input order with ``stats["tiled"]``,
``extract_stream`` runs them between the in-core segments of the stream,
and ``extract_tiled`` runs one case.  ``tile_prune`` is ``'none'``,
``'occupancy'`` or ``'bounds'``; ``mc_chunk`` the marching-cubes z-granule
both paths share, so a tiled row equals ``extract_one``'s bitwise.

The auto knobs (``runtime/costmodel``, reached as ``cost_model``):
``schedule='auto'`` picks counted or static per window, and
``extract_stream(cases, window='auto')`` closes each window where the
cost model says; both give the fixed knobs' rows bitwise.

Serving::

    with BatchedExtractor(schedule="static", prep="hint").serve() as svc:
        fut = svc.submit(cases, tenant="clinic-a", deadline_s=2.0)
        res = fut.result(timeout=60)   # res.rows, res.errors, res.latency_s

``serve()`` starts a ``serve.service.ExtractionService``: a persistent
driver thread fuses concurrent clients' cases into shared windows, with
admission by queued bytes, per-request deadlines and quarantine; served
rows equal ``extract_stream``'s bitwise.

Data parallelism::

    from repro_torch.launch.mesh import make_host_mesh
    ext = BatchedExtractor(mesh=make_host_mesh())   # every visible card
    rows, stats = ext.run(cases)                    # stats["data_parallel"] cards

``mesh=`` (a ``parallel/sharding.Mesh``, or the ambient ``use_mesh`` mesh
when it has ``data_axis``) shards every batched pass over the mesh's data
axis and gathers on its first device, the extractor's device; the rows
equal the unsharded run's bitwise.  Tiled cases run on that first device.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import plan as planlib
from repro_torch.core.executor import PlanExecutor, check_window
from repro_torch.core.tiled import TiledExtractor
from repro_torch.data.tiles import TiledCase


class BatchedExtractor:
    """Batched multi-case feature extraction on one card or a mesh of them.

    The facade over ``plan.build_plan`` + ``executor.PlanExecutor``.
    ``device`` defaults to ``'cuda'`` and raises ``RuntimeError`` without a
    card; ``device='cpu'`` runs the plain versions of the kernels.
    ``prune=True`` (default) runs the two-pass pruned pipeline,
    ``prune=False`` the one-pass path; ``device_compact=True`` (default)
    compacts pass 1's survivors on the card, ``device_compact=False`` on
    the host.  ``families`` picks any of ``"shape"`` (the default),
    ``"firstorder"`` and ``"glcm"``; ``n_bins`` is the intensity families'
    bin count.  ``variant`` is the diameter variant: ``'auto'`` (the
    default, the autotuned choice per launch) or any of
    ``kernels.diameter.VARIANTS``.  ``schedule`` is ``'counted'`` (a
    count fetch per cap group in pass 1) or ``'static'`` (none; the counts
    are fetched at collect); ``prep`` is ``'count'`` (a count fetch per
    case in pass 0) or ``'hint'`` (caps from metadata, counts fetched at
    collect); both sync-free options need ``prune`` and
    ``device_compact``.  ``schedule='auto'`` lets the cost model pick per
    window (``cost_model``).  ``mesh`` and ``data_axis`` shard the batched
    passes over a mesh of devices (see ``core/executor``); ``.mesh`` is the
    executor's mesh, the ambient one where it was adopted.
    """

    N_FEATURES = PlanExecutor.N_FEATURES

    def __init__(self, device=None, variant="auto", mesh=None, data_axis: str = "data",
                 prune: bool = True, mc_block="auto", mc_chunk: int | None = None,
                 k_dirs: int = 16, device_compact: bool = True, compact_block="auto",
                 schedule: str = "counted", prep: str = "count", transfer_callback=None,
                 retry=None, families=None, n_bins: int = 32, tiled: bool = False,
                 tile_prune: str = "bounds", tile_mem_mb: float | None = None):
        self.executor = ex = PlanExecutor(
            device=device, variant=variant, mesh=mesh, data_axis=data_axis, prune=prune,
            mc_block=mc_block, mc_chunk=mc_chunk, k_dirs=k_dirs, device_compact=device_compact,
            compact_block=compact_block, schedule=schedule, prep=prep,
            transfer_callback=transfer_callback, retry=retry, families=families,
            n_bins=n_bins,
        )
        self.tiled = bool(tiled)
        self.tile_prune = tile_prune
        self._tile_budget = None if tile_mem_mb is None else int(tile_mem_mb * 2**20)
        self._tiledx = None  # built on the first tiled case (family-validated)
        self.device = ex.device
        self.mesh = ex.mesh
        self.data_axis = ex.data_axis
        self.families = ex.families
        self.n_features = ex.n_features
        self.n_bins = ex.n_bins
        self.variant = ex.variant
        self.prune = ex.prune
        self.device_compact = ex.device_compact
        self.schedule = ex.schedule
        self.prep = ex.prep

    @property
    def cost_model(self):
        """The executor's decision layer (``runtime/costmodel.CostModel``)."""
        return self.executor.cost_model

    @property
    def tiled_extractor(self) -> TiledExtractor:
        """The lazily built out-of-core engine (``core/tiled``)."""
        if self._tiledx is None:
            self._tiledx = TiledExtractor(self.executor, budget_bytes=self._tile_budget,
                                          tile_prune=self.tile_prune)
        return self._tiledx

    def _route_tiled(self, case) -> bool:
        """Should ``case`` take the out-of-core path?

        A ``TiledCase`` always does (constructing one is the opt-in).  With
        ``tiled=True``, a materialised tuple whose staged frame (mask and,
        with an intensity family, image, float32) would exceed the tile
        budget does too; loader callables stay in-core, since their shape
        is unknown until loaded.
        """
        if isinstance(case, TiledCase):
            return True
        if not self.tiled or not (isinstance(case, (tuple, list)) and len(case) == 3):
            return False
        mask = np.asarray(case[1])
        if mask.ndim != 3:
            return False
        staged = 4 * mask.size * (1 + int(self.executor._needs_intensity))
        return staged > self.tiled_extractor.budget_bytes

    @staticmethod
    def _as_tiled(case) -> TiledCase:
        if isinstance(case, TiledCase):
            return case
        image, mask, spacing = case
        return TiledCase(mask, image=image, spacing=spacing)

    def extract_tiled(self, case):
        """Run one case (a ``TiledCase`` or an ``(image, mask, spacing)``
        tuple) through the out-of-core engine; returns its
        ``core.tiled.TiledResult`` (row, metadata, tile stats)."""
        return self.tiled_extractor.extract(self._as_tiled(case))

    def run(self, cases: Sequence, batch_size: int | None = None):
        """Extract features for (image, mask, spacing) cases (one window).

        Returns a list of ``(plan.row_width(families),)`` float32 rows in
        input order plus stats.  Cases routed out-of-core (see
        :meth:`_route_tiled`) run through the tiled engine and merge back
        in input order; their metadata joins the stats as a
        ``plan.WindowCensus`` under ``stats["tiled"]``, and the in-core
        window's ``host_fetches`` count the in-core cases alone.
        """
        cases = list(cases)
        tiled_idx = [i for i, c in enumerate(cases) if self._route_tiled(c)]
        if not tiled_idx:
            return self.executor.run(cases, batch_size)
        skip = set(tiled_idx)
        incore = [c for i, c in enumerate(cases) if i not in skip]
        rows, stats = self.executor.run(incore, batch_size) if incore else ([], {"cases": 0})
        rows = list(rows)
        census = planlib.WindowCensus()
        tile_stats = []
        for i in tiled_idx:
            res = self.tiled_extractor.extract(self._as_tiled(cases[i]))
            rows.insert(i, res.row)
            census.add(res.meta)
            tile_stats.append(res.stats)
        stats = dict(stats)
        stats["tiled"] = {
            "cases": len(tiled_idx),
            "census": census,
            **{k: sum(s.get(k, 0) for s in tile_stats)
               for k in ("tiles", "tiles_skipped", "tiles_bounds_pruned")},
        }
        return rows, stats

    def extract_batch(self, cases: Sequence, batch_size: int | None = None):
        """Alias of :meth:`run`."""
        return self.run(cases, batch_size)

    def extract_stream(self, cases: Iterable, window: int | str = 32,
                       batch_size: int | None = None, stats_callback=None):
        """Stream (image, mask, spacing) cases; yields rows in input order.

        The executor's fixed-window stream (``PlanExecutor.
        extract_stream``): window k+1 is prepped and submitted before
        window k is drained, and ``stats_callback(i, plan_stats)`` reports
        each window's plan census at submit.  A case routed out-of-core
        (see :meth:`_route_tiled`) splits the stream: the in-core segment
        before it is flushed through the windowed stream, the tiled case
        runs through the tiled engine, and streaming resumes after it; no
        prep overlaps across that boundary.  ``window`` is a positive int or
        ``'auto'`` (each in-core segment in the cost model's windows), and
        is checked here, before the first case is read.
        """
        check_window(window)

        def segments():
            seg = []
            for case in cases:
                if self._route_tiled(case):
                    if seg:
                        yield False, seg
                        seg = []
                    yield True, case
                else:
                    seg.append(case)
            if seg:
                yield False, seg

        def rows():
            for tiled, item in segments():
                if tiled:
                    yield self.extract_tiled(item).row
                else:
                    yield from self.executor.extract_stream(
                        item, window=window, batch_size=batch_size,
                        stats_callback=stats_callback)

        return rows()

    def extract_one(self, image, mask, spacing):
        """Single-case parity oracle (identical stages, no batching)."""
        return self.executor.extract_one(image, mask, spacing)

    def serve(self, *, max_queue_bytes: float | None = None, idle_tick_s: float = 0.002):
        """Start the persistent multi-tenant service over this extractor.

        Returns a running ``serve.service.ExtractionService`` (also a
        context manager): concurrent clients ``submit()`` cases, and its
        driver thread fuses them across tenants into shared windows under
        the cost model's close rules, each request's deadline and the
        queue-byte budget.
        """
        from repro_torch.serve.service import ExtractionService

        return ExtractionService(self, max_queue_bytes=max_queue_bytes,
                                 idle_tick_s=idle_tick_s)
