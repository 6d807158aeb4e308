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

Usage::

    from repro_torch.core.pipeline import BatchedExtractor
    rows, stats = BatchedExtractor().run(cases)   # cases: (image, mask, spacing)
    # rows[i]: [MeshVolume, SurfaceArea, Maximum3DDiameter,
    #           Maximum2DDiameterSlice, Maximum2DDiameterRow,
    #           Maximum2DDiameterColumn, n_vertices]
    ext = BatchedExtractor(families=("shape", "firstorder", "glcm"))
    rows, stats = ext.run(cases)   # 20 columns: plan.family_slices(ext.families)

``run`` / ``extract_batch`` extract one window; ``extract_one`` is the
single-case parity oracle (identical stages, no batching, bitwise the
same row).  ``prune=False`` (one-pass, unpruned) and
``device_compact=False`` (host compaction) are the reference's parity
baselines.  Empty masks give zero rows; cases that fail to load or
validate give NaN rows and an ``errors`` entry in the stats.

Not ported yet: tiled and served extraction (ROADMAP.md Queue 1 items 7
and 9), and the options the executor refuses (see ``core/executor``).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.executor import PlanExecutor


class BatchedExtractor:
    """Batched multi-case feature extraction on one card.

    The facade over ``plan.build_plan`` + ``executor.PlanExecutor``.
    ``device`` defaults to ``'cuda'`` and raises ``RuntimeError`` without a
    card; ``device='cpu'`` runs the plain versions of the kernels.
    ``prune=True`` (default) runs the two-pass pruned pipeline,
    ``prune=False`` the one-pass path; ``device_compact=True`` (default)
    compacts pass 1's survivors on the card, ``device_compact=False`` on
    the host.  ``families`` picks any of ``"shape"`` (the default),
    ``"firstorder"`` and ``"glcm"``; ``n_bins`` is the intensity families'
    bin count.  Only ``schedule='counted'`` and ``prep='count'`` are
    ported; the other options of the reference raise ``ValueError``
    naming their ROADMAP item.
    """

    N_FEATURES = PlanExecutor.N_FEATURES

    def __init__(self, device=None, variant="auto", mesh=None, prune: bool = True,
                 mc_block="auto", k_dirs: int = 16, device_compact: bool = True,
                 compact_block="auto", schedule: str = "counted", prep: str = "count",
                 transfer_callback=None, retry=None, families=None, n_bins: int = 32):
        self.executor = ex = PlanExecutor(
            device=device, variant=variant, mesh=mesh, prune=prune, mc_block=mc_block,
            k_dirs=k_dirs, device_compact=device_compact, compact_block=compact_block,
            schedule=schedule, prep=prep, transfer_callback=transfer_callback,
            retry=retry, families=families, n_bins=n_bins,
        )
        self.device = ex.device
        self.families = ex.families
        self.n_features = ex.n_features
        self.n_bins = ex.n_bins
        self.variant = ex.variant
        self.prune = ex.prune
        self.device_compact = ex.device_compact
        self.schedule = ex.schedule
        self.prep = ex.prep

    def run(self, cases: Sequence, batch_size: int | None = None):
        """Extract features for (image, mask, spacing) cases (one window).

        Returns a list of ``(plan.row_width(families),)`` float32 rows in
        input order plus stats.
        """
        return self.executor.run(list(cases), batch_size)

    def extract_batch(self, cases: Sequence, batch_size: int | None = None):
        """Alias of :meth:`run`."""
        return self.run(cases, batch_size)

    def extract_stream(self, *args, **kwargs):
        """Not ported yet (ROADMAP.md Queue 1 item 4(b)); raises ValueError."""
        return self.executor.extract_stream(*args, **kwargs)

    def extract_one(self, image, mask, spacing):
        """Single-case parity oracle (identical stages, no batching)."""
        return self.executor.extract_one(image, mask, spacing)
