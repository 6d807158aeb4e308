"""Measured kernel-configuration selection on the card.

Counterpart of ``repro.runtime.autotune`` for the port's kernels.  No
single configuration wins at every problem size (the paper's Fig. 1
study), so per static *bucket* (the vertex padding cap for the diameter
and compaction kernels, the padded volume shape for the intensity
families) and batch depth this module sweeps the candidates once on the
card, caches the winner in a JSON file, and hands the cached choice to
every later call.  The tuned axes:

* **diameter**: ``(variant, block)`` over :data:`DEFAULT_VARIANTS` x
  :data:`DEFAULT_BLOCKS`, timed as the kernel launch of
  ``max_diameters_sq_batch`` on a ``(depth, bucket)`` stack, the launch
  pass 2b issues.  A list in its own bucket is probed 3/4 full
  (:func:`probe_extent`); a static schedule's target (``plan.
  static_bucket``) has keys of its own, probed 1/32 full
  (:func:`static_probe_extent`): its lists hold the pruning survivors of
  a bucket twice its size, mostly empty, where an upper-triangle tile
  launch costs many times an extent sweep and small blocks spread the
  few valid rows over more SMs;
* **compaction**: ``block``, the keep flags a CUDA block takes (a
  multiple of ``compact.TILE_GRAIN``, 512, up to 16384);
* **first-order**: ``block`` (a multiple of ``firstorder.CANON_CHUNK``);
* **GLCM**: ``block``, the CUDA blocks an SM its launch aims at, which
  sizes its tiles (1 to ``glcm.MAX_BLOCK``).

None of these changes a bit of a result: the direct diameter variants
agree bitwise at every block, compaction copies bits, and the family
kernels' sums are fixed by their canonical chunks, whatever the block.

Marching cubes is not tuned.  Its partial order is fixed by the shape,
``mc_chunk`` and the kernel's tile constants, not by its ``block``
(``kernels/marching_cubes.py``), so a tuned block would keep tiled ==
in-core; ``mc_chunk`` still sets the order, and the tiled path equals the
in-core path bitwise only because both use the same granule.
``mc_block='auto'`` resolves to the defaults and the ``mc/cuda``
namespace is not read.

Cache schema (versioned, shared with the reference): one JSON object
``{"schema": 3, "entries": {...}}`` keyed ``"diameter/cuda/M<bucket>/B<depth>"``
(a static target: ``"diameter/cuda/T<target>/B<depth>"``),
``"compact/cuda/M<bucket>/B<depth>"`` and ``"<family>/cuda/S<nx>x<ny>x<nz>/B<depth>"``;
``B<depth>`` is the power-of-two batch-depth bucket (:func:`batch_bucket`).
Each record holds the winner and the measured table (microseconds) and
its kernels' ``revision`` (``REVISION`` of ``kernels/diameter.py``,
``compact.py``, ``firstorder.py`` and ``glcm.py``); one measured against
another revision (or carrying none) is swept again.
The reference's files read back here and ours there (its keys carry
``pallas`` or ``interpret`` where ours carry ``cuda``, which it never
looks up).  A v1 file (flat,
no schema) or v2 (depth-less keys) migrates on load (the keys gain
``/B1``); an unknown future schema reads as empty and is never
overwritten; a malformed file reads as empty.  Writes are atomic (tmp +
rename), so concurrent processes at worst re-measure.  The path is
``REPRO_AUTOTUNE_CACHE``, default ``~/.cache/repro_autotune.json``.

Measurement: each candidate's input is prepared once, outside the
timing; the candidates take turns, one launch each per round, and each
launch's device time comes from CUDA events recorded behind a spin kernel
(so the host's enqueue is not timed); the median of the rounds is kept.

Policy: sweeps run by default on ``'cuda'``; ``REPRO_AUTOTUNE=0``
disables them (a miss returns the default, uncached).  ``'cpu'`` has no
axis: ``'auto'`` gives the defaults and never touches the cache.
:data:`SWEEPS` counts the sweeps this process ran, :data:`SWEEP_SECONDS`
their host-clock seconds by kind.

Probes (the cost model's inputs, ``runtime/costmodel``): the per-fetch
device-to-host latency (:func:`get_sync_cost`, key ``sync/<device>``) and
the card's roofline profile, peak FP32 rate and memory bandwidth
(:func:`get_hw_profile`, key ``hw/<device>``).  They follow the sweeps'
policy: a cached record wins, a miss probes on ``'cuda'`` unless
``REPRO_AUTOTUNE=0`` and stores the result, and ``'cpu'`` never probes.
With probing off the defaults apply, uncached: :data:`DEFAULT_SYNC_US`
and :data:`DEFAULT_HW_PROFILES`.  A probe that raises is not caught.
:data:`PROBES` counts the probes this process ran, :data:`PROBE_SECONDS`
their host-clock seconds by kind.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from repro_torch.kernels import compact as _compact
from repro_torch.kernels import diameter as _diam
from repro_torch.kernels import firstorder as _fo
from repro_torch.kernels import glcm as _glcm
from repro_torch.kernels import masked_range as _range

SCHEMA_VERSION = 3

# The reference's candidates without 'gram': its bits differ from the
# direct sweep's in the last place, so an 'auto' that picked it at one
# bucket or depth and not at another would break batched == single and
# tiled == in-core.  It runs when asked for by name.  'tri_prefetch' gives
# seqacc's bits and, on its upper-triangle tiles, beats it at the largest
# lists at block 512 (PERF.md, section 6); 'fused', 'tri' and 'naive' are
# slower than it everywhere.
DEFAULT_VARIANTS = ("seqacc", "tri_prefetch", "nomask")
# the card's sweep of the extent-sweep kernels (PERF.md, section 6): 64 wins
# at buckets 512-2048, 128 up to 16384, 256 and 512 above; 1024 gains at
# most 1.3% at the two largest keys and is left out (4 blocks at most, so
# a sweep grows by no more than a third over three blocks)
DEFAULT_BLOCKS = (64, 128, 256, 512)
DEFAULT_COMPACT_BLOCKS = (1024, 2048, 4096, 8192)  # keep flags a CUDA block
DEFAULT_FIRSTORDER_BLOCKS = (1024, 2048, 4096)
DEFAULT_GLCM_BLOCKS = (2, 4, 8)  # CUDA blocks an SM
# variants a cached diameter entry may name for 'auto': the direct ones
AUTO_VARIANTS = tuple(v for v in _diam.VARIANTS if v != "gram")
# a static target's probe lists are valid over 1/STATIC_PROBE_SHARE of its
# slots: the cohort's static targets hold 0.2-19% of theirs (median 2.4%),
# and on the card the 1/32 probe's winners sweep the cohort's real static
# lists in 0.951x the time of seqacc at the default block, the 1/4 probe's
# (the cost model's assumed keep fraction) in 1.325x, the 3/4 probe's in
# 4.105x (experiments/torch_static_probe.py; PERF.md, section 6)
STATIC_PROBE_SHARE = 32

REPEAT = 15  # timed rounds of a sweep, each candidate once a round
MIN_REPEAT = 3  # the fewest rounds where REPEAT would overrun SWEEP_BUDGET_S
SWEEP_BUDGET_S = 1.0  # device seconds the timed rounds of one sweep aim at
_SPIN_CYCLES = 1 << 18  # ~0.13 ms of spin ahead of each timed launch

SWEEPS = 0  # measuring sweeps run by this process (any kernel)
PROBES = 0  # sync and hardware probes run by this process
PROBE_SECONDS = dict.fromkeys(("sync", "hw"), 0.0)
SWEEP_SECONDS = dict.fromkeys(("diameter", "compact", "firstorder", "glcm"), 0.0)
_PARSED: dict = {}  # path -> (file stamp, parsed JSON): see AutotuneCache._read_raw


@dataclasses.dataclass(frozen=True)
class DiameterConfig:
    variant: str
    block: int


@dataclasses.dataclass(frozen=True)
class CompactConfig:
    block: int


@dataclasses.dataclass(frozen=True)
class FamilyConfig:
    """One intensity-family kernel configuration (block is the only axis)."""

    block: int


DEFAULT_CONFIG = DiameterConfig(_diam.DEFAULT_VARIANT, _diam.DEFAULT_BLOCK)
DEFAULT_COMPACT_CONFIG = CompactConfig(_compact.DEFAULT_BLOCK)
DEFAULT_FIRSTORDER_CONFIG = FamilyConfig(_fo.DEFAULT_BLOCK)
DEFAULT_GLCM_CONFIG = FamilyConfig(_glcm.DEFAULT_BLOCK)


def cache_path() -> str:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_autotune.json")


def _migrate_key(key: str) -> str:
    """v1/v2 -> v3 key migration: depth-less keys gain the ``/B1`` segment
    (those sweeps measured single-case launches); other keys pass through."""
    parts = key.split("/")
    if len(parts) == 3 and parts[0] in ("diameter", "mc", "compact"):
        return key + "/B1"
    return key


class AutotuneCache:
    """Tiny versioned JSON key -> record store with atomic writes.

    On disk ``{"schema": 3, "entries": {key: record}}``.  v1 (flat, no
    ``schema``) and v2 (depth-less keys) files migrate on load; an unknown
    schema or a malformed file reads as empty, so a stale cache costs a
    re-sweep, never a crash.
    """

    def __init__(self, path: str | None = None):
        self.path = path or cache_path()

    def _read_raw(self) -> dict:
        """The file's JSON object, parsed once per version of the file (its
        inode, size and mtime): a lookup on a warm cache costs a ``stat``."""
        try:
            st = os.stat(self.path)
            stamp = (st.st_ino, st.st_size, st.st_mtime_ns)
            seen = _PARSED.get(self.path)
            if seen is not None and seen[0] == stamp:
                return seen[1]
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        data = data if isinstance(data, dict) else {}
        _PARSED[self.path] = (stamp, data)
        return data

    def _entries(self) -> dict:
        raw = self._read_raw()
        if "schema" not in raw:  # v1: a flat key -> record mapping
            return {_migrate_key(k): v for k, v in raw.items() if isinstance(v, dict)}
        if raw.get("schema") == 2:
            ent = raw.get("entries")
            if not isinstance(ent, dict):
                return {}
            return {_migrate_key(k): v for k, v in ent.items() if isinstance(v, dict)}
        if raw.get("schema") != SCHEMA_VERSION:
            return {}  # a future schema: do not guess, re-measure
        ent = raw.get("entries")
        return ent if isinstance(ent, dict) else {}

    def get(self, key: str):
        return self._entries().get(key)

    def put(self, key: str, record: dict) -> None:
        schema = self._read_raw().get("schema")
        if isinstance(schema, int) and schema > SCHEMA_VERSION:
            return  # a newer version owns this file: never destroy its entries
        entries = dict(self._entries())  # migrates v1/v2 entries forward
        entries[key] = record
        payload = {"schema": SCHEMA_VERSION, "entries": entries}
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:  # the cache is best-effort
            try:
                os.unlink(tmp)
            except OSError:
                pass


def batch_bucket(depth: int) -> int:
    """Power-of-two batch-depth bucket (limits the per-depth key space)."""
    b = 1
    while b < int(depth):
        b *= 2
    return b


def sweep_key(bucket: int, backend: str, batch: int = 1) -> str:
    return f"diameter/{backend}/M{int(bucket)}/B{batch_bucket(batch)}"


def static_key(target: int, backend: str, batch: int = 1) -> str:
    """The key of a static schedule's pass-2b launch at ``target`` slots."""
    return f"diameter/{backend}/T{int(target)}/B{batch_bucket(batch)}"


def compact_key(bucket: int, backend: str, batch: int = 1) -> str:
    return f"compact/{backend}/M{int(bucket)}/B{batch_bucket(batch)}"


def family_key(family: str, shape, backend: str, batch: int = 1) -> str:
    """``<family>/<backend>/S<nx>x<ny>x<nz>/B<depth>`` for a padded-volume bucket."""
    nx, ny, nz = (int(s) for s in shape)
    return f"{family}/{backend}/S{nx}x{ny}x{nz}/B{batch_bucket(batch)}"


def mc_shape_bucket(shape, step: int = 32) -> tuple[int, int, int]:
    """Pad a volume shape up to the autotune bucket grid (limits key space)."""
    return tuple(max(step, int(math.ceil(int(s) / step)) * step) for s in shape)


def _sweep_allowed() -> bool:
    return os.environ.get("REPRO_AUTOTUNE") != "0"


def _time_launches(launches: dict) -> dict:
    """Median device seconds of each zero-argument launch in ``launches``.

    One untimed round first (lazy kernel loading, the allocator), then
    rounds that time every candidate once in turn, so a drift of clocks or
    host load falls on all of them alike: :data:`REPEAT` rounds, fewer (not
    under :data:`MIN_REPEAT`) where they would take over
    :data:`SWEEP_BUDGET_S`.  A sample is a pair of CUDA events around one
    launch, recorded behind a spin kernel that keeps the card busy while
    the host enqueues the launch: the events bracket the kernel's device
    time, not the host's.
    """
    t0 = time.perf_counter()
    for call in launches.values():
        call()
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    rounds = max(MIN_REPEAT, min(REPEAT, int(SWEEP_BUDGET_S / max(round_s, 1e-9))))
    samples = {k: [] for k in launches}
    for _ in range(rounds):
        for k, call in launches.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SPIN_CYCLES)
            start.record()
            call()
            end.record()
            end.synchronize()
            samples[k].append(start.elapsed_time(end) * 1e-3)
    return {k: statistics.median(v) for k, v in samples.items()}


def _table(times: dict, name) -> tuple:
    """``(best, table)`` of measured ``{config: seconds}``, the table keyed
    ``name(config)`` in microseconds."""
    best = min(times, key=times.get)
    return best, {name(c): t * 1e6 for c, t in times.items()}


def _cached_or_swept(kind: str, key: str, default, parse, sweep, name, extra=None):
    """The config cached under ``key`` (``parse`` of its record, ``None`` when
    unusable), else ``sweep()``'s winner, stored with its table and the
    fields of ``extra``; ``default``, uncached, when sweeps are off."""
    global SWEEPS
    cache = AutotuneCache()
    hit = cache.get(key)
    if hit is not None:
        try:
            cfg = parse(hit)
        except (KeyError, TypeError, ValueError):
            cfg = None
        if cfg is not None:
            return cfg
    if not _sweep_allowed():
        return default
    SWEEPS += 1
    t0 = time.perf_counter()
    best, table = sweep()
    SWEEP_SECONDS[kind] += time.perf_counter() - t0
    cache.put(key, {**dataclasses.asdict(best), "us": table[name(best)], "table": table,
                    "swept_at": time.strftime("%Y-%m-%dT%H:%M:%S"), **(extra or {})})
    return best


def _usable(blocks, bucket: int):
    """Blocks larger than the bucket only pad the grid: drop them, keeping
    the smallest candidate when all are larger."""
    return [b for b in blocks if b <= bucket] or [min(blocks)]


def _valid_block(block: int) -> bool:
    return block % 32 == 0 and 32 <= block <= 1024


# ---------------------------------------------------------------------------
# diameter (variant, block)
# ---------------------------------------------------------------------------


def _diameter_name(cfg: DiameterConfig) -> str:
    return f"{cfg.variant}/{cfg.block}"


def probe_extent(bucket: int) -> int:
    """Valid slots of each list of the diameter probe: 3/4 of the bucket."""
    return max(1, 3 * int(bucket) // 4)


def static_probe_extent(target: int) -> int:
    """Valid slots of each list of a static target's probe: ``max(2,
    target // STATIC_PROBE_SHARE)``, near the pruning survivors' measured
    fill there (:data:`STATIC_PROBE_SHARE`), far from the 3/4 of
    :func:`probe_extent`, where ``tri_prefetch``, which launches every
    upper-triangle tile of the target, wins."""
    return max(2, int(target) // STATIC_PROBE_SHARE)


def _diameter_probe(bucket: int, device, batch: int, seed: int = 0, extent=None):
    """A ``(batch, bucket)`` stack of normally scattered vertices, each list
    valid-first over ``extent`` slots (default :func:`probe_extent`: a list
    of n vertices sits in the bucket of the next power of two, so it fills
    between half and all of it); ``seqacc`` and ``nomask`` sweep only that
    extent."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    verts = torch.from_numpy(
        (rng.normal(size=(max(1, batch), bucket, 3)) * 10.0).astype(np.float32)).to(dev)
    masks = torch.arange(bucket, device=dev) < (probe_extent(bucket) if extent is None
                                                else int(extent))
    return verts, masks.expand(verts.shape[:2]).contiguous()


def measure_diameter_configs(bucket: int, device, configs, *, batch: int = 1,
                             extent=None) -> dict:
    """Median device seconds of each :class:`DiameterConfig` on one
    ``(batch, bucket)`` probe stack, its lists valid over ``extent`` slots:
    the kernel launch pass 2b issues (``diameter.batch_launcher``), its
    input prepared outside the timing."""
    verts, masks = _diameter_probe(bucket, device, batch, extent=extent)
    with torch.cuda.device(verts.device):
        return _time_launches({c: _diam.batch_launcher(verts, masks, block=c.block,
                                                       variant=c.variant) for c in configs})


def sweep_diameter(bucket: int, device, *, batch: int = 1, extent=None):
    """Measure every (variant, block) candidate on lists valid over
    ``extent`` slots (default :func:`probe_extent`); returns ``(best,
    table)``, ``table`` mapping ``"variant/block"`` to microseconds."""
    configs = [DiameterConfig(v, b) for v in DEFAULT_VARIANTS
               for b in _usable(DEFAULT_BLOCKS, bucket)]
    return _table(measure_diameter_configs(bucket, device, configs, batch=batch, extent=extent),
                  _diameter_name)


def _parse_diameter(rec) -> DiameterConfig | None:
    if rec.get("revision") != _diam.REVISION:
        return None  # measured against other kernels or probes (or before revisions)
    cfg = DiameterConfig(str(rec["variant"]), int(rec["block"]))
    return cfg if cfg.variant in AUTO_VARIANTS and _valid_block(cfg.block) else None


def get_diameter_config(bucket: int, device, *, batch: int = 1,
                        static: bool = False) -> DiameterConfig:
    """Cached-or-swept best ``(variant, block)`` for a (bucket, depth) pair.

    ``static=True``: ``bucket`` is a static schedule's pass-2b target,
    looked up under :func:`static_key` and swept on lists valid over
    :func:`static_probe_extent` of its slots.

    A cache hit runs no kernel.  A miss sweeps (when allowed, see the
    module docstring) at the batch-depth bucket of ``batch``, stores the
    winner and its table, and returns it; when sweeping is not allowed the
    default comes back uncached.  A cached entry that names ``gram``, an
    unknown variant or a block the kernel refuses, or that was measured
    against another revision of the kernels or of their probes
    (``diameter.REVISION``), counts as a miss.
    """
    backend = torch.device(device).type
    if backend == "cpu":
        return DEFAULT_CONFIG
    if static:
        key, extent = static_key(bucket, backend, batch), static_probe_extent(bucket)
    else:
        key, extent = sweep_key(bucket, backend, batch), None
    return _cached_or_swept(
        "diameter", key, DEFAULT_CONFIG, _parse_diameter,
        lambda: sweep_diameter(bucket, device, batch=batch_bucket(batch), extent=extent),
        _diameter_name, extra={"revision": _diam.REVISION})


# ---------------------------------------------------------------------------
# compaction tile
# ---------------------------------------------------------------------------


def _block_name(cfg) -> str:
    return str(cfg.block)


def _compact_probe(bucket: int, device, batch: int, seed: int = 0):
    """``(verts, keep, cap)``: ~25% of a ``(batch, bucket)`` stack kept (the
    pipeline's typical keep fraction) into a ``max(512, bucket // 4)`` cap."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    batch = max(1, int(batch))
    verts = torch.from_numpy(
        (rng.normal(size=(batch, bucket, 3)) * 10.0).astype(np.float32)).to(dev)
    keep = torch.from_numpy(rng.random((batch, bucket)) < 0.25).to(dev)
    return verts, keep, max(512, int(bucket) // 4)


def measure_compact_configs(bucket: int, device, configs, *, batch: int = 4) -> dict:
    """Median device seconds of the compaction kernel at each
    :class:`CompactConfig`'s tile on one probe."""
    verts, keep, cap = _compact_probe(bucket, device, batch)
    with torch.cuda.device(verts.device):
        return _time_launches({c: functools.partial(_compact.compact_batch, verts, keep, cap,
                                                    block=c.block) for c in configs})


def sweep_compact(bucket: int, device, *, batch: int = 4):
    """Measure every tile; returns ``(best, table)`` keyed
    ``str(block)`` in microseconds."""
    configs = [CompactConfig(b) for b in DEFAULT_COMPACT_BLOCKS]
    return _table(measure_compact_configs(bucket, device, configs, batch=batch), _block_name)


def _parse_compact(rec) -> CompactConfig | None:
    if rec.get("revision") != _compact.REVISION:
        return None  # measured against another kernel (or before revisions)
    cfg = CompactConfig(int(rec["block"]))
    return cfg if _compact.valid_block(cfg.block) else None


def get_compact_config(bucket: int, device, *, batch: int = 1) -> CompactConfig:
    """Cached-or-swept compaction tile per (input bucket, depth); the
    contract of :func:`get_diameter_config`."""
    backend = torch.device(device).type
    if backend == "cpu":
        return DEFAULT_COMPACT_CONFIG
    return _cached_or_swept(
        "compact", compact_key(bucket, backend, batch), DEFAULT_COMPACT_CONFIG, _parse_compact,
        lambda: sweep_compact(bucket, device, batch=batch_bucket(batch)), _block_name,
        extra={"revision": _compact.REVISION})


# ---------------------------------------------------------------------------
# intensity-family (firstorder / glcm) blocks
# ---------------------------------------------------------------------------

# blocks, default, the blocks the kernel takes, and the kernel's revision
_FAMILIES = {
    "firstorder": (DEFAULT_FIRSTORDER_BLOCKS, DEFAULT_FIRSTORDER_CONFIG,
                   lambda b: b > 0 and b % _fo.CANON_CHUNK == 0, _fo.REVISION),
    "glcm": (DEFAULT_GLCM_BLOCKS, DEFAULT_GLCM_CONFIG, _glcm.valid_block, _glcm.REVISION),
}


def _family(family: str):
    try:
        return _FAMILIES[family]
    except KeyError:
        raise ValueError(f"unknown autotune family namespace {family!r}") from None


def _probe_volume(shape) -> np.ndarray:
    """A centred ellipsoid mask at ~0.35 radius: surface and interior."""
    g = np.indices(shape, dtype=np.float32)
    c = (np.asarray(shape, np.float32) - 1.0) / 2.0
    r = np.maximum(np.asarray(shape, np.float32) * 0.35, 2.0)
    d2 = sum(((g[i] - c[i]) / r[i]) ** 2 for i in range(3))
    return (d2 < 1.0).astype(np.float32)


def _family_probe(shape, device, batch: int, seed: int = 0):
    """``(images, masks)``: a ``(batch, *shape)`` stack of the ellipsoid mask
    and a CT-like image."""
    dev = torch.device(device)
    shape = tuple(int(s) for s in shape)
    batch = max(1, int(batch))
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(_probe_volume(shape)).to(dev)
    image = torch.from_numpy(rng.normal(40.0, 15.0, size=shape).astype(np.float32)).to(dev)
    return (image.expand(batch, *shape).contiguous(), mask.expand(batch, *shape).contiguous())


def measure_family_configs(family: str, shape, device, configs, *, batch: int = 4) -> dict:
    """Median device seconds of each :class:`FamilyConfig` of a family on one
    probe, the launch the executor issues (its masked range taken once,
    outside the timing, as the executor takes it for both families)."""
    _family(family)
    images, masks = _family_probe(shape, device, batch)
    op = _fo.firstorder_packed_batch if family == "firstorder" else _glcm.glcm_matrix_batch
    with torch.cuda.device(images.device):
        rng = _range.masked_range_batch(images, masks)
        return _time_launches({c: functools.partial(op, images, masks, block=c.block,
                                                    value_range=rng) for c in configs})


def sweep_family(family: str, shape, device, *, batch: int = 4):
    """Measure every block of a family; returns ``(best, table)`` keyed
    ``str(block)`` in microseconds."""
    blocks = _family(family)[0]
    configs = [FamilyConfig(b) for b in blocks]
    return _table(measure_family_configs(family, shape, device, configs, batch=batch),
                  _block_name)


def get_family_config(family: str, shape, device, *, batch: int = 1) -> FamilyConfig:
    """Cached-or-swept family block per (volume bucket, depth); the
    contract of :func:`get_diameter_config`.  ``shape`` should already be
    a bucket (:func:`mc_shape_bucket`).  A cached block the kernel does
    not take, or a record measured against another kernel revision,
    counts as a miss."""
    _, default, valid, revision = _family(family)
    backend = torch.device(device).type
    if backend == "cpu":
        return default
    shape = tuple(int(s) for s in shape)

    def parse(rec):
        if rec.get("revision") != revision:
            return None
        cfg = FamilyConfig(int(rec["block"]))
        return cfg if valid(cfg.block) else None

    return _cached_or_swept(
        family, family_key(family, shape, backend, batch), default, parse,
        lambda: sweep_family(family, shape, device, batch=batch_bucket(batch)), _block_name,
        extra={"revision": revision})


# ---------------------------------------------------------------------------
# probes: device-to-host sync cost, the card's roofline profile
# ---------------------------------------------------------------------------

# per-fetch d2h latency (us) when probing is off: the reference's modest
# default, so no schedule is chosen on an unmeasured link's account
DEFAULT_SYNC_US = 150.0
SYNC_PROBE_SHAPE = (32, 2)  # the (B, 2) count matrix pass 1 fetches

# Roofline profiles when probing is off.  'cuda': the H100 SXM data sheet
# (dense, 700 W): FP32 outside the tensor cores and HBM3 bandwidth, the
# figures PERF.md's bounds use.  'cpu': one CPU core running torch ops.
H100_SXM_PROFILE = {"peak_flops": 67.0e12, "mem_bw": 3.35e12, "source": "default"}
DEFAULT_HW_PROFILES = {
    "cuda": H100_SXM_PROFILE,
    "cpu": {"peak_flops": 8.0e9, "mem_bw": 20.0e9, "source": "default"},
}
HW_PROBE_MATMUL_N = 512  # float32 matmul edge of the peak-rate probe
# float32 elements of each bandwidth-probe stream (256 MiB): the three
# streams are 15x the H100's 50 MB L2, so no stream is served from it
HW_PROBE_COPY_ELEMS = 1 << 26
HW_PROBE_STREAMS = 3  # the probe's two reads and one write
# revision of the hw/<device> record: a record without it (the eager
# ``u + 0.5 * v`` of two kernels, five streams counted as three) is a miss
HW_PROBE_REVISION = 2


def sync_key(backend: str) -> str:
    return f"sync/{backend}"


def hw_key(backend: str) -> str:
    return f"hw/{backend}"


def _probe_allowed(backend: str) -> bool:
    return backend == "cuda" and _sweep_allowed()


def measure_sync_cost(device, *, repeat: int = 64, warmup: int = 8) -> float:
    """Best-of-``repeat`` host seconds of one small device-to-host fetch.

    The fetch the counted schedule's pass 1 makes (``PlanExecutor._fetch``
    of a device tensor): ``.cpu()`` of a ready ``(32, 2)`` int32 tensor, so
    the latency of a sync and its copy is timed, not device work.
    """
    x = torch.zeros(SYNC_PROBE_SHAPE, dtype=torch.int32, device=device)
    torch.cuda.synchronize(x.device)
    for _ in range(warmup):
        x.cpu()
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        x.cpu()
        best = min(best, time.perf_counter() - t0)
    return best


def _best_device_s(fn, repeat: int, warmup: int) -> float:
    """Least device seconds of one call of ``fn`` over ``repeat`` samples,
    each a pair of CUDA events recorded behind a spin kernel, so the host's
    enqueue is not timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3)
    return best


def bandwidth_probe_op(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The bandwidth probe's expression, ``u + 0.5 v``, as one kernel that
    reads ``u`` and ``v`` once and writes its result once
    (:data:`HW_PROBE_STREAMS`).  The eager ``u + 0.5 * v`` is two kernels
    whose temporary adds a write and a read."""
    return torch.add(u, v, alpha=0.5)


def measure_hw_profile(device, *, repeat: int = 8, warmup: int = 2) -> dict:
    """Measured ``{"peak_flops", "mem_bw"}`` of the card.

    Peak rate: an (N, N) float32 ``torch.matmul`` (2 N^3 operations) with
    TF32 off, as the pruning bound runs it (a TF32 rate would be ~8x the
    FP32 one).  Bandwidth: :func:`bandwidth_probe_op` over two 256 MiB
    float32 streams (two reads and a write, past the L2).  Library calls,
    timed by device time; the probe costs milliseconds once per card.
    """
    dev = torch.device(device)
    with torch.cuda.device(dev):
        n = HW_PROBE_MATMUL_N
        a = torch.full((n, n), 0.5, dtype=torch.float32, device=dev)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            mm_s = _best_device_s(lambda: torch.matmul(a, a), repeat, warmup)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        m = HW_PROBE_COPY_ELEMS
        u = torch.ones(m, dtype=torch.float32, device=dev)
        v = torch.full((m,), 2.0, dtype=torch.float32, device=dev)
        bw_s = _best_device_s(lambda: bandwidth_probe_op(u, v), repeat, warmup)
        del u, v
    return {"peak_flops": 2.0 * n ** 3 / mm_s, "mem_bw": HW_PROBE_STREAMS * 4.0 * m / bw_s,
            "revision": HW_PROBE_REVISION}


def _probed(kind: str, cache: AutotuneCache, key: str, measure):
    """Runs ``measure()``, counts it and stores it in ``cache`` under
    ``key``; returns the record."""
    global PROBES
    PROBES += 1
    t0 = time.perf_counter()
    rec = measure()
    PROBE_SECONDS[kind] += time.perf_counter() - t0
    cache.put(key, {**rec, "probed_at": time.strftime("%Y-%m-%dT%H:%M:%S")})
    return rec


def get_sync_cost(device, *, cache: AutotuneCache | None = None) -> float:
    """Cached-or-probed per-fetch device-to-host latency in MICROSECONDS.

    A positive ``us`` in the ``sync/<device>`` record wins (on every
    device, the CPU included: an operator may pin it); a miss probes on
    ``'cuda'`` (:func:`measure_sync_cost`) unless ``REPRO_AUTOTUNE=0`` and
    stores the result; otherwise :data:`DEFAULT_SYNC_US`, uncached.
    """
    backend = torch.device(device).type
    cache = cache or AutotuneCache()
    hit = cache.get(sync_key(backend))
    if hit is not None:
        try:
            us = float(hit["us"])
        except (KeyError, TypeError, ValueError):
            us = 0.0
        if us > 0:
            return us
    if not _probe_allowed(backend):
        return DEFAULT_SYNC_US
    rec = _probed("sync", cache, sync_key(backend),
                  lambda: {"us": measure_sync_cost(device) * 1e6})
    return rec["us"]


def get_hw_profile(device, *, cache: AutotuneCache | None = None) -> dict | None:
    """Cached-or-probed roofline profile ``{"peak_flops", "mem_bw",
    "source"}`` of ``device``, or ``None`` under ``REPRO_ROOFLINE=0``.

    A ``hw/<device>`` record with both figures positive and the probe's
    :data:`HW_PROBE_REVISION` wins (``source`` 'measured'); a miss probes on ``'cuda'`` (:func:`measure_hw_profile`)
    unless ``REPRO_AUTOTUNE=0`` and stores the result; otherwise the
    :data:`DEFAULT_HW_PROFILES` entry, uncached.
    """
    if os.environ.get("REPRO_ROOFLINE") == "0":
        return None
    backend = torch.device(device).type
    cache = cache or AutotuneCache()
    hit = cache.get(hw_key(backend))
    if hit is not None and hit.get("revision") == HW_PROBE_REVISION:
        try:
            peak, bw = float(hit["peak_flops"]), float(hit["mem_bw"])
        except (KeyError, TypeError, ValueError):
            peak = bw = 0.0
        if peak > 0 and bw > 0:
            return {"peak_flops": peak, "mem_bw": bw, "source": "measured"}
    if not _probe_allowed(backend):
        prof = DEFAULT_HW_PROFILES.get(backend)
        return None if prof is None else dict(prof)
    rec = _probed("hw", cache, hw_key(backend), lambda: measure_hw_profile(device))
    return {"peak_flops": rec["peak_flops"], "mem_bw": rec["mem_bw"], "source": "measured"}
