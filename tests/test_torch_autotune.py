"""The port's autotuner (``repro_torch.runtime.autotune``), on the CPU.

The port's counterparts of ``tests/test_autotune_cache.py``'s cache,
migration, malformed-file, future-schema and ``batch_bucket`` tests, run
on the port's module with its ``cuda`` keys; a v3 file written by either
package reads back the same entries in the other.  The sweep policy runs
without a card: the measuring functions are replaced by deterministic
tables, so a cold lookup on ``'cuda'`` sweeps, stores the argmin and a
second lookup measures nothing.  The real sweep's round trip on the card is
``tests/test_torch_variants_cuda.py``.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.runtime import autotune as jax_autotune  # noqa: E402
from repro_torch.core import ShapeFeatureExtractor, dispatcher  # noqa: E402
from repro_torch.core.executor import PlanExecutor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import compact, diameter, firstorder, glcm  # noqa: E402
from repro_torch.runtime import autotune, costmodel  # noqa: E402


@pytest.fixture
def cache_path(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    return path


def _fake_times(variant, block):
    """A deterministic (variant, block) -> seconds table: 'nomask' at 256
    wins, 'gram' would beat everything if it were measured."""
    base = {"seqacc": 3.0, "tri_prefetch": 3.2, "nomask": 2.5, "gram": 0.1}.get(variant, 9.0)
    return (base + abs(block - 256) / 256) * 1e-3


@pytest.fixture
def measured(monkeypatch):
    """Replaces the diameter measurement; records every measured config."""
    calls = []

    def measure(bucket, device, configs, *, batch, extent=None):
        calls.extend((bucket, c.variant, c.block, batch) for c in configs)
        return {c: _fake_times(c.variant, c.block) for c in configs}

    monkeypatch.setattr(autotune, "measure_diameter_configs", measure)
    return calls


def _v1_payload():
    return {"diameter/cuda/M256": {"variant": "tri_prefetch", "block": 128, "us": 11.0,
                                   "table": {"tri_prefetch/128": 11.0},
                                   "revision": diameter.REVISION}}


def _v2_payload():
    return {
        "schema": 2,
        "entries": {
            "diameter/cuda/M256": {"variant": "nomask", "block": 128, "us": 11.0, "table": {},
                                   "revision": diameter.REVISION},
            "compact/cuda/M1024": {"block": 2048, "us": 9.0, "table": {},
                                   "revision": compact.REVISION},
            "bogus-non-dict": 17,
        },
    }


# -- the cache file ----------------------------------------------------------

def test_defaults_are_the_kernels():
    assert autotune.DEFAULT_CONFIG == autotune.DiameterConfig("seqacc", diameter.DEFAULT_BLOCK)
    assert autotune.DEFAULT_COMPACT_CONFIG.block == compact.DEFAULT_BLOCK
    assert autotune.DEFAULT_FIRSTORDER_CONFIG.block == firstorder.DEFAULT_BLOCK
    assert autotune.DEFAULT_GLCM_CONFIG.block == glcm.DEFAULT_BLOCK
    assert "gram" not in autotune.DEFAULT_VARIANTS
    assert set(autotune.DEFAULT_VARIANTS) <= set(diameter.VARIANTS)
    assert all(b % firstorder.CANON_CHUNK == 0 for b in autotune.DEFAULT_FIRSTORDER_BLOCKS)
    assert all(glcm.valid_block(b) for b in autotune.DEFAULT_GLCM_BLOCKS)
    assert all(compact.valid_block(b) for b in autotune.DEFAULT_COMPACT_BLOCKS)


def test_sweep_candidates_hold_tri_prefetch_not_gram(cache_path, measured):
    """The reference's candidates (its autotune.DEFAULT_VARIANTS) less gram:
    a cold sweep times seqacc, tri_prefetch and nomask at every block."""
    assert set(autotune.DEFAULT_VARIANTS) == set(jax_autotune.DEFAULT_VARIANTS) - {"gram"}
    autotune.get_diameter_config(2048, "cuda", batch=2)
    assert {v for _, v, _, _ in measured} == {"seqacc", "tri_prefetch", "nomask"}
    assert len(measured) == 3 * len(autotune.DEFAULT_BLOCKS)


def test_cache_path_default_and_env(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    assert autotune.cache_path() == jax_autotune.cache_path()
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "x.json"))
    assert autotune.cache_path() == str(tmp_path / "x.json")


def test_v3_schema_roundtrip_mixed_entries(cache_path):
    cache = autotune.AutotuneCache()
    cache.put(autotune.sweep_key(512, "cuda"), {"variant": "seqacc", "block": 256, "us": 1.0})
    cache.put(autotune.compact_key(4096, "cuda", batch=3), {"block": 512, "us": 2.0})
    cache.put(autotune.family_key("glcm", (32, 64, 32), "cuda", batch=2),
              {"block": 1024, "us": 3.0})
    raw = json.load(open(cache_path))
    assert raw["schema"] == autotune.SCHEMA_VERSION == 3
    assert set(raw["entries"]) == {"diameter/cuda/M512/B1", "compact/cuda/M4096/B4",
                                   "glcm/cuda/S32x64x32/B2"}
    assert cache.get("diameter/cuda/M512/B1")["variant"] == "seqacc"
    assert cache.get("glcm/cuda/S32x64x32/B2")["block"] == 1024


def test_batch_bucket_is_a_pow2_ladder():
    assert [autotune.batch_bucket(b) for b in (1, 2, 3, 4, 5, 8, 9, 33)] == \
        [1, 2, 4, 4, 8, 8, 16, 64]
    assert autotune.sweep_key(256, "cuda", batch=6) == "diameter/cuda/M256/B8"
    assert autotune.compact_key(1024, "cuda", batch=3) == "compact/cuda/M1024/B4"
    assert autotune.family_key("firstorder", (64, 32, 32), "cuda", batch=5) == \
        "firstorder/cuda/S64x32x32/B8"
    for shape in [(1, 1, 1), (33, 64, 65), (100, 20, 7)]:
        assert autotune.mc_shape_bucket(shape) == jax_autotune.mc_shape_bucket(shape)


def test_v1_file_migrates_on_load(cache_path, monkeypatch):
    with open(cache_path, "w") as f:
        json.dump(_v1_payload(), f)
    monkeypatch.setattr(autotune, "sweep_diameter",
                        lambda *a, **k: pytest.fail("migrated v1 entry ignored: re-swept"))
    assert autotune.get_diameter_config(256, "cuda") == \
        autotune.DiameterConfig("tri_prefetch", 128)


def test_v1_file_upgraded_and_preserved_on_put(cache_path):
    with open(cache_path, "w") as f:
        json.dump(_v1_payload(), f)
    autotune.AutotuneCache().put(autotune.compact_key(1024, "cuda"), {"block": 256})
    raw = json.load(open(cache_path))
    assert raw["schema"] == autotune.SCHEMA_VERSION
    assert raw["entries"]["diameter/cuda/M256/B1"]["variant"] == "tri_prefetch"
    assert raw["entries"]["compact/cuda/M1024/B1"]["block"] == 256


def test_v2_file_migrates_on_load(cache_path, monkeypatch, measured):
    with open(cache_path, "w") as f:
        json.dump(_v2_payload(), f)
    sweep = autotune.sweep_diameter
    for name in ("sweep_diameter", "sweep_compact"):
        monkeypatch.setattr(autotune, name,
                            lambda *a, **k: pytest.fail("migrated v2 entry ignored: re-swept"))
    assert autotune.get_diameter_config(256, "cuda") == autotune.DiameterConfig("nomask", 128)
    assert autotune.get_compact_config(1024, "cuda") == autotune.CompactConfig(2048)
    # an unmeasured depth is a miss: the B4 slot sweeps
    monkeypatch.setattr(autotune, "sweep_diameter", sweep)
    autotune.get_diameter_config(256, "cuda", batch=4)
    assert measured and {batch for *_, batch in measured} == {4}


def test_v2_file_upgraded_and_preserved_on_put(cache_path):
    with open(cache_path, "w") as f:
        json.dump(_v2_payload(), f)
    autotune.AutotuneCache().put(autotune.sweep_key(256, "cuda", batch=4),
                                 {"variant": "seqacc", "block": 128})
    raw = json.load(open(cache_path))
    assert raw["schema"] == autotune.SCHEMA_VERSION
    assert set(raw["entries"]) == {"diameter/cuda/M256/B1", "compact/cuda/M1024/B1",
                                   "diameter/cuda/M256/B4"}


def test_unknown_future_schema_resweeps_without_destroying_file(cache_path, measured):
    future = {"schema": 99, "entries": _v1_payload()}
    with open(cache_path, "w") as f:
        json.dump(future, f)
    cfg = autotune.get_diameter_config(256, "cuda")
    assert cfg == autotune.DiameterConfig("nomask", 256)
    assert json.load(open(cache_path)) == future  # untouched
    n = len(measured)
    autotune.get_diameter_config(256, "cuda")  # still no cached winner: sweeps again
    assert len(measured) == 2 * n


def test_malformed_file_reads_empty_and_recovers(cache_path):
    with open(cache_path, "w") as f:
        f.write("{ not json !!")
    cache = autotune.AutotuneCache()
    assert cache.get("diameter/cuda/M256/B1") is None
    cache.put("k", {"v": 1})
    assert cache.get("k") == {"v": 1}


def test_v3_file_reads_back_in_either_package(cache_path):
    autotune.AutotuneCache().put(autotune.sweep_key(1024, "cuda", batch=2),
                                 {"variant": "tri_prefetch", "block": 512, "us": 5.0})
    jax_cache = jax_autotune.AutotuneCache()
    assert jax_cache.get("diameter/cuda/M1024/B2")["variant"] == "tri_prefetch"
    jax_cache.put(jax_autotune.sweep_key(1024, "pallas", batch=2),
                  {"variant": "gram", "block": 128, "us": 4.0})
    jax_cache.put(jax_autotune.compact_key(2048, "pallas"), {"block": 256, "us": 1.0})
    ours = autotune.AutotuneCache()
    for key in ("diameter/cuda/M1024/B2", "diameter/pallas/M1024/B2",
                "compact/pallas/M2048/B1"):
        assert ours.get(key) == jax_cache.get(key)
    assert json.load(open(cache_path))["schema"] == jax_autotune.SCHEMA_VERSION


# -- the sweep policy --------------------------------------------------------

def test_cold_lookup_caches_the_argmin_once(cache_path, measured):
    sweeps = autotune.SWEEPS
    cfg = autotune.get_diameter_config(4096, "cuda", batch=3)
    assert cfg == autotune.DiameterConfig("nomask", 256)
    assert autotune.SWEEPS == sweeps + 1
    assert {(v, b) for _, v, b, _ in measured} == {
        (v, b) for v in autotune.DEFAULT_VARIANTS for b in autotune.DEFAULT_BLOCKS}
    assert {batch for *_, batch in measured} == {4}  # the depth bucket of 3
    rec = json.load(open(cache_path))["entries"]["diameter/cuda/M4096/B4"]
    assert (rec["variant"], rec["block"]) == ("nomask", 256)
    best = min(rec["table"], key=rec["table"].get)
    assert best == "nomask/256" and rec["us"] == rec["table"][best]
    n = len(measured)
    assert autotune.get_diameter_config(4096, "cuda", batch=4) == cfg  # same depth bucket
    assert len(measured) == n and autotune.SWEEPS == sweeps + 1


def test_small_bucket_sweeps_only_blocks_that_fit(cache_path, measured):
    autotune.get_diameter_config(128, "cuda")
    assert {b for _, _, b, _ in measured} == {b for b in autotune.DEFAULT_BLOCKS if b <= 128}
    measured.clear()
    autotune.get_diameter_config(32, "cuda")  # every candidate larger: the smallest
    assert {b for _, _, b, _ in measured} == {min(autotune.DEFAULT_BLOCKS)}


def test_gram_never_wins_auto(cache_path, measured):
    assert autotune.get_diameter_config(2048, "cuda").variant != "gram"
    assert all(v != "gram" for _, v, _, _ in measured)
    # a cached 'gram' entry is a miss for 'auto': it re-sweeps the direct variants
    autotune.AutotuneCache().put(autotune.sweep_key(8192, "cuda"),
                                 {"variant": "gram", "block": 128})
    n = len(measured)
    assert autotune.get_diameter_config(8192, "cuda").variant == "nomask"
    assert len(measured) > n


@pytest.mark.parametrize("revision", [None, diameter.REVISION - 1, str(diameter.REVISION)])
def test_stale_diameter_record_resweeps(cache_path, measured, revision):
    """A record measured against other diameter kernels (an earlier
    revision, or one written before records carried it) is never read:
    the lookup sweeps again and stores the current revision."""
    rec = {"variant": "tri_prefetch", "block": 512, "us": 1.0,
           "table": {"tri_prefetch/512": 1.0}, "swept_at": "2026-10-01T00:00:00"}
    if revision is not None:
        rec["revision"] = revision
    autotune.AutotuneCache().put(autotune.sweep_key(4096, "cuda", batch=2), rec)
    sweeps = autotune.SWEEPS
    assert autotune.get_diameter_config(4096, "cuda", batch=2) == \
        autotune.DiameterConfig("nomask", 256)
    assert autotune.SWEEPS == sweeps + 1 and measured
    stored = json.load(open(cache_path))["entries"]["diameter/cuda/M4096/B2"]
    assert stored["revision"] == diameter.REVISION and stored["variant"] == "nomask"
    n = len(measured)
    assert autotune.get_diameter_config(4096, "cuda", batch=2).variant == "nomask"
    assert len(measured) == n  # the fresh record is read


def _fill_times(bucket, configs, extent):
    """Lists 3/4 full: 'tri_prefetch' (every upper-triangle tile) wins; as
    empty as a static target's: the extent sweeps win by far."""
    full = extent is None or extent >= autotune.probe_extent(bucket)
    out = {}
    for c in configs:
        if c.variant == "tri_prefetch":
            t = 2.0 if full else 5.0
        else:
            t = (2.5 if full else 0.5) + (0.1 if c.variant == "nomask" else 0.0)
        out[c] = (t + abs(c.block - 128) / 1024) * 1e-3
    return out


def test_static_target_resolves_its_own_key_and_probe(cache_path, monkeypatch):
    """A static schedule's pass-2b launch resolves its configuration under
    ``static_key(target)``, swept on lists valid over
    ``static_probe_extent(target)`` (1/32 of its slots); the same
    bucket as a counted launch resolves ``sweep_key`` on the 3/4 probe."""
    seen = []

    def measure(bucket, device, configs, *, batch, extent=None):
        seen.append((bucket, batch, extent))
        return _fill_times(bucket, configs, extent)

    monkeypatch.setattr(autotune, "measure_diameter_configs", measure)
    assert autotune.static_probe_extent(4096) == 128 == 4096 // autotune.STATIC_PROBE_SHARE
    assert autotune.static_probe_extent(32) == 2
    ex = PlanExecutor(device="cpu", schedule="static", prep="hint")
    ex.device = torch.device("cuda")
    assert ex._resolve_diameter(4096, 3, static=True) == ("seqacc", 128)
    assert ex._resolve_diameter(4096, 3) == ("tri_prefetch", 128)
    assert seen == [(4096, 4, 128), (4096, 4, None)]
    entries = json.load(open(cache_path))["entries"]
    assert set(entries) == {"diameter/cuda/T4096/B4", "diameter/cuda/M4096/B4"}
    assert all(e["revision"] == diameter.REVISION for e in entries.values())
    seen.clear()  # both are hits now
    assert ex._resolve_diameter(4096, 4, static=True) == ("seqacc", 128) and not seen


def test_static_schedule_launches_resolve_the_static_keys(monkeypatch):
    """Which key each pass-2b launch of a static window asks for: the static
    chains at their targets as static targets; a floor-cap group and the
    keep-originals re-sweep at their input caps as ordinary buckets; the
    counted schedule never asks for a static key."""
    from repro_torch.core import plan as planlib

    cases = [synthetic.make_case((48, 48, 48), seed=1), synthetic.make_case((20, 18, 16), 5),
             synthetic.make_case((70, 20, 20), seed=4)]
    for schedule in ("static", "counted"):
        ex = PlanExecutor(device="cpu", schedule=schedule, prep="hint")
        asked, real = [], ex._resolve_diameter

        def spy(cap, depth=1, static=False):
            asked.append((cap, depth, static))
            return real(cap, depth, static=static)

        monkeypatch.setattr(ex, "_resolve_diameter", spy)
        window = ex.submit_window(cases)
        if schedule == "counted":
            assert asked and not any(static for *_, static in asked)
            continue
        targets = {(t, len(window.plan.cap_groups[cap]))
                   for cap, t in window.plan.static_targets.items() if t is not None}
        assert targets and {(c, d) for c, d, static in asked if static} == targets
        floors = {(cap, len(idxs)) for cap, idxs in window.plan.cap_groups.items()
                  if window.plan.static_targets[cap] is None}
        assert {(c, d) for c, d, static in asked if not static} == floors
        assert all(planlib.static_bucket(c) is None for c, _ in floors)


@pytest.mark.parametrize("key", ["M4096", "T4096"])
def test_records_of_the_old_probes_are_swept_again(cache_path, monkeypatch, key):
    """A diameter record from before the static targets' probe (revision 2)
    is re-swept at either kind of key, not misread; the cost model ignores
    it too."""
    assert diameter.REVISION == 3
    seen = []
    monkeypatch.setattr(autotune, "measure_diameter_configs",
                        lambda b, d, configs, *, batch, extent=None:
                        seen.append(extent) or _fill_times(b, configs, extent))
    static = key.startswith("T")
    full = autotune.static_key(4096, "cuda") if static else autotune.sweep_key(4096, "cuda")
    old = {"variant": "tri_prefetch" if static else "seqacc", "block": 512, "us": 1.0,
           "table": {}, "revision": 2}
    autotune.AutotuneCache().put(full, old)
    assert costmodel.CostModel("cuda")._measured_us(full) is None
    cfg = autotune.get_diameter_config(4096, "cuda", static=static)
    assert cfg == autotune.DiameterConfig("seqacc" if static else "tri_prefetch", 128)
    assert seen == [128 if static else None]
    assert autotune.AutotuneCache().get(full)["revision"] == 3


@pytest.mark.parametrize("bad", [
    {"variant": "bogus", "block": 256}, {"variant": "seqacc", "block": 100},
    {"variant": "seqacc", "block": 2048}, {"block": 256}, {"variant": "seqacc"},
    {"variant": "seqacc", "block": "big"},
])
def test_unusable_diameter_entry_resweeps(cache_path, measured, bad):
    autotune.AutotuneCache().put(autotune.sweep_key(512, "cuda"), bad)
    assert autotune.get_diameter_config(512, "cuda") == autotune.DiameterConfig("nomask", 256)
    assert measured


def test_disabled_returns_default_uncached(cache_path, measured, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert autotune.get_diameter_config(512, "cuda") == autotune.DEFAULT_CONFIG
    assert autotune.get_compact_config(512, "cuda") == autotune.DEFAULT_COMPACT_CONFIG
    assert autotune.get_family_config("glcm", (32, 32, 32), "cuda") == \
        autotune.DEFAULT_GLCM_CONFIG
    assert not measured and not os.path.exists(cache_path)


def test_cpu_has_no_axis_and_never_touches_the_cache(cache_path, measured, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")  # sweeps on: still nothing to tune
    sweeps = autotune.SWEEPS
    assert autotune.get_diameter_config(512, "cpu") == autotune.DEFAULT_CONFIG
    assert autotune.get_compact_config(512, "cpu") == autotune.DEFAULT_COMPACT_CONFIG
    assert autotune.get_family_config("firstorder", (32, 32, 32), "cpu") == \
        autotune.DEFAULT_FIRSTORDER_CONFIG
    case = synthetic.make_case((24, 20, 16), seed=1)
    ShapeFeatureExtractor(device="cpu").execute(*case)
    assert dispatcher.diameter_config("cpu", 4096) == ("seqacc", diameter.DEFAULT_BLOCK)
    assert not measured and autotune.SWEEPS == sweeps and not os.path.exists(cache_path)


def test_compact_and_family_sweeps_cache_their_argmin(cache_path, monkeypatch):
    seen = []

    def compact_time(bucket, device, configs, *, batch):
        seen.extend(("compact", c.block, batch) for c in configs)
        return {c: abs(c.block - 2048) + 1.0 for c in configs}

    def family_time(family, shape, device, configs, *, batch):
        seen.extend((family, c.block, batch) for c in configs)
        return {c: abs(c.block - (4096 if family == "firstorder" else 4)) + 1.0 for c in configs}

    monkeypatch.setattr(autotune, "measure_compact_configs", compact_time)
    monkeypatch.setattr(autotune, "measure_family_configs", family_time)
    assert autotune.get_compact_config(8192, "cuda", batch=5).block == 2048
    assert autotune.get_family_config("firstorder", (64, 32, 32), "cuda", batch=2).block == 4096
    assert autotune.get_family_config("glcm", (64, 32, 32), "cuda").block == 4
    entries = json.load(open(cache_path))["entries"]
    assert set(entries) == {"compact/cuda/M8192/B8", "firstorder/cuda/S64x32x32/B2",
                            "glcm/cuda/S64x32x32/B1"}
    assert {b for k, b, _ in seen if k == "compact"} == set(autotune.DEFAULT_COMPACT_BLOCKS)
    n = len(seen)
    autotune.get_compact_config(8192, "cuda", batch=8)
    autotune.get_family_config("glcm", (64, 32, 32), "cuda")
    assert len(seen) == n


def test_family_sweep_drops_blocks_the_kernel_refuses(cache_path, monkeypatch):
    seen = []
    monkeypatch.setattr(autotune, "measure_family_configs",
                        lambda family, shape, device, configs, *, batch:
                        seen.extend(c.block for c in configs) or dict.fromkeys(configs, 1.0))
    with pytest.raises(ValueError, match="unknown autotune family"):
        autotune.get_family_config("shape", (32, 32, 32), "cuda")
    # a cached first-order block off the canonical chunk is a miss
    autotune.AutotuneCache().put(autotune.family_key("firstorder", (32, 32, 32), "cuda"),
                                 {"block": 1536})
    seen.clear()
    assert autotune.get_family_config("firstorder", (32, 32, 32), "cuda").block == 1024
    assert seen == list(autotune.DEFAULT_FIRSTORDER_BLOCKS)


@pytest.mark.parametrize("record", [{"block": 4096}, {"block": 4096, "revision": 0}])
def test_firstorder_record_of_another_revision_is_swept_again(cache_path, monkeypatch, record):
    """A first-order block measured against another kernel (or before
    revisions) is a miss; the sweep's record carries the revision."""
    seen = []
    monkeypatch.setattr(autotune, "measure_family_configs",
                        lambda family, shape, device, configs, *, batch:
                        seen.extend(c.block for c in configs)
                        or {c: 1.0 + (c.block != 1024) for c in configs})
    key = autotune.family_key("firstorder", (32, 32, 32), "cuda")
    autotune.AutotuneCache().put(key, record)
    assert autotune.get_family_config("firstorder", (32, 32, 32), "cuda").block == 1024
    assert seen == list(autotune.DEFAULT_FIRSTORDER_BLOCKS)
    assert autotune.AutotuneCache().get(key)["revision"] == firstorder.REVISION
    seen.clear()
    assert autotune.get_family_config("firstorder", (32, 32, 32), "cuda").block == 1024
    assert not seen  # the new record is a hit


@pytest.mark.parametrize("kind", ["compact", "glcm"])
@pytest.mark.parametrize("revision", [None, 1])
def test_compact_and_glcm_records_of_another_revision_are_swept_again(cache_path, monkeypatch,
                                                                      kind, revision):
    """A compaction or GLCM record measured against the kernels before
    their redesign (revision 1, or no revision) is a miss; the sweep's
    record carries the kernel's revision and is then a hit."""
    seen = []
    fast = {"compact": 2048, "glcm": 8}[kind]
    timed = lambda configs: seen.extend(c.block for c in configs) or \
        {c: 1.0 + (c.block != fast) for c in configs}  # noqa: E731
    monkeypatch.setattr(autotune, "measure_compact_configs",
                        lambda bucket, device, configs, *, batch: timed(configs))
    monkeypatch.setattr(autotune, "measure_family_configs",
                        lambda family, shape, device, configs, *, batch: timed(configs))
    if kind == "compact":
        key, module, blocks = (autotune.compact_key(4096, "cuda"), compact,
                               autotune.DEFAULT_COMPACT_BLOCKS)
        lookup = lambda: autotune.get_compact_config(4096, "cuda")  # noqa: E731
    else:
        key, module, blocks = (autotune.family_key("glcm", (32, 32, 32), "cuda"), glcm,
                               autotune.DEFAULT_GLCM_BLOCKS)
        lookup = lambda: autotune.get_family_config("glcm", (32, 32, 32), "cuda")  # noqa: E731
    assert module.REVISION == 2
    record = {"block": fast}  # the block the sweep picks: only its revision is stale
    if revision is not None:
        record["revision"] = revision
    autotune.AutotuneCache().put(key, record)
    sweeps = autotune.SWEEPS
    assert lookup().block == fast
    assert autotune.SWEEPS == sweeps + 1 and seen == list(blocks)
    assert autotune.AutotuneCache().get(key)["revision"] == module.REVISION
    seen.clear()
    assert lookup().block == fast and not seen  # the new record is a hit


def test_pinned_entries_reach_the_executor(cache_path, monkeypatch):
    """Entries pinned in the cache are what the executor's resolution
    hands its launches on the card (no kernel runs: the resolution only
    reads the device's type)."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")  # a miss must not sweep here
    cache = autotune.AutotuneCache()
    cache.put(autotune.compact_key(4096, "cuda", batch=3),
              {"block": 1024, "revision": compact.REVISION})
    cache.put(autotune.family_key("firstorder", (64, 32, 32), "cuda", batch=2),
              {"block": 4096, "revision": firstorder.REVISION})
    cache.put(autotune.family_key("glcm", (64, 32, 32), "cuda", batch=2),
              {"block": 8, "revision": glcm.REVISION})
    cache.put(autotune.sweep_key(1024, "cuda", batch=5), {"variant": "tri_prefetch",
                                                         "block": 128,
                                                         "revision": diameter.REVISION})
    ex = PlanExecutor(device="cpu")
    ex.device = torch.device("cuda")
    assert ex._resolve_compact(4096, 3) == 1024
    assert ex._resolve_family_block("firstorder", (50, 30, 20), 2) == 4096
    assert ex._resolve_family_block("glcm", (64, 32, 32), 2) == 8
    assert ex._resolve_diameter(1024, 5) == ("tri_prefetch", 128)
    assert ex._resolve_diameter(1024, 1) == ("seqacc", diameter.DEFAULT_BLOCK)  # a miss
    assert ex._resolve_mc((64, 32, 32)) == (ex.mc_block, ex.mc_chunk)  # MC is not tuned
    pinned = PlanExecutor(device="cpu", variant="gram", compact_block=512)
    pinned.device = torch.device("cuda")
    assert pinned._resolve_diameter(1024, 5) == ("gram", diameter.DEFAULT_BLOCK)
    assert pinned._resolve_compact(4096, 3) == 512


def test_explicit_values_pass_through_the_dispatcher(cache_path, measured):
    assert dispatcher.diameter_config("cuda", 4096, "tri", 512) == ("tri", 512)
    assert dispatcher.diameter_config("cuda", 4096, "gram") == ("gram", diameter.DEFAULT_BLOCK)
    assert dispatcher.compact_config("cuda", 4096, 64) == 64
    assert dispatcher.firstorder_config("cuda", (40, 40, 40), 3072) == 3072
    assert dispatcher.glcm_config("cuda", (40, 40, 40), "768") == 768
    assert not measured and not os.path.exists(cache_path)


def test_measuring_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        autotune.measure_diameter_configs(512, "cuda", [autotune.DiameterConfig("seqacc", 256)])


def test_a_rewritten_file_is_read_again(cache_path):
    """The parsed file is reused only while the file is unchanged: another
    process's write is seen by the next lookup."""
    cache = autotune.AutotuneCache()
    rev = {"revision": compact.REVISION}
    cache.put(autotune.compact_key(2048, "cuda"), {"block": 2048, **rev})
    assert autotune.get_compact_config(2048, "cuda").block == 2048
    with open(cache_path, "w") as f:  # another writer, another size
        json.dump({"schema": 3, "entries": {"compact/cuda/M2048/B1": {"block": 1024, **rev},
                                            "compact/cuda/M4096/B1": {"block": 512, **rev}}},
                  f)
    assert autotune.get_compact_config(2048, "cuda").block == 1024
    assert autotune.get_compact_config(4096, "cuda").block == 512


def test_timing_interleaves_candidates_and_keeps_the_median(monkeypatch):
    """The sweep's timer on a fake card: one warm-up call each, then rounds
    in which every candidate runs once in turn; each sample is the device
    time between the events around one launch, and the median is kept."""
    clock = [0.0]  # the fake card's clock, ms
    order = []

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            self.t = clock[0]

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return other.t - self.t

    def launch(name, durations):
        it = iter(durations)

        def call():
            order.append(name)
            clock[0] += next(it)
        return call

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: clock.__setitem__(0, clock[0] + 5))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(autotune, "REPEAT", 5)
    # warm-up, then five samples each: a's median 2 ms, b's 3 ms despite outliers
    times = autotune._time_launches({"a": launch("a", [50, 9, 2, 1, 2, 2]),
                                     "b": launch("b", [50, 3, 3, 0.5, 30, 4])})
    assert order == ["a", "b"] + ["a", "b"] * 5
    assert times == {"a": pytest.approx(2e-3), "b": pytest.approx(3e-3)}
    # a sweep whose rounds would overrun the budget takes MIN_REPEAT rounds
    monkeypatch.setattr(autotune, "SWEEP_BUDGET_S", 0.0)
    order.clear()
    autotune._time_launches({"a": launch("a", [1] * 9)})
    assert order == ["a"] * (1 + autotune.MIN_REPEAT)
