"""The port's sync-free window path on the CPU against the JAX package's.

``schedule='static'`` (pass 1 fetches nothing; the counts are fetched at
collect, with the keep-originals re-sweep), ``prep='hint'`` (pass 0 sizes
caps from ``plan.vertex_hint`` and fetches nothing; the counts are fetched
at collect, with the overflow retry) and the fixed-window
``extract_stream`` (window k+1 submitted before window k is drained, tiled
cases between in-core segments).  Mirrors the reference's
``tests/test_plan_executor_stream.py``, ``tests/test_costmodel_schedule.py``
(hint prep) and ``tests/test_tiled_pipeline.py`` (the stream's tiled
segments).

Tolerances: within the port, rows are bitwise equal across schedules,
preps, windows and ``extract_one``; against JAX ``backend='ref'`` on the
same cases, float features at rtol 1e-4, the vertex count, the pruning
stats and the host-fetch census stage by stage exactly.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as jax_plan  # noqa: E402
from repro.core.pipeline import BatchedExtractor as JaxBatchedExtractor  # noqa: E402
from repro_torch.core import executor as exmod  # noqa: E402
from repro_torch.core import plan as planlib  # noqa: E402
from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.tiles import TiledCase  # noqa: E402
from repro_torch.kernels import ops, prune  # noqa: E402

COMBOS = [(s, p) for s in ("counted", "static") for p in ("count", "hint")]
STAT_KEYS = ["pruned_cases", "vertex_buckets", "buckets", "empty_cases", "mean_keep_fraction",
             "plan", "host_fetches", "prune_info", "vertex_cap"]


@pytest.fixture(autouse=True)
def _isolated_autotune(tmp_path, monkeypatch):
    # parity must not depend on (or pollute) an autotune cache
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These cases' tensors are small: one intra-op thread runs them about
    as fast alone, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(shape, seed):
    return synthetic.make_case(shape, seed=seed)


def _empty():
    z = np.zeros((10, 10, 10), np.float32)
    return z, z.copy(), (1.0, 1.0, 1.0)


def _voxel():
    m = np.zeros((9, 9, 9), np.float32)
    m[4, 4, 4] = 1.0
    return np.zeros_like(m), m, (1.0, 1.0, 1.0)


def _plane():
    m = np.zeros((24, 20, 9), np.float32)
    m[3:19, 4:15, 4] = 1.0
    return np.random.default_rng(3).normal(size=m.shape).astype(np.float32), m, (1.0, 1.0, 2.5)


def _edge_cases():
    return [
        _case((48, 48, 48), 1),  # prunes to a smaller bucket
        _empty(),  # empty mask mid-stream: a zero row
        _case((20, 18, 16), 5),  # small: the floor-cap group
        _voxel(),
        _case((70, 20, 20), 4),  # another shape bucket
        _case((48, 48, 48), 2),  # the buckets of case 0, in a later window
    ]


def _stack(rows):
    return np.stack([np.asarray(r, np.float32) for r in rows])


def _window_run(ext):
    """One window of the edge cases through the window API: the rows, and
    the window stats with the fetch census and each case's ``PruneInfo``
    and pass-2b cap."""
    ex = ext.executor
    window = ex.submit_window(_edge_cases())
    rows, stats = ex.collect_window(window)
    stats["host_fetches"] = dict(ex.transfer_log)
    stats["prune_info"] = [None if p.prune_info is None else
                           (p.prune_info.m_total, p.prune_info.m_valid, p.prune_info.m_kept,
                            p.prune_info.pruned) for p in window.prepped]
    stats["vertex_cap"] = [p.vertex_cap for p in window.prepped]
    return _stack(rows), stats


@functools.lru_cache(maxsize=None)
def _port_run(schedule, prep):
    return _window_run(BatchedExtractor(device="cpu", schedule=schedule, prep=prep))


@functools.lru_cache(maxsize=None)
def _jax_run(schedule, prep):
    return _window_run(JaxBatchedExtractor(backend="ref", schedule=schedule, prep=prep))


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("schedule,prep", COMBOS)
def test_rows_stats_and_fetches_match_jax(schedule, prep):
    ours, ostats = _port_run(schedule, prep)
    theirs, tstats = _jax_run(schedule, prep)
    np.testing.assert_allclose(ours[:, :6], theirs[:, :6], rtol=1e-4)
    np.testing.assert_array_equal(ours[:, 6], theirs[:, 6])  # vertex counts
    for key in STAT_KEYS:
        assert ostats[key] == tstats[key], key


def test_sync_free_window_fetches_nothing_before_collect():
    """hint + static: no prep and no pass-1 fetch; the deferred counts are
    one fetch per static-chain group and one per non-empty case."""
    _, stats = _port_run("static", "hint")
    fetches = stats["host_fetches"]
    assert "prep" not in fetches and "pass1" not in fetches
    ex = BatchedExtractor(device="cpu", schedule="static", prep="hint").executor
    metas = [ex.case_meta(ex.prep_case(c)) for c in _edge_cases()]
    plan = planlib.build_plan(metas, "static")
    assert len(plan.cap_groups) == stats["plan"]["cap_buckets"]
    chains = sum(1 for target in plan.static_targets.values() if target is not None)
    assert fetches["pass2b_counts"] == chains > 0
    assert fetches["collect_counts"] == len(_edge_cases()) - 1  # one empty case
    _, counted = _port_run("counted", "count")
    assert counted["host_fetches"]["prep"] == len(_edge_cases()) - 1
    assert counted["host_fetches"]["pass1"] == counted["plan"]["cap_buckets"]


# -- bitwise within the port ---------------------------------------------------

@pytest.mark.parametrize("schedule,prep", COMBOS)
def test_rows_bitwise_across_schedules_preps_windows(schedule, prep):
    want, _ = _port_run("counted", "count")
    rows, _ = _port_run(schedule, prep)
    np.testing.assert_array_equal(rows, want)
    ext = BatchedExtractor(device="cpu", schedule=schedule, prep=prep)
    rows, stats = ext.run(_edge_cases())
    np.testing.assert_array_equal(_stack(rows), want)
    assert (stats["schedule"], stats["prep"]) == (schedule, prep)
    n = len(_edge_cases())
    for window in (1, 2, 3, n, n + 1):
        got = _stack(ext.extract_stream(iter(_edge_cases()), window=window))
        np.testing.assert_array_equal(got, want, err_msg=f"window {window}")


def test_extract_one_is_the_oracle_of_every_schedule():
    want, _ = _port_run("counted", "count")
    ext = BatchedExtractor(device="cpu", schedule="static", prep="hint")
    for i, case in enumerate(_edge_cases()):
        np.testing.assert_array_equal(ext.extract_one(*case), want[i], err_msg=f"case {i}")
    assert ext.executor.transfer_log.get("collect_counts", 0) == 0  # always count-sized


def test_static_pass1_makes_no_host_fetch(monkeypatch):
    """Pass 1 of the static schedule alone, with every fetch and every
    tensor-to-host read intercepted: none happens.  The counted schedule's
    pass 1, under the same guard, is seen fetching."""
    seen = []

    def guard(name, real):
        def wrapped(self, *a, **k):
            seen.append(name)
            return real(self, *a, **k)
        return wrapped

    cases = [_case((48, 48, 48), 1), _case((20, 18, 16), 5), _case((70, 20, 20), 4)]
    for schedule in ("static", "counted"):
        ex = BatchedExtractor(device="cpu", schedule=schedule).executor
        prepped = [ex.prep_case(c) for c in cases]
        plan = planlib.build_plan([ex.case_meta(p) for p in prepped], schedule)
        fetches0 = dict(ex.transfer_log)
        seen.clear()
        with monkeypatch.context() as mp:
            for name in ("numpy", "item", "tolist", "__int__", "__float__", "__index__"):
                mp.setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
            if schedule == "static":
                entries, aux = ex._pass1_static(plan, prepped)
            else:
                ex._pass1_counted(plan, prepped)
        if schedule == "static":
            assert seen == [] and dict(ex.transfer_log) == fetches0
            assert entries and aux  # the chain ran, its counts on the side
        else:
            assert seen and ex.transfer_log["pass1"] == len(plan.cap_groups)


def _sphere_prepped(cap, n, seed=0):
    """Pass-0 state whose vertices all lie on a sphere (antipodal pairs):
    the bound keeps every vertex, so a cap above the floor is a
    keep-originals case, the static schedule's re-sweep."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n // 2, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = np.concatenate([u, -u]) * 37.0
    verts = np.zeros((cap, 3), np.float32)
    verts[: len(pts)] = pts
    vmask = np.zeros((cap,), bool)
    vmask[: len(pts)] = True
    return exmod._Prepped(mask=torch.zeros((32, 32, 32)), spacing=np.ones(3, np.float32),
                          shape=(32, 32, 32), roi_shape=(8, 8, 8), verts=torch.from_numpy(verts),
                          vmask=torch.from_numpy(vmask), n_vertices=len(pts), vertex_cap=cap)


def test_static_keep_originals_resweep_equals_counted():
    rows = {}
    for schedule in ("static", "counted"):
        ex = BatchedExtractor(device="cpu", schedule=schedule).executor
        prepped = [_sphere_prepped(1024, 600), _sphere_prepped(1024, 700, 1)]
        window = ex.submit_prepped(prepped)
        if schedule == "static":
            assert window.static_aux, "the sphere clouds must take the static chain"
        rows[schedule], _ = ex.collect_window(window)
        for p in prepped:
            assert not p.prune_info.pruned and p.vertex_cap == 1024
        if schedule == "static":
            assert ex.transfer_log["pass2b_retry"] >= 1  # the re-sweep ran
            assert ex.transfer_log.get("pass1", 0) == 0
            infos = [p.prune_info for p in prepped]
        else:
            assert [p.prune_info for p in prepped] == infos
    np.testing.assert_array_equal(_stack(rows["static"]), _stack(rows["counted"]))


# -- hint prep: the overflow retry, tiny masks, short lists --------------------

@pytest.mark.parametrize("schedule", ["counted", "static"])
def test_hint_overflow_retries_count_sized(monkeypatch, schedule):
    """Every hint collapses to the bucket floor, far below the 48^3 blob's
    count: the collector sees the overflow and re-runs the case
    count-sized, giving the count-prep rows bitwise; the fetch census is
    the JAX package's under the same hint."""
    cases = [_case((48, 48, 48), 1), _case((20, 18, 16), 5)]
    want, _ = BatchedExtractor(device="cpu", schedule=schedule).run(cases)
    monkeypatch.setattr(planlib, "vertex_hint", lambda *a, **k: 1)
    monkeypatch.setattr(jax_plan, "vertex_hint", lambda *a, **k: 1)
    ext = BatchedExtractor(device="cpu", schedule=schedule, prep="hint")
    rows, stats = ext.run(cases)
    np.testing.assert_array_equal(_stack(rows), _stack(want))
    assert stats["host_fetches"].get("prep", 0) == 0
    assert stats["host_fetches"]["hint_retry"] >= 1
    if schedule == "static":
        assert stats["host_fetches"].get("pass1", 0) == 0
    _, jstats = JaxBatchedExtractor(backend="ref", schedule=schedule, prep="hint").run(cases)
    assert stats["host_fetches"] == jstats["host_fetches"]
    assert stats["pruned_cases"] == jstats["pruned_cases"]


def test_hint_prep_tiny_masks_equal_count_and_jax():
    cases = [_voxel(), _plane(), _case((20, 18, 16), 5)]
    fams = ("shape", "firstorder")
    want, _ = BatchedExtractor(device="cpu", families=fams).run(cases)
    ext = BatchedExtractor(device="cpu", families=fams, schedule="static", prep="hint")
    rows, stats = ext.run(cases)
    np.testing.assert_array_equal(_stack(rows), _stack(want))
    for case, row in zip(cases, rows):
        np.testing.assert_array_equal(ext.extract_one(*case), row)
    jrows, jstats = JaxBatchedExtractor(backend="ref", families=fams, schedule="static",
                                        prep="hint").run(cases)
    jrows = _stack(jrows)
    np.testing.assert_array_equal(_stack(rows)[:, 6], jrows[:, 6])
    np.testing.assert_allclose(_stack(rows), jrows, rtol=1e-4, atol=1e-6)
    assert stats["host_fetches"] == jstats["host_fetches"]


def test_hint_cap_past_the_field_slots_pads():
    """A hint cap larger than the vertex field's slot count (a tiny volume's
    field under a cap from the bucket floor) pads the list with invalid
    zero rows, which change no diameter and no keep decision."""
    vol = torch.zeros((4, 4, 4))
    vol[1:3, 1:3, 1:3] = 1.0
    fields = ops.vertex_fields(vol, 0.5, (1.0, 1.0, 1.25))
    short, short_mask, n = ops.compact_vertices(fields, 512)
    assert short.shape[0] == 144 < 512  # 3 x 3 x 4 x 4 edge slots
    verts, vmask = exmod._compact_at(fields, 512)
    assert verts.shape == (512, 3) and vmask.shape == (512,)
    torch.testing.assert_close(verts[:144], short, rtol=0, atol=0)
    assert torch.equal(vmask[:144], short_mask) and not vmask[144:].any()
    assert int(vmask.sum()) == int(n) == 24
    assert torch.equal(ops.max_diameters(verts, vmask, device="cpu"),
                      ops.max_diameters(short, short_mask, device="cpu"))
    keep, _ = prune.keep_mask_batch(verts[None], vmask[None], 16)
    keep_short, _ = prune.keep_mask_batch(short[None], short_mask[None], 16)
    assert torch.equal(keep[0, :144], keep_short[0]) and not keep[0, 144:].any()


# -- the stream ------------------------------------------------------------------

def test_stream_window_edges_and_refusals():
    cases = _edge_cases()[:3]
    ext = BatchedExtractor(device="cpu", schedule="static", prep="hint")
    want, _ = ext.run(cases)
    for window in (1, 2, 3, 16):
        np.testing.assert_array_equal(_stack(ext.extract_stream(iter(cases), window=window)),
                                      _stack(want))
    assert list(ext.extract_stream(iter([]), window=4)) == []
    for bad in (0, -1, 2.0, True, "8"):
        with pytest.raises(ValueError, match="window"):
            ext.extract_stream(iter(cases), window=bad)  # eagerly, before a case is read
        with pytest.raises(ValueError, match="window"):
            ext.executor.extract_stream(iter(cases), window=bad)
    # the cost model's windows (ported since): the same rows
    np.testing.assert_array_equal(_stack(ext.extract_stream(iter(cases), window="auto")),
                                  _stack(want))


def test_stream_stats_callback_reports_plan_census():
    seen = []
    ext = BatchedExtractor(device="cpu", schedule="static", prep="hint")
    rows = list(ext.extract_stream(iter(_edge_cases()), window=4,
                                   stats_callback=lambda i, s: seen.append((i, s))))
    assert len(rows) == len(_edge_cases())
    assert [i for i, _ in seen] == [0, 1]  # 6 cases in windows of 4
    for _, s in seen:
        assert {"shape_buckets", "cap_buckets", "mask_pad_waste", "vertex_pad_waste",
                "cases", "schedule"} <= set(s)
    assert seen[0][1]["cases"] == 4 and seen[1][1]["cases"] == 2
    assert seen[0][1]["empty_cases"] == 1 and seen[0][1]["schedule"] == "static"


def test_submit_stages_every_result_and_fetches_nothing():
    """A hint + static submit queues each result's host copy and makes no
    fetch; the collect fetches each staged result once, under the
    reference's stages."""
    ex = BatchedExtractor(device="cpu", schedule="static", prep="hint",
                          families=("shape", "glcm")).executor
    window = ex.submit_window(_edge_cases())
    assert sum(ex.transfer_log.values()) == 0
    futs = (window.mc_futs + window.diam_futs + window.family_futs["glcm"]
            + [(None, aux[2]) for aux in window.static_aux]
            + window.hint_counts)
    assert futs and all(isinstance(f, exmod._Staged) for _, f in futs)
    ex.collect_window(window)
    assert sum(ex.transfer_log.values()) == len(futs)


def test_stream_handles_tiled_cases_between_segments():
    """A TiledCase splits the stream: the segment before it is flushed
    through the windowed stream, the tiled case runs out-of-core, then the
    stream resumes; every row == extract_one bitwise (the reference's
    tests/test_tiled_pipeline.py:290)."""
    sp = (1.0, 1.25, 0.75)
    small_img, small = _ellipsoid((26, 28, 44), (8, 9, 15))
    big_img, big = _ellipsoid((36, 40, 120), (12, 14, 50), seed=1)
    ext = BatchedExtractor(device="cpu", families=("shape", "firstorder"), schedule="static",
                           prep="hint")
    cases = [(small_img, small, sp), _case((20, 18, 16), 5),
             TiledCase(big, image=big_img, spacing=sp), (small_img, small, sp)]
    oracle = [ext.extract_one(*cases[0]), ext.extract_one(*cases[1]),
              ext.extract_one(big_img, big, sp), ext.extract_one(*cases[0])]
    seen = []
    rows = list(ext.extract_stream(iter(cases), window=1,
                                   stats_callback=lambda i, s: seen.append(i)))
    assert len(rows) == 4 and seen == [0, 1, 0]  # two in-core segments
    for a, b in zip(oracle, rows):
        np.testing.assert_array_equal(a, b)


def _ellipsoid(shape, radii, seed=0):
    xs, ys, zs = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
    r2 = sum(((g - n / 2) / r) ** 2 for g, n, r in zip((xs, ys, zs), shape, radii))
    image = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return image, (r2 < 1.0).astype(np.float32)


# -- refusals --------------------------------------------------------------------

def test_sync_free_options_require_the_device_resident_path():
    for opt in ({"schedule": "static"}, {"prep": "hint"}):
        with pytest.raises(ValueError, match="device-resident"):
            BatchedExtractor(device="cpu", prune=False, **opt)
        with pytest.raises(ValueError, match="device-resident"):
            BatchedExtractor(device="cpu", device_compact=False, **opt)
    with pytest.raises(ValueError, match="schedule"):
        BatchedExtractor(device="cpu", schedule="eager")
    with pytest.raises(ValueError, match="prep"):
        BatchedExtractor(device="cpu", prep="guess")
    for opt in ({"prune": False}, {"device_compact": False}):  # 'auto' may resolve to static
        with pytest.raises(ValueError, match="schedule='auto'.*device-resident"):
            BatchedExtractor(device="cpu", schedule="auto", **opt)
