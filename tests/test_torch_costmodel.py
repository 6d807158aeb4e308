"""The port's cost model and auto knobs on the CPU against the JAX package's.

``runtime/costmodel.CostModel`` (break-even depth, window budget,
``should_close``, ``window_cost_us``, ``deadline_at_risk``, the measured
price ladder, ``choose_schedule``), ``runtime/roofline`` (the model half),
the sync and hardware getters of ``runtime/autotune``, and the executor's
``schedule='auto'`` and ``extract_stream(window='auto')``.  Mirrors the
reference's ``tests/test_costmodel_schedule.py`` (the hint-prep half is in
``tests/test_torch_stream.py``).

Tolerances: on the same cache entries (``diameter/ref/...`` for the JAX
package, ``diameter/cpu/...`` for the port) and censuses the measured
lookups and every window decision equal the reference's exactly.  The
port prices a diameter launch by the extent the plan expects in its lists,
not by its cap, so ``choose_schedule`` may differ from the reference's;
each such window is pinned here (ROADMAP.md, Queue 3).  Rows: every auto
knob bitwise equal to its fixed baseline within the port; against JAX
``backend='ref'`` float features at rtol 1e-4, the vertex count exactly.
"""
import functools
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as jax_plan  # noqa: E402
from repro.core.pipeline import BatchedExtractor as JaxBatchedExtractor  # noqa: E402
from repro.runtime import costmodel as jax_costmodel  # noqa: E402
from repro_torch.core import plan as planlib  # noqa: E402
from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import diameter  # noqa: E402
from repro_torch.runtime import autotune, costmodel  # noqa: E402
from repro_torch.runtime import roofline as rooflib  # noqa: E402


@pytest.fixture(autouse=True)
def _isolated_autotune(tmp_path, monkeypatch):
    # decisions must not depend on (or pollute) an autotune cache
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_ROOFLINE", raising=False)


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


def _assert_rows_equal(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"case {i}")


def _put_diameter(cache, ladders, sync_us=None):
    """The same measured records under both packages' keys: ``ladders`` maps
    a cap to ``{depth: launch us}``."""
    for cap, ladder in ladders.items():
        for depth, us in ladder.items():
            rec = {"variant": "seqacc", "block": 128, "us": us, "table": {}}
            cache.put(autotune.sweep_key(cap, "ref", depth), rec)
            cache.put(autotune.sweep_key(cap, "cpu", depth),
                      {**rec, "revision": diameter.REVISION})
    if sync_us is not None:
        for backend in ("ref", "cpu"):
            cache.put(autotune.sync_key(backend), {"us": sync_us})


# ---------------------------------------------------------------------------
# held against the reference: same entries, same censuses, same answers
# ---------------------------------------------------------------------------

_LADDERS = {
    512: {1: 40.0, 2: 60.0, 4: 90.0, 8: 150.0},  # break-even 4 (22.5 <= 1.25 * 18.75)
    1024: {1: 100.0, 2: 120.0, 8: 300.0},  # break-even 8; depth 4 falls back to B2
    2048: {1: 400.0},  # one depth: the default break-even
    4096: {1: 900.0, 2: 700.0, 4: 1300.0},  # break-even 2 (350 <= 1.25 * 325)
}
_A = ((64, 64, 64), (50, 50, 50), 1024, 900, False)
_B = ((96, 32, 32), (70, 22, 22), 1024, 950, False)
_C = ((32, 32, 32), (20, 20, 20), 512, 300, False)
_D = ((64, 64, 64), (60, 60, 60), 2048, 1900, True)
_E = ((128, 96, 64), (100, 90, 60), 4096, 3500, False)
_EMPTY = (None, None, 0, 0, False)
CENSUSES = {
    "homogeneous-new-shape": ([_A] * 4, _B, None),
    "shallow-absorbs": ([_A, _C], _B, None),
    "break-even-2": ([_E] * 2, _C, None),
    "mixed-default": ([_A, _C, _C, _D, _EMPTY], _E, None),
    "empty-only": ([_EMPTY, _EMPTY], _A, None),
    "memory-budget": ([_D] * 3, _D, 4 * 96 ** 3 * 2 * 3),
    "case-budget": ([_C] * 5, _C, None),
}


def _window(metas, mod):
    census = mod.WindowCensus()
    for m in metas:
        census.add(mod.CaseMeta(*m))
    return census


@pytest.mark.parametrize("name", sorted(CENSUSES))
def test_window_decisions_equal_reference(name):
    metas, new, mem = CENSUSES[name]
    _put_diameter(autotune.AutotuneCache(), _LADDERS, sync_us=77.0)
    kw = {"window_max_cases": 5 if name == "case-budget" else None,
          "window_mem_bytes": mem}
    ours = costmodel.CostModel("cpu", **kw)
    theirs = jax_costmodel.CostModel("ref", **kw)
    for cap in sorted(_LADDERS):
        assert ours.break_even_depth(cap) == theirs.break_even_depth(cap)
        for depth in (1, 2, 3, 4, 8, 16, 64):
            assert ours.diameter_case_us(cap, depth) == theirs.diameter_case_us(cap, depth)
    c_ours, c_theirs = _window(metas, planlib), _window(metas, jax_plan)
    m_ours, m_theirs = planlib.CaseMeta(*new), jax_plan.CaseMeta(*new)
    assert ours.window_budget_cases(c_ours) == theirs.window_budget_cases(c_theirs)
    assert ours.should_close(c_ours, m_ours) == theirs.should_close(c_theirs, m_theirs)
    assert ours.should_close(c_ours, planlib.CaseMeta(*_EMPTY)) == theirs.should_close(
        c_theirs, jax_plan.CaseMeta(*_EMPTY))
    cost = ours.window_cost_us(c_ours)
    assert cost == theirs.window_cost_us(c_theirs)
    for slack in (None, -1.0, 0.0, 1e-3, cost, 2 * cost, 2 * cost + 1e-6, 1e12):
        assert ours.deadline_at_risk(c_ours, slack) == theirs.deadline_at_risk(c_theirs, slack)


def test_decision_grid_covers_both_outcomes():
    """The grid above is not vacuous: it closes and keeps windows, and its
    ladders give more than one break-even depth."""
    _put_diameter(autotune.AutotuneCache(), _LADDERS, sync_us=77.0)
    closes = set()
    for name, (metas, new, mem) in CENSUSES.items():
        cm = costmodel.CostModel("cpu", window_mem_bytes=mem,
                                 window_max_cases=5 if name == "case-budget" else None)
        closes.add(cm.should_close(_window(metas, planlib), planlib.CaseMeta(*new)))
    assert closes == {True, False}
    cm = costmodel.CostModel("cpu")
    assert [cm.break_even_depth(c) for c in sorted(_LADDERS)] == [4, 8, 4, 2]


# ---------------------------------------------------------------------------
# the port's own: determinism, the price ladder, extent pricing
# ---------------------------------------------------------------------------

def test_cost_model_deterministic_given_fixed_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "fixed.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    cache = autotune.AutotuneCache()
    cache.put(autotune.sync_key("cpu"), {"us": 777.0})
    for depth, us in ((1, 100.0), (2, 120.0), (4, 160.0), (8, 300.0)):
        cache.put(autotune.sweep_key(1024, "cpu", depth),
                  {"variant": "seqacc", "block": 128, "us": us, "table": {},
                   "revision": diameter.REVISION})
    cache.put(autotune.sweep_key(4096, "cpu", 1),  # another kernel revision: ignored
              {"variant": "seqacc", "block": 128, "us": 5.0, "revision": -1})
    before = open(path).read()

    def snapshot():
        cm = costmodel.CostModel("cpu")
        metas = [planlib.CaseMeta((64,) * 3, (50,) * 3, 1024, 900)] * 3
        return (cm.sync_cost_us(), cm.diameter_case_us(1024, 1), cm.diameter_case_us(1024, 8),
                cm.diameter_case_us(1024, 16), cm.diameter_case_us(2048, 1),
                cm.diameter_case_us(4096, 1), cm.break_even_depth(1024),
                cm.break_even_depth(4096), cm.choose_schedule(metas),
                cm.diameter_extent_us(1024, 2, 300))

    first, second = snapshot(), snapshot()
    assert first == second
    assert first[0] == 777.0
    assert first[1] == 100.0 and first[2] == first[3] == 300.0 / 8
    profile = autotune.DEFAULT_HW_PROFILES["cpu"]
    for i, cap in ((4, 2048), (5, 4096)):  # unmeasured and stale: the roofline step
        assert first[i] == rooflib.roofline_us(
            *rooflib.diameter_cost(cap, 1, autotune.probe_extent(cap)), profile)
    assert first[6] == 4 and first[7] == costmodel.DEFAULT_BREAK_EVEN_DEPTH
    assert first[9] == 120.0 / 2 * (300 / 768) ** 2  # measured, scaled by the pairs
    assert open(path).read() == before  # pure reads


@pytest.mark.parametrize("cap,extent", [(512, None), (2048, None), (2048, 300), (8192, 2000)])
def test_roofline_step_is_the_hand_computation(cap, extent):
    cm = costmodel.CostModel("cpu")
    profile = autotune.DEFAULT_HW_PROFILES["cpu"]
    e = autotune.probe_extent(cap) if extent is None else extent
    flops = diameter.flop_estimate(cap, diameter.DEFAULT_BLOCK, "seqacc", extent=e)
    nbytes = diameter.bytes_estimate(cap, diameter.DEFAULT_BLOCK, "seqacc", extent=e)
    want = max(flops / profile["peak_flops"], nbytes / profile["mem_bw"]) * 1e6
    assert cm.diameter_extent_us(cap, 1, extent) == pytest.approx(want, rel=1e-12)
    if extent is None:
        assert cm.diameter_case_us(cap, 1) == pytest.approx(want, rel=1e-12)
    k = -(-e // diameter.DEFAULT_BLOCK)
    assert flops == 14.0 * k * (k + 1) // 2 * diameter.DEFAULT_BLOCK ** 2


def test_analytic_constant_only_without_hw_profile(monkeypatch):
    monkeypatch.setenv("REPRO_ROOFLINE", "0")
    cm = costmodel.CostModel("cpu")
    assert cm.hw_profile() is None
    assert cm.diameter_case_us(2048, 1) == (2048 / 1024.0) ** 2 * costmodel.PAIR_SWEEP_US
    assert cm.diameter_extent_us(2048, 1, 512) == 0.25 * costmodel.PAIR_SWEEP_US
    assert autotune.get_hw_profile("cuda") is None


def test_probes_default_without_calibration(monkeypatch):
    # REPRO_AUTOTUNE=0 (fixture): nothing probes, nothing is written
    probes = autotune.PROBES
    assert autotune.get_sync_cost("cpu") == autotune.DEFAULT_SYNC_US
    assert autotune.get_hw_profile("cpu") == autotune.DEFAULT_HW_PROFILES["cpu"]
    assert autotune.get_hw_profile("cuda") == autotune.H100_SXM_PROFILE
    assert autotune.H100_SXM_PROFILE["peak_flops"] == 67e12
    assert autotune.H100_SXM_PROFILE["mem_bw"] == 3.35e12
    # the CPU never probes, even with sweeps forced on
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    cm = costmodel.CostModel("cpu").resolve()
    assert cm.sync_cost_us() == autotune.DEFAULT_SYNC_US
    assert autotune.PROBES == probes
    assert not os.path.exists(os.environ["REPRO_AUTOTUNE_CACHE"])
    # a pinned entry wins on every device type
    autotune.AutotuneCache().put(autotune.sync_key("cpu"), {"us": 12.5})
    autotune.AutotuneCache().put(autotune.hw_key("cpu"), {"peak_flops": 1e9, "mem_bw": 2e9,
                                                          "revision": autotune.HW_PROBE_REVISION})
    assert autotune.get_sync_cost("cpu") == 12.5
    assert autotune.get_hw_profile("cpu") == {"peak_flops": 1e9, "mem_bw": 2e9,
                                              "source": "measured"}


@pytest.mark.parametrize("revision", [None, 1])
def test_hw_record_of_another_revision_is_a_miss(revision):
    """A hw/<device> record of the old probe (no revision: the eager two-kernel
    expression) or of another revision is not read back."""
    rec = {"peak_flops": 1e9, "mem_bw": 2e9}
    if revision is not None:
        rec["revision"] = revision
    autotune.AutotuneCache().put(autotune.hw_key("cpu"), rec)
    assert autotune.get_hw_profile("cpu") == autotune.DEFAULT_HW_PROFILES["cpu"]


@pytest.mark.parametrize("probe,ops", [
    (autotune.bandwidth_probe_op, ["aten::add"]),
    (lambda u, v: u + 0.5 * v, ["aten::mul", "aten::add"]),  # the old probe: two kernels
])
def test_bandwidth_probe_is_one_kernel(probe, ops):
    """The bandwidth probe counts HW_PROBE_STREAMS (3) streams, so its
    expression must run as one kernel: two reads and one write."""
    from torch.profiler import ProfilerActivity, profile

    u, v = torch.ones(4096), torch.full((4096,), 2.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = probe(u, v)
    assert [e.name for e in prof.events() if e.cpu_parent is None] == ops
    assert torch.equal(out, torch.full((4096,), 2.0))
    assert autotune.HW_PROBE_STREAMS == 3
    assert 3 * 4 * autotune.HW_PROBE_COPY_ELEMS > 10 * 50e6  # well past the H100's 50 MB L2


def test_choose_schedule_prices_extents_not_caps():
    """The reference prices a sweep at its bucket's cap, the port at the
    extent the plan expects; the windows below pin where they agree and
    where they differ (ROADMAP.md, Queue 3, deliberate divergences)."""
    ours, theirs = costmodel.CostModel("cpu"), jax_costmodel.CostModel("ref")
    empty = [(None, None, 0, 0)]
    assert ours.choose_schedule([planlib.CaseMeta(*m) for m in empty]) == "counted"
    assert theirs.choose_schedule([jax_plan.CaseMeta(*m) for m in empty]) == "counted"
    # a floor-cap window: the target is the cap, the fetch buys nothing
    floor = [((32, 32, 32), (20, 20, 20), 512, 300)] * 4
    assert ours.choose_schedule([planlib.CaseMeta(*m) for m in floor]) == "static"
    assert theirs.choose_schedule([jax_plan.CaseMeta(*m) for m in floor]) == "static"
    # the reference's big-cap window: its cap pricing makes the tight
    # buckets pay for the fetch; at the same extent (1,500 of 6,000
    # vertices) both sweeps cost the same, so the fetch decides: static
    big = [((64, 64, 64), (50, 50, 50), 8192, 6000)] * 4
    assert theirs.choose_schedule([jax_plan.CaseMeta(*m) for m in big]) == "counted"
    assert ours.choose_schedule([planlib.CaseMeta(*m) for m in big]) == "static"
    costs = ours.schedule_costs([planlib.CaseMeta(*m) for m in big])
    assert costs["counted"] - costs["static"] == pytest.approx(ours.sync_cost_us())
    # extent pricing by hand: one group of 4 at cap 8192 (target 4096), kept
    # 1500 in the tight bucket 2048; the tight bucket measured 100x cheaper a
    # pair than the target makes the fetch worth it
    cache = autotune.AutotuneCache()
    for cap, us in ((2048, 10.0), (4096, 4000.0)):
        cache.put(autotune.sweep_key(cap, "cpu", 4),
                  {"variant": "seqacc", "block": 128, "us": us, "revision": diameter.REVISION})
    cm = costmodel.CostModel("cpu")
    costs = cm.schedule_costs([planlib.CaseMeta(*m) for m in big])
    assert costs["counted"] == pytest.approx(
        autotune.DEFAULT_SYNC_US + 4 * (10.0 / 4) * (1500 / 1536) ** 2)
    assert costs["static"] == pytest.approx(4 * (4000.0 / 4) * (1500 / 3072) ** 2)
    assert cm.choose_schedule([planlib.CaseMeta(*m) for m in big]) == "counted"


@pytest.mark.parametrize("kind", planlib.WORK_KINDS)
def test_work_items_priced_from_the_ports_counts(kind):
    item = planlib.WorkItem(kind=kind, depth=3, m=4096, cap=1024, shape=(64, 32, 32))
    flops, nbytes = rooflib.work_item_cost(item)
    assert nbytes > 0 and flops >= 0
    vox = 3 * 64 * 32 * 32
    want = {
        "diameter": (3 * diameter.flop_estimate(4096, 128, "seqacc"),
                     3 * diameter.bytes_estimate(4096, 128, "seqacc")),
        "prune": (3 * 4096 * 4 * (5 * 16 + 85), 14 * 3 * 4096),
        "compact": (0, 3 * 4096 + 12 * 3 * 1024 + 13 * 3 * 1024 + 12),
        "mc": (8 * 3 * 63 * 31 * 31, 4 * vox + 24),
        "firstorder": (vox + 8 * vox, 8 * vox + 24 + 4 * 3 * rooflib._fo.packed_width(32)),
        "glcm": (vox + 5 * vox + 6 * 3 * vox, 8 * vox + 24 + 4 * 3 * 32 * 32),
    }[kind]
    assert (flops, nbytes) == (float(want[0]), float(want[1]))
    profile = autotune.H100_SXM_PROFILE
    assert rooflib.work_item_us(item, profile) == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12) * 1e6)
    plan = planlib.build_plan([planlib.CaseMeta((64, 32, 32), (50, 20, 20), 4096, 3000)] * 2,
                              "static", families=("shape", "firstorder", "glcm"))
    total = rooflib.plan_cost(plan)
    items = plan.work_census()
    assert total["flops"] == pytest.approx(sum(rooflib.work_item_cost(i)[0] for i in items))
    assert total["bytes"] == pytest.approx(sum(rooflib.work_item_cost(i)[1] for i in items))
    assert set(total["per_kind"]) == set(planlib.WORK_KINDS)


def test_env_float_warns_once_on_malformed(monkeypatch):
    monkeypatch.setenv("REPRO_STREAM_MEM_MB", "lots")
    costmodel._warned_env.discard("REPRO_STREAM_MEM_MB")
    with pytest.warns(RuntimeWarning, match="REPRO_STREAM_MEM_MB"):
        assert costmodel._env_float("REPRO_STREAM_MEM_MB", 512.0) == 512.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert costmodel._env_float("REPRO_STREAM_MEM_MB", 512.0) == 512.0  # once
        monkeypatch.delenv("REPRO_STREAM_MEM_MB")
        assert costmodel._env_float("REPRO_STREAM_MEM_MB", 1.5) == 1.5
        monkeypatch.setenv("REPRO_STREAM_MEM_MB", "256")
        assert costmodel._env_float("REPRO_STREAM_MEM_MB", 1.5) == 256.0
    costmodel._warned_env.discard("REPRO_STREAM_MEM_MB")
    monkeypatch.setenv("REPRO_STREAM_MAX_CASES", "many")
    costmodel._warned_env.discard("REPRO_STREAM_MAX_CASES")
    with pytest.warns(RuntimeWarning, match="REPRO_STREAM_MAX_CASES"):
        cm = costmodel.CostModel("cpu")
    assert cm.window_max_cases == costmodel.DEFAULT_WINDOW_MAX_CASES
    costmodel._warned_env.discard("REPRO_STREAM_MAX_CASES")


# ---------------------------------------------------------------------------
# end to end on the CPU
# ---------------------------------------------------------------------------

def _mixed_cases():
    return [_case((30, 30, 30), 1), _empty(), _case((20, 18, 16), 5),
            _case((44, 18, 18), 4), _case((30, 30, 30), 2)]


def test_schedule_auto_equals_counted_and_resolves_per_window():
    cases = [_case((30, 30, 30), 1), _case((30, 30, 30), 2)]
    want, _ = BatchedExtractor(device="cpu", schedule="counted").run(cases)
    bx = BatchedExtractor(device="cpu", schedule="auto")
    rows, stats = bx.run(cases)
    _assert_rows_equal(want, rows)
    assert stats["schedule"] == "auto"
    # extent pricing on the default profile: the fetch buys nothing
    assert stats["plan"]["schedule"] == "static"
    assert bx.executor.transfer_log.get("pass1", 0) == 0
    # measured tight buckets far cheaper a pair than the targets: counted
    ex = bx.executor
    metas = [ex.case_meta(ex.prep_case(c)) for c in cases]
    cache = autotune.AutotuneCache()
    for m in metas:
        kept = max(2, int(m.n_vertices * costmodel.ASSUMED_KEEP_FRACTION))
        tight = min(planlib.vertex_bucket(kept), m.vertex_cap)
        target = planlib.static_bucket(m.vertex_cap) or m.vertex_cap
        for cap, us in ((tight, 1e-3), (target, 1e6)):
            cache.put(autotune.sweep_key(cap, "cpu", 2),
                      {"us": us, "revision": diameter.REVISION})
    bx2 = BatchedExtractor(device="cpu", schedule="auto")
    rows2, stats2 = bx2.run(cases)
    assert stats2["plan"]["schedule"] == "counted"
    assert bx2.executor.transfer_log["pass1"] == 1
    _assert_rows_equal(want, rows2)


def test_schedule_auto_forced_static_by_pinned_sync_entry():
    cases = [_case((30, 30, 30), 1), _case((30, 30, 30), 2)]
    want, _ = BatchedExtractor(device="cpu", schedule="counted").run(cases)
    autotune.AutotuneCache().put(autotune.sync_key("cpu"), {"us": 1e9})
    bx = BatchedExtractor(device="cpu", schedule="auto")
    assert bx.cost_model.sync_cost_us() == 1e9
    rows, stats = bx.run(cases)
    assert stats["plan"]["schedule"] == "static"
    assert bx.executor.transfer_log.get("pass1", 0) == 0
    _assert_rows_equal(want, rows)


def test_schedule_auto_requires_device_resident_path():
    with pytest.raises(ValueError, match="device-resident"):
        BatchedExtractor(device="cpu", schedule="auto", prune=False)
    with pytest.raises(ValueError, match="device-resident"):
        BatchedExtractor(device="cpu", schedule="auto", device_compact=False)
    with pytest.raises(ValueError, match="schedule"):
        BatchedExtractor(device="cpu", schedule="adaptive")


def _stream_seen(bx, cases, **kw):
    seen = []
    rows = list(bx.extract_stream(iter(cases), window="auto",
                                  stats_callback=lambda i, s: seen.append(
                                      (i, s["cases"], s["shape_buckets"])), **kw))
    return rows, seen


@pytest.mark.parametrize("which", ["split", "absorb", "one-byte"])
def test_window_auto_equals_fixed_and_matches_reference_boundaries(which):
    a, b = _case((30, 30, 30), 1), _case((70, 20, 20), 4)  # two shape buckets
    cases = {"split": [a, a, a, a, b],
             "absorb": [a, b, _empty(), _case((20, 18, 16), 5)],
             "one-byte": [a, a, a]}[which]
    bx = BatchedExtractor(device="cpu")
    jx = JaxBatchedExtractor(backend="ref")
    if which == "one-byte":
        bx.executor._cost_model = costmodel.CostModel("cpu", window_mem_bytes=1)
        jx.executor._cost_model = jax_costmodel.CostModel("ref", window_mem_bytes=1)
    want, _ = bx.run(cases)
    got, seen = _stream_seen(bx, cases)
    _assert_rows_equal(want, got)
    jax_rows, jax_seen = _stream_seen(jx, cases)
    assert seen == jax_seen
    assert {"split": [(0, 4, 1), (1, 1, 1)], "absorb": [(0, 4, 2)],
            "one-byte": [(0, 1, 1), (1, 1, 1), (2, 1, 1)]}[which] == seen
    np.testing.assert_allclose(np.stack(got), np.stack(jax_rows), rtol=1e-4)
    np.testing.assert_array_equal(np.stack(got)[:, 6], np.stack(jax_rows)[:, 6])


def test_window_rejects_junk():
    bx = BatchedExtractor(device="cpu")
    for bad in ("adaptive", "AUTO", 0, -2, 1.5, True, None):
        with pytest.raises(ValueError, match="window"):
            bx.extract_stream(iter([]), window=bad)
        with pytest.raises(ValueError, match="window"):
            bx.executor.extract_stream(iter([]), window=bad)
    assert list(bx.extract_stream(iter([]), window="auto")) == []


def test_full_auto_stream_equals_fixed_counted_count_baseline():
    cases = _mixed_cases()
    baseline = BatchedExtractor(device="cpu", schedule="counted", prep="count")
    want = list(baseline.extract_stream(iter(cases), window=2))
    auto = BatchedExtractor(device="cpu", schedule="auto", prep="hint")
    got = list(auto.extract_stream(iter(cases), window="auto"))
    _assert_rows_equal(want, got)
    log = auto.executor.transfer_log
    assert log.get("prep", 0) == 0 and log["collect_counts"] == 4
    jax_rows, _ = JaxBatchedExtractor(backend="ref").run(cases)
    got, jax_rows = np.stack(got), np.stack([np.asarray(r) for r in jax_rows])
    np.testing.assert_allclose(got, jax_rows, rtol=1e-4)
    np.testing.assert_array_equal(got[:, 6], jax_rows[:, 6])


def test_auto_stream_with_families_and_tiled_segment():
    """``window='auto'`` on the facade: the in-core segments stream in the
    cost model's windows, a TiledCase splits them, rows equal ``run``."""
    from repro_torch.data.tiles import TiledCase

    fams = ("shape", "firstorder", "glcm")
    img, msk, sp = _case((30, 30, 30), 3)
    cases = [_case((30, 30, 30), 1), TiledCase(msk, image=img, spacing=sp),
             _case((20, 18, 16), 5)]
    bx = BatchedExtractor(device="cpu", families=("shape", "firstorder"), schedule="auto",
                          prep="hint", tile_mem_mb=0.2)
    want, _ = bx.run(cases)
    _assert_rows_equal(want, list(bx.extract_stream(iter(cases), window="auto")))
    fx = BatchedExtractor(device="cpu", families=fams, schedule="auto", prep="hint")
    incore = [c for c in cases if not isinstance(c, TiledCase)]
    want, _ = BatchedExtractor(device="cpu", families=fams).run(incore)
    _assert_rows_equal(want, list(fx.extract_stream(iter(incore), window="auto")))
