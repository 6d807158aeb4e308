"""The metric arithmetic: rates, percentiles from due time, the trace's
reduction, roofline shares and pad-waste weights; the open loop's
arrivals; the check's verdict."""
import math

import numpy as np
import pytest

from radbench import check, drivers, harness, readers, traffic
from radbench import trace as tracelib
from radbench import yardstick as ys

Service = drivers.load("service")


def make_run(**kw):
    base = dict(cell="c", entry="stream", loop="closed", config={}, cases=0, window_s=1.0,
                setup_s=1.0, counters={}, latencies_s=None, trace=None, work=None)
    base.update(kw)
    return harness.Run(**base)


def reader(name):
    return harness.load_reader(name)


def test_rate_is_over_the_whole_window():
    # 3 jobs of 100 cases in 4.0 s: the rate counts every case and every second
    assert reader("cases_per_s")(make_run(cases=300, window_s=4.0)) == 75.0
    assert reader("cases_per_s")(make_run(cases=300, window_s=4.0, loop="open")) is None


def test_percentile_is_nearest_rank_over_every_value():
    vals = list(range(1, 101))
    assert readers.percentile(vals, 0.95) == 95
    assert readers.percentile(vals, 0.5) == 50
    assert readers.percentile([7.0], 0.95) == 7.0


def open_loop_latencies(stall_s):
    """100 requests due every 10 ms, each served 5 ms after the server is
    free; the server stops for ``stall_s`` at request 50, and requests
    queue behind it.  Latency from due time, as the driver takes it."""
    svc = object.__new__(Service)
    free, reqs = 0.0, []
    for k in range(100):
        due = 0.01 * k
        start = max(due, free) + (stall_s if k == 50 else 0.0)
        free = start + 0.005
        reqs.append((k, due, free, None, None))
    svc.requests = reqs
    return svc.latencies_s()


def test_tail_from_due_time_moves_with_a_stall():
    calm = make_run(loop="open", latencies_s=open_loop_latencies(0.0))
    stalled = make_run(loop="open", latencies_s=open_loop_latencies(0.2))
    assert reader("serve.latency_p95_ms")(calm) == pytest.approx(5.0)
    # a 200 ms stall delays the 20 requests due during it: more than 5% of all
    assert reader("serve.latency_p95_ms")(stalled) > 100.0
    assert reader("serve.latency_p50_ms")(stalled) == pytest.approx(5.0)


def test_a_missing_answer_counts_as_the_longest_wait():
    run = make_run(loop="open", window_s=10.0, latencies_s=[0.01] * 19 + [math.inf])
    assert readers.latency_ms(run, 1.0) == pytest.approx(70_000.0)


def test_trace_summary_busy_idle_and_gaps():
    ns = 1_000_000
    events = [
        ("radbench.window", "user_annotation", 0, 100 * ns, "CPU"),
        ("radbench.crop_to_roi", "user_annotation", 30 * ns, 50 * ns, "CPU"),
        ("void mc_partials_kernel(float const*)", "kernel", 10 * ns, 20 * ns, "CUDA"),
        ("void diameter_sweep_kernel<4, true>()", "kernel", 15 * ns, 30 * ns, "CUDA"),
        ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 50 * ns, 60 * ns, "CUDA"),
        ("radbench.window", "gpu_user_annotation", 0, 100 * ns, "CUDA"),
        ("aten::add", "cpu_op", 0, 5 * ns, "CPU"),
    ]
    s = tracelib.summarize(events)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.03)  # the union [10, 30] and [50, 60]
    assert s.launches == 3
    assert s.idle_share == pytest.approx(0.7)
    assert s.idle["radbench.crop_to_roi"] == pytest.approx(0.02)
    assert s.idle["radbench.none"] == pytest.approx(0.05)  # [0, 10] and [60, 100]
    run = make_run(cases=2, trace=s)
    assert reader("device.idle_share")(run) == pytest.approx(70.0)
    assert reader("device.launches_per_case")(run) == 1.5
    b = s.breakdown()
    assert len(b["device_ops"]) == 3 and b["idle_gaps"][0][0] == "radbench.none"


def test_roofline_share_from_the_yardstick():
    s = tracelib.Summary(window_s=1.0, busy_s=0.1, launches=2, idle={},
                         kernel_s={"void diameter_sweep_kernel<4, true>(float)": 4e-3,
                                   "_Z21diameter_finalize_kernelPKfxPf": 1e-3})
    # 67e9 operations: 1 ms at the FP32 peak, over 5 ms of the kernel's launches
    run = make_run(trace=s, work={"diameter": (67e9, 0.0)})
    assert reader("diameter_roofline")(run) == pytest.approx(20.0)
    assert reader("marching_cubes_roofline")(run) is None  # nothing to read: no number
    assert ys.least_seconds((0.0, 3.35e9)) == (pytest.approx(1e-3), "bytes")


def test_pad_waste_is_weighted_by_padded_voxels():
    plans = [{"mask_pad_waste": 0.5, "vertex_pad_waste": 0.2},
             {"mask_pad_waste": 0.0, "vertex_pad_waste": 0.4}]
    run = make_run(counters={"plan": plans, "roi_voxels": [100, 100]})
    # padded voxels 200 and 100
    assert reader("plan.mask_pad_waste")(run) == pytest.approx(100 * 100 / 300)
    assert reader("plan.vertex_pad_waste")(run) == pytest.approx(100 * (40 + 40) / 300)


def test_counter_readers():
    run = make_run(counters={"fetches": 30, "windows": 4, "window_cases": [2, 4, 6],
                             "preprocess_ms": 25.0, "total_ms": 100.0})
    assert reader("executor.fetches_per_window")(run) == 7.5
    assert reader("serve.window_cases")(run) == 4.0
    assert reader("single.preprocess_share")(run) == 25.0
    assert reader("setup_s")(run) == 1.0


def test_repeat_answers_of_one_case_are_each_held_to_the_reference():
    # two answers of one case that differ by round-off, each well inside the
    # limits, are correct; one outside a limit is not
    want = {"shape": np.array([10.0, 20.0, 5.0, 4.0, 4.0, 3.0])}
    close = {"shape": want["shape"] * (1 + 1e-7)}
    far = {"shape": want["shape"] * (1 + 2e-3)}
    limits = {"mesh_rel": 1e-3, "diam_rel": 1e-4}
    ok, shown = check.verdict(check.worst([check.gaps(g, want, 32) for g in (want, close)]),
                              limits, 0)
    assert ok and set(shown) == {"mesh_rel", "diam_rel", "missing_answers"}
    ok, _ = check.verdict(check.worst([check.gaps(g, want, 32) for g in (want, far)]), limits, 0)
    assert not ok
    ok, _ = check.verdict(check.worst([check.gaps(want, want, 32)]), limits, 1)
    assert not ok  # an answer that never came


def test_a_fixed_rate_open_loop_is_poisson_and_the_same_work_every_seed():
    a = traffic.arrivals(20.0, 30.0, 80, 8, 2**31 + 1)
    b = traffic.arrivals(20.0, 30.0, 80, 8, 2**31 + 2)
    ga, gb = np.diff([t for t, _, _ in a]), np.diff([t for t, _, _ in b])
    assert abs(len(a) - 600) <= 3 and abs(len(b) - 600) <= 3
    # gaps from the same set (the exponential's quantiles over 600), in another order
    q = -np.log(1 - (np.arange(600) + 0.5) / 600) / 20.0
    for g in (ga, gb):
        assert np.abs(g[:, None] - q[None, :]).min(axis=1).max() < 1e-9
    assert not np.allclose(ga[:500], gb[:500])
    gaps = ga
    assert gaps.mean() == pytest.approx(1 / 20.0, rel=0.02)
    assert np.std(gaps) == pytest.approx(1 / 20.0, rel=0.1)  # exponential: sd = mean
    assert [k for _, _, k in a[:9]] == [0, 1, 2, 3, 4, 5, 6, 7, 0]


def test_on_off_bursts_send_at_the_profile_rate():
    # 3x the mean for 2 s, nothing for 4 s: a mean of 20/s is 60/s in bursts
    a = traffic.arrivals(20.0, 60.0, 80, 8, 2**31 + 3, profile=[[2, 3], [4, 0]])
    t = np.array([x for x, _, _ in a])
    assert abs(len(a) - 1200) <= 1
    assert np.all(np.mod(t, 6.0) <= 2.0 + 1e-9)  # nothing due in an off period
    per_burst = np.bincount((t // 6).astype(int), minlength=10)
    assert per_burst.mean() == pytest.approx(120.0, rel=0.01)
    at = traffic.clock([[2, 3], [4, 0]], 20.0)
    assert at(60.0) == pytest.approx(1.0) and at(90.0) == pytest.approx(1.5)
    assert at(180.0) == pytest.approx(7.0)
