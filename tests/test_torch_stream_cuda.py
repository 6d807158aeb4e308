"""The sync-free window path on the card: static == counted, hint == count
and stream == run bitwise; no host sync in a hint + static submit; a
window's drain that does not wait for the next window's launches; the
hint overflow retry and the keep-originals re-sweep.

Skipped without a CUDA device (a CUDA kernel has no CPU mode).  Run on an
H100 with ``PYTHONPATH=src python -m pytest -q tests/test_torch_stream_cuda.py``.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import executor as exmod  # noqa: E402
from repro_torch.core import plan as planlib  # noqa: E402
from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

pytestmark = pytest.mark.cuda

FAMS = ("shape", "firstorder", "glcm")
SHAPES = [((48, 48, 48), 1), ((20, 18, 16), 5), ((70, 20, 20), 4), ((48, 48, 48), 2),
          ((40, 36, 30), 3), ((52, 28, 22), 4), ((28, 22, 18), 2), ((64, 40, 30), 6)]


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """This module's 'auto' sweeps on the card go to a cache file of its own."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path_factory.mktemp("autotune") / "cache.json"))
    yield
    mp.undo()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cases():
    return [synthetic.make_case(s, seed=seed) for s, seed in SHAPES]


def _stack(rows):
    return np.stack([np.asarray(r, np.float32) for r in rows])


def test_schedules_preps_and_stream_bitwise(dev):
    cases = _cases()
    want, wstats = BatchedExtractor(families=FAMS).run(cases)
    want = _stack(want)
    assert np.isfinite(want).all() and wstats["host_fetches"]["prep"] == len(cases)
    for schedule in ("counted", "static"):
        for prep in ("count", "hint"):
            ext = BatchedExtractor(families=FAMS, schedule=schedule, prep=prep)
            rows, _ = ext.run(cases)
            np.testing.assert_array_equal(_stack(rows), want, err_msg=f"{schedule}/{prep}")
            for window in (1, 3, len(cases)):
                got = _stack(ext.extract_stream(iter(cases), window=window))
                np.testing.assert_array_equal(got, want, err_msg=f"{schedule}/{prep} w{window}")
    ext = BatchedExtractor(families=FAMS, schedule="static", prep="hint")
    for case, row in zip(cases[:3], want):
        np.testing.assert_array_equal(ext.extract_one(*case), row)


def test_hint_static_submit_makes_no_host_sync(dev):
    cases = _cases()
    ext = BatchedExtractor(families=FAMS, schedule="static", prep="hint")
    want, _ = ext.run(cases)  # the first use: autotune lookups, allocator growth
    ex = ext.executor
    fetches0 = dict(ex.transfer_log)
    with ex.strict_syncs():
        window = ex.submit_window(cases)
    assert dict(ex.transfer_log) == fetches0  # no fetch at all before collect
    rows, _ = ex.collect_window(window)
    np.testing.assert_array_equal(_stack(rows), _stack(want))
    delta = {k: v - fetches0.get(k, 0) for k, v in ex.transfer_log.items()
             if v - fetches0.get(k, 0)}
    assert "prep" not in delta and "pass1" not in delta
    assert delta["collect_counts"] == len(cases)


def _cycles_per_ms():
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def test_drain_does_not_wait_for_the_next_window(dev):
    """Window b's launches queue behind a spin kernel longer than b's
    submit: window a's collect must return while the spin still runs.
    Windows of one case: a window's launches must fit the card's launch
    queue (~1,000 deep on an H100), or its submit blocks until the spin
    ends."""
    cases = _cases()
    a, b = cases[1:2], cases[2:3]
    ex = BatchedExtractor(families=FAMS, schedule="static", prep="hint").executor
    for w in (a, b):  # warm: autotune lookups, allocator growth
        ex.collect_window(ex.submit_window(w))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.collect_window(ex.submit_window(b))
    sleep_ms = 3e3 * (time.perf_counter() - t0) + 50.0
    cycles = int(sleep_ms * _cycles_per_ms())
    torch.cuda.synchronize()
    fetches0 = dict(ex.transfer_log)
    wa = ex.submit_window(a)
    torch.cuda._sleep(cycles)  # ahead of window b's launches
    gate = torch.cuda.Event()
    gate.record()
    wb = ex.submit_window(b)
    t0 = time.perf_counter()
    ex.collect_window(wa)
    collect_ms = 1e3 * (time.perf_counter() - t0)
    still_spinning = not gate.query()
    retries = {k: ex.transfer_log[k] - fetches0.get(k, 0) for k in ("pass2b_retry", "hint_retry")}
    ex.collect_window(wb)
    assert retries == {"pass2b_retry": 0, "hint_retry": 0}  # no launch at a's collect
    assert still_spinning, f"window a's collect waited for window b ({collect_ms:.1f} ms)"
    assert collect_ms < sleep_ms / 4


def test_hint_overflow_and_keep_originals_on_the_card(dev, monkeypatch):
    cases = _cases()[:3]
    want, _ = BatchedExtractor(families=FAMS, schedule="static").run(cases)
    with monkeypatch.context() as mp:
        mp.setattr(planlib, "vertex_hint", lambda *a, **k: 1)
        ext = BatchedExtractor(families=FAMS, schedule="static", prep="hint")
        rows, stats = ext.run(cases)
    assert stats["host_fetches"]["hint_retry"] >= 1
    np.testing.assert_array_equal(_stack(rows), _stack(want))

    rows = {}
    for schedule in ("static", "counted"):
        ex = BatchedExtractor(schedule=schedule).executor
        rng = np.random.default_rng(0)  # the same clouds for both schedules
        prepped = []
        for n in (600, 700):  # every vertex on a sphere: the bound keeps them all
            u = rng.normal(size=(n // 2, 3))
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            verts = np.zeros((1024, 3), np.float32)
            verts[:n] = np.concatenate([u, -u]) * 37.0
            vmask = np.arange(1024) < n
            prepped.append(exmod._Prepped(
                mask=torch.zeros((32, 32, 32), device=dev), spacing=np.ones(3, np.float32),
                shape=(32, 32, 32), roi_shape=(8, 8, 8),
                verts=torch.from_numpy(verts).to(dev), vmask=torch.from_numpy(vmask).to(dev),
                n_vertices=n, vertex_cap=1024))
        rows[schedule], _ = ex.collect_window(ex.submit_prepped(prepped))
        assert all(not p.prune_info.pruned and p.vertex_cap == 1024 for p in prepped)
        if schedule == "static":
            assert ex.transfer_log["pass2b_retry"] >= 1
    np.testing.assert_array_equal(_stack(rows["static"]), _stack(rows["counted"]))
