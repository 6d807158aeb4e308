"""The port's resilience layer on the CPU, against the JAX package's.

Counterparts of the reference's ``tests/test_resilience.py`` (the 19
contracts of ``runtime/resilience``: manifest identity, idempotence and
torn-tail repair; quarantine; retry; preemption; stragglers; the
preempt/resume acceptance test) and of the two radiomics tests of
``tests/test_system.py`` (straggler flagging, a real ``SIGTERM``), for
``repro_torch.runtime.resilience`` and ``repro_torch.runtime.
fault_tolerance``, plus:

* **parity with the JAX package** on the same seeded inputs: the
  acceptance run through both packages' runners gives the same ids,
  statuses, names and error records, features at rtol 1e-4 and the vertex
  count exactly; a manifest the JAX package's runner wrote resumes in the
  port's with every done case skipped; ``case_id``, ``FaultPlan``'s
  decisions and ``stream_cases`` are the JAX package's, byte for byte;
* **re-submission** (``PlanExecutor.resubmit_window``): after a collect
  that failed at ``pass2a``, at ``collect_counts`` after some counts were
  fetched, or after a forced hint overflow was re-run, the re-submitted
  window gives an undisturbed run's rows bitwise and collects with a
  first collect's fetches, under every schedule x prep;
* **errors of the card** are re-raised at once, without backoff.

The JAX side runs once per module (``_jax_acceptance``).
"""
import functools
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import BatchedExtractor as JaxBatchedExtractor  # noqa: E402
from repro.data import synthetic as jax_synth  # noqa: E402
from repro.runtime import resilience as jax_res  # noqa: E402
from repro_torch.core import executor as exmod  # noqa: E402
from repro_torch.core import plan as planlib  # noqa: E402
from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.parallel.sharding import Mesh  # noqa: E402
from repro_torch.runtime import resilience as port_res  # noqa: E402
from repro_torch.runtime.fault_tolerance import PreemptionHandler, StragglerDetector  # noqa: E402
from repro_torch.runtime.resilience import (  # noqa: E402
    COLLECT_STAGES,
    FEATURE_NAMES,
    FaultPlan,
    InjectedFault,
    ResilientRunner,
    RetryPolicy,
    RunManifest,
)

COMBOS = [(s, p) for s in ("counted", "static") for p in ("count", "hint")]


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


def _poisoned(shape=(20, 18, 16), seed=3):
    img, msk, sp = _case(shape, seed)
    bad = np.asarray(msk, np.float32).copy()
    bad[tuple(d // 2 for d in shape)] = np.nan
    return img, bad, sp


def _nan_row(row):
    return np.isnan(np.asarray(row)).any()


def _ext(**kw):
    return BatchedExtractor(device="cpu", schedule="static", prep="hint", **kw)


def _stack(rows):
    return np.stack([np.asarray(r, np.float32) for r in rows])


# ---------------------------------------------------------------------------
# manifest: identity, idempotence, torn-tail repair
# ---------------------------------------------------------------------------


def test_case_id_is_content_sensitive_and_the_jax_packages():
    img, msk, sp = _case((20, 18, 16), 1)
    base = RunManifest.case_id(msk, sp)
    assert RunManifest.case_id(msk.copy(), tuple(sp)) == base
    assert RunManifest.case_id(torch.from_numpy(msk), sp) == base  # a CPU tensor
    flipped = msk.copy()
    flipped[0, 0, 0] = not flipped[0, 0, 0]
    assert RunManifest.case_id(flipped, sp) != base
    assert RunManifest.case_id(msk, (1.0, 1.0, 2.0)) != base
    assert RunManifest.case_id(msk.astype(np.float64), sp) != base
    assert RunManifest.case_id(msk.reshape(-1), sp) != base
    for m, s in [(msk, sp), (msk.astype(np.float32), (0.5, 0.7, 2.5)), (flipped, sp)]:
        assert RunManifest.case_id(m, s) == jax_res.RunManifest.case_id(m, s)


def test_manifest_roundtrip_and_idempotence(tmp_path):
    p = tmp_path / "run.jsonl"
    man = RunManifest(p)
    assert man.resume() == set()
    feats = dict(zip(FEATURE_NAMES, map(float, range(7))))
    assert man.record("aaa", "done", name="c0", features=feats, window=0)
    assert man.record("bbb", "error", name="c1", error="boom", window=0)
    assert not man.record("aaa", "done", name="c0", features=feats, window=9)
    man.close()

    man2 = RunManifest(p)
    assert man2.resume() == {"aaa", "bbb"}
    rows = man2.rows()
    assert [r["id"] for r in rows] == ["aaa", "bbb"]  # first-written order
    assert rows[0]["status"] == "done" and rows[0]["features"] == feats
    assert rows[0]["window"] == 0  # the duplicate did not overwrite
    assert rows[1]["status"] == "error" and rows[1]["error"] == "boom"
    assert len(p.read_text().splitlines()) == 2
    assert FEATURE_NAMES == tuple(jax_res.FEATURE_NAMES)


def test_manifest_torn_tail_repaired_on_resume(tmp_path):
    p = tmp_path / "run.jsonl"
    with RunManifest(p) as man:
        man.record("aaa", "done", features={})
        man.record("bbb", "done", features={})
    with open(p, "ab") as f:  # a kill mid-write: an unterminated last line
        f.write(b'{"id": "ccc", "status"')
    man2 = RunManifest(p)
    assert man2.resume() == {"aaa", "bbb"}
    assert p.read_bytes().endswith(b"\n") and b"ccc" not in p.read_bytes()
    assert man2.record("ccc", "done", features={})
    assert RunManifest(p).resume() == {"aaa", "bbb", "ccc"}
    with open(p, "ab") as f:  # a terminated but corrupt line stops the replay too
        f.write(b"not json at all\n")
        f.write(b'{"id": "ddd", "status": "done"}\n')
    assert RunManifest(p).resume() == {"aaa", "bbb", "ccc"}


def test_manifest_record_json_is_line_atomic_and_the_jax_packages(tmp_path):
    feats = dict(zip(FEATURE_NAMES, [1.5, 2.25, 3.0, 4.0, 5.0, 6.0, 700.0]))
    lines = []
    for mod, name in ((jax_res, "jax"), (None, "port")):
        cls = RunManifest if mod is None else mod.RunManifest
        man = cls(tmp_path / f"{name}.jsonl")
        man.record("x", "done", name="c0", features=feats, window=3)
        man.record("y", "error", name="c1", error="ValueError: bad", window=3)
        man.close()
        lines.append((tmp_path / f"{name}.jsonl").read_bytes())
    assert lines[0] == lines[1]  # byte for byte
    rec = json.loads(lines[1].splitlines()[0])
    assert list(rec) == sorted(rec)
    assert rec == {"id": "x", "name": "c0", "status": "done", "features": feats, "window": 3}


# ---------------------------------------------------------------------------
# fault plan
# ---------------------------------------------------------------------------


def _outcomes(fp):
    out = []
    img, msk, sp = _case((20, 18, 16), 1)
    for i in range(40):
        try:
            _, m2, _ = fp.inject_case(i, (img, msk, sp))
        except Exception as e:
            assert type(e).__name__ == "InjectedFault"
            out.append("load")
            continue
        m2 = np.asarray(m2)
        if np.issubdtype(m2.dtype, np.floating) and np.isnan(m2).any():
            out.append(("nan", int(np.isnan(m2).sum())))
        elif not m2.any():
            out.append("empty")
        else:
            out.append("ok")
    return out


def test_fault_plan_is_deterministic_per_index_and_the_jax_packages():
    kw = dict(seed=7, load_error_rate=0.15, poison_nan_rate=0.15, poison_empty_rate=0.1)
    a = _outcomes(FaultPlan(**kw))
    assert a == _outcomes(FaultPlan(**kw))
    assert {"load", "empty", "ok"} <= {o if isinstance(o, str) else o[0] for o in a}
    assert any(isinstance(o, tuple) for o in a)  # the rates fire
    assert a == _outcomes(jax_res.FaultPlan(**kw))
    ours = FaultPlan(seed=3, window_fault_rate=0.3)
    theirs = jax_res.FaultPlan(seed=3, window_fault_rate=0.3)
    for w in range(30):
        ours.begin_window(w)
        theirs.begin_window(w)
        assert ours._pending_fault == theirs._pending_fault
        ours._pending_fault = theirs._pending_fault = None
    assert COLLECT_STAGES == jax_res.COLLECT_STAGES


def test_fault_plan_preempts_once_and_straggles_in_its_windows(monkeypatch):
    slept = []
    monkeypatch.setattr(port_res.time, "sleep", slept.append)
    fp = FaultPlan(preempt_at_case=3, straggle_windows=(2,), straggle_seconds=0.25)
    assert [fp.should_preempt(i) for i in range(6)] == [False] * 3 + [True, False, False]
    for w in range(4):
        fp.maybe_straggle(w)
    assert slept == [0.25]


# ---------------------------------------------------------------------------
# quarantine: row-level errors through the executor, sync-free invariants
# ---------------------------------------------------------------------------


def test_poisoned_case_quarantines_row_level_and_sync_free():
    good = [_case((20, 18, 16), 1), _case((20, 18, 16), 2)]
    rows0, _ = _ext().run(good)
    ext = _ext()
    rows, stats = ext.run([good[0], _poisoned(), good[1]])
    assert _nan_row(rows[1]) and not _nan_row(rows[0]) and not _nan_row(rows[2])
    assert stats["quarantined_cases"] == 1
    assert "non-finite" in stats["errors"][1]
    np.testing.assert_array_equal(rows[0], rows0[0])
    np.testing.assert_array_equal(rows[2], rows0[1])
    assert ext.executor.transfer_log["prep"] == 0
    assert ext.executor.transfer_log["pass1"] == 0


def test_loader_error_quarantines_in_stream():
    good = [_case((20, 18, 16), 1), _case((20, 18, 16), 2)]
    rows0, _ = _ext().run(good)

    def dead_loader():
        raise OSError("NFS mount went away")

    rows = list(_ext().extract_stream([good[0], dead_loader, good[1]], window=2))
    assert len(rows) == 3 and _nan_row(rows[1])
    np.testing.assert_array_equal(rows[0], rows0[0])
    np.testing.assert_array_equal(rows[2], rows0[1])


def test_invalid_spacing_quarantines():
    img, msk, _ = _case((20, 18, 16), 1)
    rows, stats = _ext().run([(img, msk, (1.0, -1.0, 1.0))])
    assert _nan_row(rows[0]) and "spacing" in stats["errors"][0]


# ---------------------------------------------------------------------------
# retry: transient collect faults re-submit bitwise
# ---------------------------------------------------------------------------


def _retry_cases():
    return [_case((20, 18, 16), s) for s in (1, 2, 4)]


@pytest.mark.parametrize("schedule,prep", COMBOS)
def test_window_retry_is_bit_identical(schedule, prep):
    cases = _retry_cases()
    rows0, _ = BatchedExtractor(device="cpu", schedule=schedule, prep=prep).run(cases)
    fp = FaultPlan(seed=0, fail_windows=(0,))
    fp.begin_window(0)  # arm the one-shot collect fault
    ext = BatchedExtractor(device="cpu", schedule=schedule, prep=prep,
                           transfer_callback=fp.transfer_hook,
                           retry=RetryPolicy(max_retries=2, base_delay=0.001))
    rows, stats = ext.run(cases)
    assert ext.executor.window_retries == 1 and stats["window_retries"] == 1
    np.testing.assert_array_equal(_stack(rows), _stack(rows0))
    if prep == "hint":
        assert stats["host_fetches"].get("prep", 0) == 0


def test_retry_exhaustion_reraises():
    def always_fail(stage, x):
        if stage in COLLECT_STAGES:
            raise InjectedFault(f"permanent fault at {stage}")

    ext = _ext(transfer_callback=always_fail,
               retry=RetryPolicy(max_retries=1, base_delay=0.001))
    with pytest.raises(InjectedFault, match="permanent"):
        ext.run([_case((20, 18, 16), 1)])
    assert ext.executor.window_retries == 1


def test_retry_policy_backoff_schedule_and_timeout_flag():
    p = RetryPolicy(base_delay=0.1, multiplier=3.0, max_delay=0.5)
    assert p.delay(0) == pytest.approx(0.1)
    assert p.delay(1) == pytest.approx(0.3)
    assert p.delay(2) == pytest.approx(0.5)  # capped
    ext = _ext(retry=RetryPolicy(timeout_s=0.0))
    _, stats = ext.run(_retry_cases()[:1])
    assert stats["collect_timeout"] > 0 and "window_retries" not in stats


@pytest.mark.parametrize("error", [getattr(torch, "AcceleratorError", None),
                                   torch.cuda.OutOfMemoryError],
                         ids=["accelerator", "out_of_memory"])
def test_device_error_is_not_retried(monkeypatch, error):
    """An error of the card poisons the CUDA context: collect_window
    re-raises it at once, with no backoff and no re-submit (the
    reference retries any exception)."""
    if error is None:
        pytest.skip("this torch has no torch.AcceleratorError")
    slept, resubmits = [], []
    monkeypatch.setattr(exmod.time, "sleep", slept.append)
    ex = _ext(retry=RetryPolicy(max_retries=3, base_delay=10.0)).executor
    window = ex.submit_window(_retry_cases()[:1])

    def dead(w):
        raise error("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(ex, "_collect_window", dead)
    monkeypatch.setattr(ex, "resubmit_window", resubmits.append)
    with pytest.raises(error):
        ex.collect_window(window)
    assert ex.window_retries == 0 and not slept and not resubmits


def test_window_retry_over_a_mesh_is_bit_identical():
    """A one-shot collect fault over a 3-slot mesh: the executor's retry
    re-runs the window's sharded passes and gives the undisturbed
    unsharded rows bitwise."""
    cases = _retry_cases()
    rows0, _ = _ext().run(cases)
    fp = FaultPlan(seed=0, fail_windows=(0,))
    fp.begin_window(0)  # arm the one-shot collect fault
    ext = _ext(mesh=Mesh(["cpu"] * 3), transfer_callback=fp.transfer_hook,
               retry=RetryPolicy(max_retries=2, base_delay=0.001))
    rows, stats = ext.run(cases)
    assert ext.executor.window_retries == 1 and stats["window_retries"] == 1
    assert stats["data_parallel"] == 3
    np.testing.assert_array_equal(_stack(rows), _stack(rows0))


# -- re-submission under every schedule x prep ---------------------------------


class _FailAt:
    """A transfer callback that raises once, at the ``nth`` fetch of
    ``stage``."""

    def __init__(self, stage, nth=1):
        self.stage, self.left, self.fired = stage, nth, False

    def __call__(self, stage, x):
        if stage == self.stage and not self.fired:
            self.left -= 1
            if self.left == 0:
                self.fired = True
                raise InjectedFault(f"fault at {stage}")


def _resubmit_cases():
    # a case that prunes to a smaller bucket, a small floor-cap case, an empty
    # mask, a second shape bucket
    z = np.zeros((10, 10, 10), np.float32)
    return [_case((48, 48, 48), 1), _case((20, 18, 16), 5), (z, z.copy(), (1.0, 1.0, 1.0)),
            _case((70, 20, 20), 4), _case((20, 18, 16), 6)]


RESUBMIT = [(s, p, "pass2a", 1) for s, p in COMBOS] + [
    (s, "hint", stage, 2) for s in ("counted", "static")
    for stage in ("collect_counts", "hint_retry")]


@pytest.mark.parametrize("schedule,prep,stage,nth", RESUBMIT)
def test_resubmit_after_a_failed_collect_collects_like_a_first_submit(
        monkeypatch, schedule, prep, stage, nth):
    """``collect_window(resubmit_window(w))`` after a collect that failed
    at ``stage`` (the ``nth`` fetch there: for ``collect_counts`` after a
    count was fetched, for ``hint_retry`` after an overflowing case was
    re-run count-sized) gives an undisturbed run's rows bitwise, with the
    fetches of an undisturbed collect."""
    if stage == "hint_retry":  # every hint below its case's count: each overflows
        monkeypatch.setattr(planlib, "vertex_hint", lambda *a, **k: 1)
    cases = _resubmit_cases()
    ex0 = BatchedExtractor(device="cpu", schedule=schedule, prep=prep).executor
    w0 = ex0.submit_window(cases)
    log0 = dict(ex0.transfer_log)
    want, _ = ex0.collect_window(w0)
    first_collect = {k: v - log0.get(k, 0) for k, v in ex0.transfer_log.items()}

    fail = _FailAt(stage, nth)
    ex = BatchedExtractor(device="cpu", schedule=schedule, prep=prep,
                          transfer_callback=fail).executor
    window = ex.submit_window(cases)
    with pytest.raises(InjectedFault):
        ex.collect_window(window)
    assert fail.fired
    again = ex.resubmit_window(window)
    log1 = dict(ex.transfer_log)
    rows, _ = ex.collect_window(again)
    np.testing.assert_array_equal(_stack(rows), _stack(want))
    assert {k: v - log1.get(k, 0) for k, v in ex.transfer_log.items()
            if v - log1.get(k, 0)} == {k: v for k, v in first_collect.items() if v}
    assert [p.vertex_cap for p in again.prepped] == [p.vertex_cap for p in w0.prepped]


# ---------------------------------------------------------------------------
# fault_tolerance: handler chaining, straggler detection
# ---------------------------------------------------------------------------


def test_preemption_handler_chains_and_restores():
    calls = []
    original = signal.getsignal(signal.SIGTERM)
    try:
        def outer(signum, frame):
            calls.append(signum)

        signal.signal(signal.SIGTERM, outer)
        h = PreemptionHandler().install()
        installed = signal.getsignal(signal.SIGTERM)
        assert installed is not outer
        h.install()  # idempotent: no self-chaining
        assert signal.getsignal(signal.SIGTERM) is installed
        installed(signal.SIGTERM, None)
        assert h.requested and calls == [signal.SIGTERM]  # chained through
        h.reset()
        assert not h.requested
        h.uninstall()
        assert signal.getsignal(signal.SIGTERM) is outer  # restored exactly
        h.uninstall()  # idempotent no-op
        assert signal.getsignal(signal.SIGTERM) is outer
    finally:
        signal.signal(signal.SIGTERM, original)


def test_preemption_handler_sigterm():
    """A real SIGTERM to this process sets the flag (tests/test_system.py:130)."""
    h = PreemptionHandler().install()
    try:
        assert not h.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.requested
    finally:
        h.uninstall()


def test_straggler_warmup_swallows_cold_start():
    det = StragglerDetector(window=8, threshold=2.0, warmup=1, min_samples=2)
    assert not det.observe(0, 10.0)  # not flagged, and kept out of the median
    for i in range(1, 5):
        assert not det.observe(i, 0.1)
    assert det.median == pytest.approx(0.1)
    assert det.observe(5, 1.0)  # a real straggler still trips
    legacy = StragglerDetector(window=8, threshold=2.0)
    assert legacy.warmup == 0 and legacy.min_samples is None


def test_straggler_detector_flags_slow_step():
    """tests/test_system.py:120."""
    d = StragglerDetector(window=8, threshold=2.0)
    assert not any(d.observe(i, 0.1) for i in range(20))
    assert d.observe(20, 0.5)  # 5x the median
    assert d.slow_steps and d.slow_steps[-1][0] == 20


# ---------------------------------------------------------------------------
# THE acceptance test: kill mid-stream, resume, compare manifests
# ---------------------------------------------------------------------------


def _cases(n, synth=synthetic):
    out = []
    for i in range(n):
        if i == 5:  # one poisoned case rides along mid-stream
            out.append((f"case-{i:03d}",) + _poisoned(seed=50))
        else:
            img, msk, sp = synth.make_case((20, 18, 16), seed=10 + i)
            out.append((f"case-{i:03d}", img, msk, sp))
    return out


def _strip(rows):
    # window ordinals restart on resume; everything else must match exactly
    return sorted([{k: v for k, v in r.items() if k != "window"} for r in rows],
                  key=lambda r: r["id"])


def _acceptance(tmp, res, make_ext, cases):
    """The reference's acceptance sequence with one package's runner:
    an uninterrupted run (manifest a), a run preempted by a real SIGTERM at
    case 9 with the in-flight window dropped (b), its resume; returns the
    reports and both manifests' rows."""
    n, window = len(cases), 4
    rep_a = res.ResilientRunner(make_ext(), res.RunManifest(tmp / "a.jsonl"),
                                window=window).run(cases)
    man_b = res.RunManifest(tmp / "b.jsonl")
    ext1 = make_ext()
    rep1 = res.ResilientRunner(ext1, man_b, window=window,
                               fault_plan=res.FaultPlan(preempt_at_case=9),
                               drain_on_preempt=False).run(cases)
    man_b.close()
    man_b2 = res.RunManifest(tmp / "b.jsonl")
    ext2 = make_ext()
    rep2 = res.ResilientRunner(ext2, man_b2, window=window).run(cases)
    rows_a = res.RunManifest(tmp / "a.jsonl").__enter__().rows()
    return dict(n=n, rep_a=rep_a, rep1=rep1, rep2=rep2, ext2=ext2, rows_b=man_b2.rows(),
                rows_a=rows_a)


@pytest.fixture(scope="module")
def _jax_acceptance(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_acceptance")
    prev = {k: os.environ.get(k) for k in ("REPRO_AUTOTUNE", "REPRO_AUTOTUNE_CACHE")}
    os.environ["REPRO_AUTOTUNE"] = "0"
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(tmp / "autotune.json")
    try:
        out = _acceptance(tmp, jax_res, lambda: JaxBatchedExtractor(
            backend="ref", schedule="static", prep="hint"), _cases(10, jax_synth))
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["dir"] = tmp
    return out


@pytest.fixture(scope="module")
def _port_acceptance(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_acceptance")
    out = _acceptance(tmp, port_res, _ext, _cases(10))
    out["dir"] = tmp
    return out


def test_preempt_resume_manifest_bit_identical(_port_acceptance):
    r = _port_acceptance
    n = r["n"]
    assert r["rep_a"].status == "complete" and r["rep_a"].processed == n
    assert r["rep_a"].quarantined == 1  # the poisoned case, as an error row
    assert r["rep1"].status == "preempted" and 0 < r["rep1"].processed < n
    assert r["rep2"].status == "complete" and r["rep2"].skipped == r["rep1"].processed
    log = r["ext2"].executor.transfer_log
    assert log["prep"] == 0 and log["pass1"] == 0
    assert r["rep1"].processed + r["rep2"].processed == n
    ids = [row["id"] for row in r["rows_b"]]
    assert len(ids) == n == len(set(ids))
    assert r["rep1"].windows + r["rep2"].windows <= r["rep_a"].windows + 1
    assert _strip(r["rows_b"]) == _strip(r["rows_a"])
    errs = [row for row in r["rows_b"] if row["status"] == "error"]
    assert [e["name"] for e in errs] == ["case-005"]


def test_preempt_resume_manifest_matches_the_jax_packages(_port_acceptance, _jax_acceptance):
    """The same acceptance run through both packages' runners: ids,
    statuses, names and error records identical, the windows' counts and
    the reports' too; features at rtol 1e-4, the vertex count exactly."""
    ours, theirs = _port_acceptance, _jax_acceptance
    for key in ("rep_a", "rep1", "rep2"):
        a, b = ours[key], theirs[key]
        assert (a.status, a.skipped, a.processed, a.quarantined, a.windows,
                a.window_retries) == (b.status, b.skipped, b.processed, b.quarantined,
                                      b.windows, b.window_retries), key
    for rows in ("rows_a", "rows_b"):
        mine, jax_rows = _strip(ours[rows]), _strip(theirs[rows])
        assert [(r["id"], r["status"], r.get("name"), r.get("error")) for r in mine] == \
            [(r["id"], r["status"], r.get("name"), r.get("error")) for r in jax_rows]
        for a, b in zip(mine, jax_rows):
            if a["status"] != "done":
                continue
            assert list(a["features"]) == list(b["features"])
            fa, fb = (np.array([r["features"][k] for k in FEATURE_NAMES]) for r in (a, b))
            np.testing.assert_allclose(fa[:6], fb[:6], rtol=1e-4)
            assert fa[6] == fb[6]  # the vertex count


def test_jax_written_manifest_resumes_in_the_port(_jax_acceptance, tmp_path):
    """The state this slice carries across: a manifest the JAX package's
    runner completed resumes in the port's runner with every case skipped
    by the same content ids, and a partial one completes to the JAX
    package's uninterrupted record set."""
    src = _jax_acceptance["dir"]
    done = tmp_path / "done.jsonl"
    done.write_bytes((src / "a.jsonl").read_bytes())
    rep = ResilientRunner(_ext(), RunManifest(done), window=4).run(_cases(10))
    assert rep.status == "complete" and rep.processed == 0 and rep.skipped == 10
    assert done.read_bytes() == (src / "a.jsonl").read_bytes()

    part = tmp_path / "part.jsonl"
    lines = (src / "a.jsonl").read_bytes().splitlines(keepends=True)
    part.write_bytes(b"".join(lines[:5]) + lines[5][:17])  # a torn tail too
    man = RunManifest(part)
    rep = ResilientRunner(_ext(), man, window=4).run(_cases(10))
    assert rep.skipped == 5 and rep.processed == 5
    mine, theirs = _strip(man.rows()), _strip(_jax_acceptance["rows_a"])
    assert [(r["id"], r["status"], r.get("name")) for r in mine] == \
        [(r["id"], r["status"], r.get("name")) for r in theirs]


def test_resilient_runner_load_error_quarantined_and_stable(tmp_path):
    cases = _cases(4)

    def dead():
        raise OSError("gone")

    cases[2] = ("case-002", dead)
    man = RunManifest(tmp_path / "m.jsonl")
    rep = ResilientRunner(_ext(), man, window=2).run(cases)
    assert rep.processed == 4 and rep.quarantined == 1
    err = [r for r in man.rows() if r["status"] == "error"]
    assert len(err) == 1 and err[0]["id"] == "load-error:case-002"  # keyed by name
    rep2 = ResilientRunner(_ext(), man, window=2).run(cases)
    assert rep2.processed == 0 and rep2.skipped == 4


def test_resume_after_load_error_over_filtered_stream(tmp_path):
    cases = _cases(5)

    def dead():
        raise OSError("gone")

    cases[3] = ("case-003", dead)
    man = RunManifest(tmp_path / "m.jsonl")
    rep = ResilientRunner(_ext(), man, window=2).run(cases)
    assert rep.processed == 5 and rep.quarantined == 1
    man.close()
    man2 = RunManifest(tmp_path / "m.jsonl")
    # resume over a filtered and reordered stream: the failing case first
    rep2 = ResilientRunner(_ext(), man2, window=2).run([cases[3], cases[4], cases[1]])
    assert rep2.processed == 0 and rep2.skipped == 3
    ids = [r["id"] for r in man2.rows()]
    assert len(ids) == 5 == len(set(ids))


class _PartialNaNExecutor:
    """A fake executor whose window holds a real row with a NaN feature
    (tag 7) beside a quarantined case (tag 9: an all-NaN row and an
    ``errors`` entry)."""

    n_features = 7
    prune = True

    def prep_case(self, case):
        return case

    def submit_prepped(self, prepped):
        return list(prepped)

    def collect_window(self, window):
        rows, errors = [], {}
        for j, (img, msk, sp) in enumerate(window):
            tag = float(np.asarray(msk)[0, 0, 0])
            if tag == 9.0:
                rows.append(np.full(7, np.nan, np.float32))
                errors[j] = "ValueError: poisoned"
            elif tag == 7.0:
                row = np.arange(7, dtype=np.float32)
                row[3] = np.nan
                rows.append(row)
            else:
                rows.append(np.full(7, float(j), np.float32))
        return rows, {"errors": errors}


def test_partial_nan_legit_row_not_misrecorded_as_quarantined(tmp_path):
    def tagged(tag, fill):
        msk = np.full((4, 4, 4), fill, np.float32)
        msk[0, 0, 0] = tag
        return np.zeros((4, 4, 4), np.float32), msk, (1.0, 1.0, 1.0)

    cases = [("plain",) + tagged(0, 1), ("nan-feature",) + tagged(7, 2),
             ("poisoned",) + tagged(9, 3)]
    man = RunManifest(tmp_path / "m.jsonl")
    rep = ResilientRunner(_PartialNaNExecutor(), man, window=3).run(cases)
    assert rep.processed == 3 and rep.quarantined == 1
    by_name = {r["name"]: r for r in man.rows()}
    assert by_name["poisoned"]["status"] == "error"
    assert by_name["poisoned"]["error"] == "ValueError: poisoned"
    assert by_name["plain"]["status"] == "done"
    rec = by_name["nan-feature"]
    assert rec["status"] == "done"
    feats = list(rec["features"].values())
    assert np.isnan(feats[3]) and not np.isnan(feats[2])


def test_runner_retries_and_flags_the_straggler_window(tmp_path, monkeypatch):
    """A FaultPlan's collect fault is absorbed by the executor's retry and
    its straggler window is flagged in the census; rows == an undisturbed
    run's."""
    cases = _cases(12)
    want = RunManifest(tmp_path / "want.jsonl")
    ResilientRunner(_ext(), want, window=2).run(cases)
    fp = FaultPlan(fail_windows=(1,), straggle_windows=(5,), straggle_seconds=0.3)
    census = {}
    man = RunManifest(tmp_path / "m.jsonl")
    ext = _ext(transfer_callback=fp.transfer_hook,
               retry=RetryPolicy(max_retries=2, base_delay=0.001))
    rep = ResilientRunner(ext, man, window=2, fault_plan=fp,
                          stats_callback=lambda w, s: census.setdefault(w, s)).run(cases)
    assert rep.window_retries == 1 and rep.windows == 6
    assert [w for w, _ in rep.stragglers] == [5] and census[5]["straggler"]
    assert census[5]["seconds"] >= 0.3 and census[0]["schedule"] == "static"
    assert _strip(man.rows()) == _strip(want.rows())


# ---------------------------------------------------------------------------
# the cohort stream
# ---------------------------------------------------------------------------


def test_stream_cases_skip_yields_promised_count():
    pool = [(20, 18, 16), (24, 20, 18), (22, 26, 14)]
    full = list(synthetic.stream_cases(6, pool, seed=3))
    out = list(synthetic.stream_cases(6, pool, seed=3, skip={"case-00001", "case-00003"}))
    assert len(out) == 6
    assert [n for n, *_ in out] == ["case-00000", "case-00002", "case-00004",
                                    "case-00005", "case-00006", "case-00007"]
    by_name = {n: (img, msk) for n, img, msk, _ in full}
    for n, img, msk, _ in out:
        if n in by_name:
            np.testing.assert_array_equal(img, by_name[n][0])
            np.testing.assert_array_equal(msk, by_name[n][1])


def test_stream_cases_is_the_jax_packages_byte_for_byte():
    kw = dict(dims_pool=[(20, 18, 16), (24, 20, 18), (30, 22, 14)], seed=5,
              spacing=(0.8, 0.8, 2.5), skip={"case-00002"})
    for ours, theirs in zip(synthetic.stream_cases(5, **kw), jax_synth.stream_cases(5, **kw)):
        assert ours[0] == theirs[0]
        for a, b in zip(ours[1:], theirs[1:]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()



def test_stream_cases_default_pool_is_the_jax_packages(monkeypatch):
    """The default pool, cycled over 20 cases: each case's dims, seed and
    spacing as the JAX package's (``make_case`` stubbed in both)."""
    for mod in (synthetic, jax_synth):
        monkeypatch.setattr(mod, "make_case", lambda d, seed, spacing: (d, seed, spacing))
    assert list(synthetic.stream_cases(20, seed=4)) == list(jax_synth.stream_cases(20, seed=4))


def test_runner_rejects_non_integer_window(tmp_path):
    with pytest.raises(ValueError, match="window"):
        ResilientRunner(object(), RunManifest(tmp_path / "x.jsonl"), window="auto")
