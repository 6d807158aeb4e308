"""The resilience layer on the card: a retried window bitwise, a whole
runner under strict syncs, a dropped in-flight window.

* a window whose collect fails (at ``pass2a``, or at ``collect_counts``
  after a count was fetched) collects after ``resubmit_window`` as an
  undisturbed run's, under every schedule x prep, and the executor's
  ``retry=`` absorbs a one-shot fault bitwise;
* a ``ResilientRunner`` over a static/hint extractor runs whole inside
  ``PlanExecutor.strict_syncs()`` (no host sync but the collects' counted
  fetches), its retry and backoff included;
* a run preempted with ``drain_on_preempt=False`` drops its in-flight
  window while that window's copies into pinned memory are still queued
  behind a spin on a stream of its own; a resume in the same process, on
  the default stream, gives the uninterrupted
  run's records bitwise.

Skipped without a CUDA device: the ``dev`` fixture decides, not the
import.  Run on an H100 with ``PYTHONPATH=src python -m pytest -q
tests/test_torch_resilience_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.runtime.resilience import (  # noqa: E402
    FaultPlan,
    InjectedFault,
    ResilientRunner,
    RetryPolicy,
    RunManifest,
)

pytestmark = pytest.mark.cuda

FAMS = ("shape", "firstorder", "glcm")
COMBOS = [(s, p) for s in ("counted", "static") for p in ("count", "hint")]
SHAPES = [((48, 48, 48), 1), ((20, 18, 16), 5), ((70, 20, 20), 4), ((40, 36, 30), 3),
          ((52, 28, 22), 4), ((28, 22, 18), 2)]


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
    return torch.device("cuda")


def _cases():
    return [synthetic.make_case(s, seed=seed) for s, seed in SHAPES]


def _named(n=12):
    pool = [(20, 18, 16), (24, 20, 18), (22, 26, 14), (18, 16, 20)]
    return list(synthetic.stream_cases(n, dims_pool=pool, seed=7))


def _stack(rows):
    return np.stack([np.asarray(r, np.float32) for r in rows])


def _strip(rows):
    return sorted([{k: v for k, v in r.items() if k != "window"} for r in rows],
                  key=lambda r: r["id"])


class _FailAt:
    def __init__(self, stage, nth=1):
        self.stage, self.left = stage, nth

    def __call__(self, stage, x):
        if stage == self.stage and self.left > 0:
            self.left -= 1
            if self.left == 0:
                raise InjectedFault(f"fault at {stage}")


@pytest.mark.parametrize("schedule,prep", COMBOS)
def test_resubmit_and_retry_on_the_card_are_bitwise(dev, schedule, prep):
    cases = _cases()
    want, _ = BatchedExtractor(families=FAMS, schedule=schedule, prep=prep).run(cases)
    faults = [("pass2a", 1)] + ([("collect_counts", 2)] if prep == "hint" else [])
    for stage, nth in faults:
        ex = BatchedExtractor(families=FAMS, schedule=schedule, prep=prep,
                              transfer_callback=_FailAt(stage, nth)).executor
        window = ex.submit_window(cases)
        with pytest.raises(InjectedFault):
            ex.collect_window(window)
        rows, _ = ex.collect_window(ex.resubmit_window(window))
        np.testing.assert_array_equal(_stack(rows), _stack(want), err_msg=stage)
        ext = BatchedExtractor(families=FAMS, schedule=schedule, prep=prep,
                               transfer_callback=_FailAt(stage, nth),
                               retry=RetryPolicy(max_retries=2, base_delay=0.001))
        rows, stats = ext.run(cases)
        assert ext.executor.window_retries == 1 and stats["window_retries"] == 1
        np.testing.assert_array_equal(_stack(rows), _stack(want), err_msg=f"retry {stage}")


def test_runner_runs_whole_under_strict_syncs(dev, tmp_path):
    cases = _named()
    want = RunManifest(tmp_path / "want.jsonl")
    ResilientRunner(BatchedExtractor(schedule="static", prep="hint"), want, window=4).run(cases)

    def runner(path):
        fp = FaultPlan(fail_windows=(1,))
        ext = BatchedExtractor(schedule="static", prep="hint", transfer_callback=fp.transfer_hook,
                               retry=RetryPolicy(max_retries=2, base_delay=0.001))
        return ext, ResilientRunner(ext, RunManifest(path), window=4, fault_plan=fp)

    runner(tmp_path / "warm.jsonl")[1].run(cases)  # the first use: autotune lookups
    ext, run = runner(tmp_path / "strict.jsonl")
    with ext.executor.strict_syncs():
        rep = run.run(cases)
    assert rep.status == "complete" and rep.window_retries == 1
    log = ext.executor.transfer_log
    assert log["prep"] == 0 and log["pass1"] == 0 and log["collect_counts"] == len(cases)
    assert _strip(run.manifest.rows()) == _strip(want.rows())


class _SpinAhead:
    """The runner's executor; its submit number ``at`` runs on a stream of
    its own with a spin between its launches and its copies (``dropped``:
    the copies' events).  A spin ahead of the launches would fill the
    card's launch queue and block the submit; one on the default stream
    would hold up the next collect's own launches."""

    def __init__(self, ex, at, cycles):
        self._ex, self._at, self._cycles = ex, at, cycles
        self.submits, self.dropped, self._kept = 0, [], None
        self._side = torch.cuda.Stream()

    def __getattr__(self, name):
        return getattr(self._ex, name)

    def submit_prepped(self, prepped, batch_size=None):
        self.submits += 1
        ex = self._ex
        if self.submits - 1 != self._at:
            return ex.submit_prepped(prepped, batch_size)
        stage = ex._stage_results

        def spin_then_stage(window):
            torch.cuda._sleep(self._cycles)
            return stage(window)

        self._side.wait_stream(torch.cuda.current_stream())
        ex._stage_results = spin_then_stage
        try:
            with torch.cuda.stream(self._side):
                state = ex.submit_prepped(prepped, batch_size)
        finally:
            del ex._stage_results
        self._kept = prepped  # read on the side stream: outlives the dropped window
        self.dropped = [f.done for _, f in state.mc_futs]
        return state


def test_dropped_window_does_not_leak_into_the_resume(dev, tmp_path):
    cases = _named()
    want = RunManifest(tmp_path / "want.jsonl")
    ResilientRunner(BatchedExtractor(schedule="static", prep="hint"), want, window=4).run(cases)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    per_ms = 10_000_000 / start.elapsed_time(end)
    # 12 cases in windows of 4, SIGTERM at case 9: window 1 is in flight, dropped
    spin = _SpinAhead(BatchedExtractor(schedule="static", prep="hint").executor, 1,
                      int(1500 * per_ms))
    man = RunManifest(tmp_path / "b.jsonl")
    rep = ResilientRunner(spin, man, window=4, fault_plan=FaultPlan(preempt_at_case=9),
                          drain_on_preempt=False).run(cases)
    man.close()
    assert rep.status == "preempted" and rep.windows == 1 and spin.submits == 2
    # the dropped window's copies are still queued behind the spin
    assert spin.dropped and not all(e.query() for e in spin.dropped)
    resume = RunManifest(tmp_path / "b.jsonl")
    rep2 = ResilientRunner(BatchedExtractor(schedule="static", prep="hint"), resume,
                           window=4).run(cases)
    assert rep2.status == "complete" and rep.processed + rep2.processed == len(cases)
    assert _strip(resume.rows()) == _strip(want.rows())
