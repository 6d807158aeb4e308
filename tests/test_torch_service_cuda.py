"""The cost model and the service on the card: served rows == extract_stream
bitwise, schedule='auto' == counted bitwise, the sync and hardware probes
stored once, and an auto submit under ``strict_syncs()`` on a cold cache.

Skipped without a CUDA device (a CUDA kernel has no CPU mode).  Run on an
H100 with ``PYTHONPATH=src python -m pytest -q tests/test_torch_service_cuda.py``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.runtime import autotune  # noqa: E402

pytestmark = pytest.mark.cuda

WAIT = 300  # seconds any single wait may take
SHAPES = [((48, 48, 48), 1), ((20, 18, 16), 5), ((70, 20, 20), 4), ((48, 48, 48), 2),
          ((40, 36, 30), 3), ((52, 28, 22), 4)]


@pytest.fixture(scope="module", autouse=True)
def _autotune_cache(tmp_path_factory):
    """This module's sweeps and probes go to a cache file of its own."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path_factory.mktemp("autotune") / "cache.json"))
    mp.delenv("REPRO_AUTOTUNE", raising=False)
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


def test_served_rows_equal_stream_on_the_card(dev):
    cases = _cases()
    bx = BatchedExtractor(families=("shape", "firstorder", "glcm"), prep="hint",
                          schedule="static")
    want = _stack(bx.extract_stream(iter(cases), window=3))
    with bx.serve() as svc:
        futs = [svc.submit(cases[:2], tenant="a"), svc.submit(cases[2:3], tenant="b"),
                svc.submit(cases[3:], tenant="a")]
        res = [f.result(timeout=WAIT) for f in futs]
    assert all(r.ok for r in res)
    np.testing.assert_array_equal(_stack([row for r in res for row in r.rows]), want)
    assert np.isfinite(want).all()


def test_schedule_auto_equals_counted_on_the_card(dev):
    cases = _cases()
    want, _ = BatchedExtractor().run(cases)
    bx = BatchedExtractor(schedule="auto", prep="hint")
    rows, stats = bx.run(cases)
    assert stats["schedule"] == "auto" and stats["plan"]["schedule"] in ("counted", "static")
    np.testing.assert_array_equal(_stack(rows), _stack(want))
    streamed = _stack(bx.extract_stream(iter(cases), window="auto"))
    np.testing.assert_array_equal(streamed, _stack(want))


def test_probes_store_sync_and_hw_once(dev, tmp_path, monkeypatch):
    path = tmp_path / "probes.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    probes = autotune.PROBES
    us = autotune.get_sync_cost(dev)
    prof = autotune.get_hw_profile(dev)
    assert autotune.PROBES == probes + 2
    entries = json.loads(path.read_text())["entries"]
    assert entries[autotune.sync_key("cuda")]["us"] == us > 0
    assert prof["source"] == "measured" and prof["peak_flops"] > 1e12 and prof["mem_bw"] > 1e11
    assert autotune.get_sync_cost(dev) == us
    assert autotune.get_hw_profile(dev)["peak_flops"] == prof["peak_flops"]
    assert autotune.PROBES == probes + 2  # cache hits: no second probe


def test_auto_submit_under_strict_syncs_with_cold_cache(dev, tmp_path, monkeypatch):
    """The probes run at construction, so an auto submit syncs only in the
    executor's counted fetches (explicit kernel configurations: no sweep)."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "cold.json"))
    probes = autotune.PROBES
    bx = BatchedExtractor(schedule="auto", prep="hint", variant="seqacc", compact_block=4096)
    assert autotune.PROBES == probes + 2
    cases = _cases()
    ex = bx.executor
    with ex.strict_syncs():
        window = ex.submit_window(cases)
    rows, _ = ex.collect_window(window)
    want, _ = BatchedExtractor(variant="seqacc").run(cases)
    np.testing.assert_array_equal(_stack(rows), _stack(want))
