"""The port's serving tier on the CPU: parity, fusion, deadlines, backpressure, demux.

Mirrors the reference's ``tests/test_service.py`` for
``repro_torch.serve.service.ExtractionService`` and
``BatchedExtractor.serve``:

* **parity**: rows served through the multi-tenant driver equal the
  port's ``extract_stream`` rows bitwise, and the JAX service's rows on
  ``backend='ref'`` at rtol 1e-4 (the vertex count exactly);
* **cross-tenant fusion**: requests queued together from different
  tenants share windows (the driver is parked in a blocking loader, so
  the queue's state is deterministic);
* **deadlines**: a request that expires while queued completes with
  ``DeadlineExceeded`` error rows, takes no window slot and leaves its
  co-tenants' rows unchanged; ``deadline_at_risk`` at unit level;
* **backpressure**: admission bounded by estimated queue bytes;
* **demux**: a batch request's rows come back in its own order, with
  quarantine errors at the request's case index;
* **failure**: a ``RuntimeError`` from a launch inside the driver reaches
  ``close()`` and the next ``submit()``;
* ``examples/serve_clients_torch.py``, the two-tenant example, on the CPU
  (its cohort rows checked bitwise against ``run`` inside), and raising
  without a card unless asked for the CPU.

Every ``result()`` and wait carries a timeout.
"""
import functools
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import BatchedExtractor as JaxBatchedExtractor  # noqa: E402
from repro.data import synthetic as jax_synth  # noqa: E402
from repro.serve import service as jax_service  # noqa: E402
from repro_torch.core import plan as planlib  # noqa: E402
from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data.synthetic import make_case, mixed_traffic_stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import service as svcmod  # noqa: E402
from repro_torch.serve.service import (  # noqa: E402
    DEFAULT_LOADER_CASE_BYTES,
    ExtractionService,
    ServiceClosed,
    ServiceError,
    ServiceOverloaded,
    estimate_case_bytes,
)

WAIT = 120  # seconds any single wait may take


@pytest.fixture(autouse=True)
def _isolated_autotune(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


@functools.lru_cache(maxsize=None)
def _case(shape, seed):
    return make_case(shape, seed=seed)


def _cases(n, shape=(20, 18, 16)):
    return [_case(shape, 40 + i) for i in range(n)]


class _Plug:
    """A loader that parks the driver inside prep until released: whatever
    is submitted meanwhile is queued together."""

    def __init__(self, case):
        self.entered = threading.Event()
        self.release = threading.Event()
        self._case = case

    def __call__(self):
        self.entered.set()
        assert self.release.wait(WAIT), "plug never released"
        return self._case


def _rows_equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- parity ------------------------------------------------------------------------

def test_served_rows_bit_identical_to_stream_and_equal_reference():
    cases = _cases(5) + [_case((26, 22, 18), 91)]
    bx = BatchedExtractor(device="cpu", prep="hint", schedule="static")
    ref = [np.asarray(r) for r in bx.extract_stream(iter(cases), window=3)]

    def served(ext):
        with ext.serve() as svc:
            futs = [svc.submit([cases[0], cases[1]], tenant="a"),
                    svc.submit([cases[2]], tenant="b"),
                    svc.submit(cases[3:], tenant="a")]
            res = [f.result(timeout=WAIT) for f in futs]
        assert all(not r.errors for r in res)
        return [np.asarray(row) for r in res for row in r.rows]

    got = served(bx)
    _rows_equal(ref, got)
    jax_rows = np.stack(served(JaxBatchedExtractor(backend="ref", prep="hint",
                                                   schedule="static")))
    np.testing.assert_allclose(np.stack(got), jax_rows, rtol=1e-4)
    np.testing.assert_array_equal(np.stack(got)[:, 6], jax_rows[:, 6])


def test_serve_facade_and_loader_cases():
    bx = BatchedExtractor(device="cpu")
    case = _cases(1)[0]
    (ref_row,), _ = bx.run([case])
    svc = bx.serve()
    try:
        res = svc.submit_case(lambda: case, shape_hints=None, tenant="lazy").result(
            timeout=WAIT)
        assert res.ok and not res.late
        np.testing.assert_array_equal(np.asarray(res.rows[0]), np.asarray(ref_row))
        assert res.latency_s > 0
    finally:
        svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit_case(case)


# -- cross-tenant fusion -------------------------------------------------------------

def test_cross_tenant_requests_fuse_into_shared_windows():
    bx = BatchedExtractor(device="cpu", prep="hint", schedule="static")
    cases = _cases(4)
    plug = _Plug(cases[0])
    with bx.serve() as svc:
        f0 = svc.submit([plug], tenant="a")
        assert plug.entered.wait(WAIT)
        f1 = svc.submit([cases[1], cases[2]], tenant="b")
        f2 = svc.submit([cases[3]], tenant="c")
        plug.release.set()
        for f in (f0, f1, f2):
            assert not f.result(timeout=WAIT).errors
        stats = svc.stats()
    assert stats["requests"] == 3
    assert stats["windows"] < 3
    assert any(t > 1 for t in stats["window_tenants"])
    ref, _ = bx.run(cases)
    got = [f0.result(timeout=WAIT).rows[0], *f1.result(timeout=WAIT).rows,
           *f2.result(timeout=WAIT).rows]
    _rows_equal(ref, got)


# -- deadlines -------------------------------------------------------------------------

def test_expired_request_errors_without_stalling_cotenants():
    bx = BatchedExtractor(device="cpu", prep="hint", schedule="static")
    cases = _cases(4)
    ref, _ = bx.run(cases)
    plug = _Plug(cases[0])
    with bx.serve() as svc:
        f_plug = svc.submit([plug], tenant="live")
        assert plug.entered.wait(WAIT)
        f_live = svc.submit([cases[1], cases[2]], tenant="live")
        f_dead = svc.submit([cases[3]], tenant="hurried", deadline_s=0.01)
        time.sleep(0.05)  # the deadline passes while the request is queued
        plug.release.set()
        live, dead = f_live.result(timeout=WAIT), f_dead.result(timeout=WAIT)
        stats = svc.stats()
    assert set(dead.errors) == {0} and "DeadlineExceeded" in dead.errors[0]
    assert np.isnan(np.asarray(dead.rows[0])).all()
    assert stats["expired_cases"] == 1
    assert sum(stats["window_cases"]) == 3  # the expired case took no slot
    assert not live.errors and not f_plug.result(timeout=WAIT).errors
    np.testing.assert_array_equal(np.asarray(f_plug.result(timeout=WAIT).rows[0]),
                                  np.asarray(ref[0]))
    _rows_equal(ref[1:3], live.rows)


def test_deadline_at_risk_closes_early_at_unit_level():
    bx = BatchedExtractor(device="cpu")
    cm = bx.cost_model
    census = planlib.WindowCensus()
    assert not cm.deadline_at_risk(census, 5.0)
    assert not cm.deadline_at_risk(census, None)
    p = bx.executor.prep_case(_cases(1)[0])
    census.add(bx.executor.case_meta(p))
    cost = cm.window_cost_us(census)
    assert cost > 0
    census.add(bx.executor.case_meta(p))
    assert cm.window_cost_us(census) >= cost
    assert not cm.deadline_at_risk(census, 1e12)
    assert cm.deadline_at_risk(census, 1e-3)
    assert cm.deadline_at_risk(census, 0.0)
    assert cm.deadline_at_risk(census, -5.0)


# -- backpressure ------------------------------------------------------------------------

def test_admission_control_bounds_queue_bytes():
    bx = BatchedExtractor(device="cpu")
    cases = _cases(4)
    b = estimate_case_bytes(cases[0])
    assert b > 0
    plug = _Plug(cases[0])
    with bx.serve(max_queue_bytes=2.5 * b) as svc:
        svc.loader_case_bytes = b  # charge the plug like a real case
        f0 = svc.submit([plug], tenant="a")
        assert plug.entered.wait(WAIT)
        f1 = svc.submit([cases[1]], tenant="b")
        with pytest.raises(ServiceOverloaded):
            svc.submit([cases[2]], tenant="c", block=False)
        t0 = time.perf_counter()
        with pytest.raises(ServiceOverloaded):
            svc.submit([cases[2]], tenant="c", timeout=0.2)
        assert time.perf_counter() - t0 >= 0.2
        plug.release.set()
        assert not f0.result(timeout=WAIT).errors
        f2 = svc.submit([cases[2]], tenant="c", timeout=WAIT)
        assert not f1.result(timeout=WAIT).errors
        assert not f2.result(timeout=WAIT).errors


def test_oversize_request_admitted_only_against_empty_queue():
    bx = BatchedExtractor(device="cpu")
    case = _cases(1)[0]
    with bx.serve(max_queue_bytes=estimate_case_bytes(case) / 2) as svc:
        assert svc.submit([case], tenant="big").result(timeout=WAIT).ok


@pytest.mark.parametrize("shape,spacing", [((20, 18, 16), (1.0, 1.0, 1.0)),
                                           ((231, 104, 264), (0.8, 0.8, 2.5)),
                                           ((39, 33, 11), (1.0, 1.0, 3.0))])
def test_estimate_case_bytes_equals_reference(shape, spacing):
    img = np.zeros(shape, np.float32)
    case = (img, img, np.asarray(spacing, np.float32))
    for intensity in (False, True):
        assert estimate_case_bytes(case, intensity) == jax_service.estimate_case_bytes(
            case, intensity)
        assert estimate_case_bytes(lambda: case, intensity, shape_hint=shape) == \
            jax_service.estimate_case_bytes(lambda: case, intensity, shape_hint=shape)
    assert estimate_case_bytes(lambda: case) == DEFAULT_LOADER_CASE_BYTES \
        == jax_service.DEFAULT_LOADER_CASE_BYTES


def test_estimate_case_bytes_modes():
    img, msk, sp = _cases(1)[0]
    b = estimate_case_bytes((img, msk, sp))
    assert b > 0
    assert estimate_case_bytes((img, msk, sp), needs_intensity=True) > b
    assert estimate_case_bytes(lambda: (img, msk, sp), shape_hint=msk.shape) == b
    assert estimate_case_bytes(lambda: (img, msk, sp)) == DEFAULT_LOADER_CASE_BYTES
    assert estimate_case_bytes("junk") == DEFAULT_LOADER_CASE_BYTES


# -- demux and quarantine ------------------------------------------------------------------

def test_batch_demux_preserves_request_order_with_quarantine():
    bx = BatchedExtractor(device="cpu")
    good = _cases(3)
    img, msk, sp = good[1]
    bad_mask = np.asarray(msk, np.float32).copy()
    bad_mask[10, 9, 8] = np.nan  # poisoned: quarantined at prep
    ref, _ = bx.run(good)
    with bx.serve() as svc:
        res = svc.submit([good[0], (img, bad_mask, sp), good[2]], tenant="mixed").result(
            timeout=WAIT)
        stats = svc.stats()
    assert set(res.errors) == {1} and "poisoned" in res.errors[1]
    assert np.isnan(np.asarray(res.rows[1])).all()
    assert not res.ok
    assert stats["quarantined_cases"] == 1
    np.testing.assert_array_equal(np.asarray(res.rows[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(res.rows[2]), np.asarray(ref[2]))


def test_mixed_traffic_stream_equals_reference():
    ours = list(mixed_traffic_stream(7, seed=3, huge_every=3, huge_dims=(40, 40, 40)))
    theirs = list(jax_synth.mixed_traffic_stream(7, seed=3, huge_every=3,
                                                 huge_dims=(40, 40, 40)))
    assert [n for n, *_ in ours] == [n for n, *_ in theirs]
    assert [n.startswith("huge") for n, *_ in ours] == [i % 3 == 2 for i in range(7)]
    assert ours[2][1].shape == (40, 40, 40) and ours[0][1].shape != (40, 40, 40)
    for a, b in zip(ours, theirs):
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    assert not any(n.startswith("huge") for n, *_ in mixed_traffic_stream(5, huge_every=0))


# -- the driver ---------------------------------------------------------------------------------

def test_service_driver_survives_and_reports_on_close():
    svc = ExtractionService(BatchedExtractor(device="cpu"))
    assert svc.submit_case(_cases(1)[0]).result(timeout=WAIT).ok
    svc.close(timeout=WAIT)
    svc.close(timeout=WAIT)  # idempotent
    with pytest.raises(ServiceClosed):
        svc.submit_case(_cases(1)[0])


@pytest.mark.parametrize("where", ["submit", "prep"])
def test_launch_runtime_error_reaches_close_and_submit(monkeypatch, where):
    """A RuntimeError from a launch (a CUDA error on the card), in a
    window's submit or in a case's prep, is the service's failure: its
    requests fail, ``close()`` and the next ``submit()`` raise it; it never
    becomes quietly accepted rows, nor a quarantined case."""
    bx = BatchedExtractor(device="cpu")
    cases = _cases(2)
    msg = "CUDA error: an illegal memory access was encountered"
    boom = RuntimeError(msg) if where == "submit" else torch.AcceleratorError(msg)

    def launch(*a, **k):
        raise boom

    monkeypatch.setattr(ops, "mc_volume_area_batch" if where == "submit" else "vertex_fields",
                        launch)
    if where == "prep":  # the executor alone raises it too
        with pytest.raises(torch.AcceleratorError, match="illegal memory access"):
            bx.run(cases)
    svc = bx.serve()
    res = svc.submit(cases, tenant="a").result(timeout=WAIT)
    assert set(res.errors) == {0, 1}
    assert all("ServiceFailed" in e and "illegal memory access" in e
               for e in res.errors.values())
    assert all(np.isnan(np.asarray(r)).all() for r in res.rows)
    with pytest.raises(ServiceError, match="illegal memory access") as exc:
        svc.close(timeout=WAIT)
    assert exc.value.__cause__ is boom
    with pytest.raises(ServiceClosed, match="driver failed"):
        svc.submit(cases, tenant="b")


def test_python_error_in_collect_fails_only_its_window(monkeypatch):
    """A Python-level failure while collecting a window becomes that
    window's error rows; the service keeps serving."""
    bx = BatchedExtractor(device="cpu")
    cases = _cases(2)
    collect = bx.executor.collect_window
    calls = []

    def flaky(window):
        calls.append(1)
        if len(calls) == 1:
            raise ValueError("bad window")
        return collect(window)

    monkeypatch.setattr(bx.executor, "collect_window", flaky)
    with bx.serve() as svc:
        first = svc.submit([cases[0]]).result(timeout=WAIT)
        second = svc.submit([cases[1]]).result(timeout=WAIT)
    assert first.errors == {0: "ValueError: bad window"}
    assert second.ok
    np.testing.assert_array_equal(np.asarray(second.rows[0]),
                                  np.asarray(bx.run([cases[1]])[0][0]))


def test_estimate_case_bytes_peeks_loader_nifti_header(tmp_path):
    from repro_torch.data.nifti import read_nifti, write_nifti

    img, msk, sp = _cases(1)[0]
    p = tmp_path / "mask.nii"
    write_nifti(p, np.asarray(msk, np.uint8), sp)

    def loader():
        mask, spacing = read_nifti(loader.path)
        return img, mask.astype(np.float32), spacing

    loader.path = p
    want = estimate_case_bytes((img, msk, sp))
    assert estimate_case_bytes(loader) == want == jax_service.estimate_case_bytes(loader)
    assert estimate_case_bytes(loader, needs_intensity=True) > want
    part = functools.partial(lambda nifti_path: None, nifti_path=p)
    assert estimate_case_bytes(part) == want
    broken = lambda: None  # noqa: E731
    broken.path = tmp_path / "nope.nii"
    assert estimate_case_bytes(broken) == DEFAULT_LOADER_CASE_BYTES
    # the loader itself serves like the tuple it reads
    bx = BatchedExtractor(device="cpu")
    with bx.serve() as svc:
        res = svc.submit([loader]).result(timeout=WAIT)
    np.testing.assert_array_equal(np.asarray(res.rows[0]), bx.run([(img, msk, sp)])[0][0])
    assert svcmod._peek_loader_shape(loader)[0] == msk.shape


def _serve_clients_example():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "serve_clients_torch.py"
    spec = importlib.util.spec_from_file_location("serve_clients_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def test_serve_clients_example_on_cpu(capsys):
    got = _serve_clients_example().main(["--device", "cpu", "--viewer-cases", "3",
                                         "--cohort-cases", "4", "--cohort-batch", "2"])
    out = capsys.readouterr().out
    assert (got["viewer_rows"], got["cohort_rows"], got["cohort_errors"]) == (3, 4, 0)
    assert got["served_cases"] + got["expired_cases"] == 7
    assert out.count("[viewer] case") == 3 and out.count("[cohort] batch") == 2
    assert "parity OK" in out


def test_serve_clients_example_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _serve_clients_example().main([])
