"""The port's data-parallel path on the CPU: ``mesh=`` over N CPU slots.

Counterparts of the reference's ``tests/test_pipeline_multidevice.py``,
which shards the two-pass pipeline over 8 forced host devices: a port
``parallel/sharding.Mesh`` may repeat a device, so N slots of ``'cpu'``
run the same split, launch and gather as N cards.  Meshes of 8 slots and
of 3 (so every chunk is padded), given directly and through the ambient
``use_mesh``, on the (18, 16, 14) cases with an empty one:

* rows bitwise equal to the unsharded port run under counted/static x
  count/hint, shape-only and with all three families, with
  ``data_parallel == N``, the same ``empty_cases`` and the same host-fetch
  census;
* rows at rtol 1e-4 against the JAX package's unsharded
  ``BatchedExtractor(backend='ref')`` (the tolerance the reference holds
  between its own backends, ``tests/test_shape_features.py:44``), the
  vertex count exactly;
* ``extract_stream`` (fixed and ``'auto'``), ``.serve()``,
  ``ResilientRunner``, ``resubmit_window`` and the collect-time re-sweeps
  over a mesh give the unsharded rows bitwise;
* ``pad_batch``, ``data_parallel_map``, ``make_host_mesh`` and
  ``surviving_mesh`` by themselves, and the refusals: no fallback.

Whether a card is present is decided inside the tests that need to know.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import BatchedExtractor as JaxBatchedExtractor  # noqa: E402
from repro_torch.core import executor as exmod  # noqa: E402
from repro_torch.core import plan as planlib  # noqa: E402
from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.tiles import TiledCase  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import Mesh, use_mesh  # noqa: E402
from repro_torch.runtime.fault_tolerance import surviving_mesh  # noqa: E402
from repro_torch.runtime.resilience import ResilientRunner, RetryPolicy, RunManifest  # noqa: E402

FAMS = ("shape", "firstorder", "glcm")
COMBOS = [(s, p) for s in ("counted", "static") for p in ("count", "hint")]
SLOTS = [3, 8]


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
def _cases():
    """The reference test's cases: three (18, 16, 14) cases and an empty one."""
    cases = [synthetic.make_case((18, 16, 14), seed=s) for s in (1, 2, 3)]
    z = np.zeros((8, 8, 8), np.float32)
    cases.append((z, z.copy(), (1.0, 1.0, 1.0)))
    return tuple(cases)


@functools.lru_cache(maxsize=None)
def _big_cases():
    """Cases that prune to a smaller bucket, sit in the floor-cap group or
    re-sweep at collect: the collect-time launches' feed."""
    return (synthetic.make_case((48, 48, 48), seed=1), synthetic.make_case((20, 18, 16), seed=5),
            *_cases()[:2])


def _cpu_mesh(n, axes=("data",)):
    return Mesh(["cpu"] * n, axes)


def _stack(rows):
    return np.stack([np.asarray(r, np.float32) for r in rows])


@functools.lru_cache(maxsize=None)
def _plain(schedule="counted", prep="count", families=None, cases=_cases):
    rows, stats = BatchedExtractor(device="cpu", schedule=schedule, prep=prep,
                                   families=families).run(cases())
    return _stack(rows), stats


# -- rows: bitwise the unsharded port's, close to the JAX package's -------------

@pytest.mark.parametrize("families", [None, FAMS], ids=["shape", "three"])
@pytest.mark.parametrize("schedule,prep", COMBOS)
@pytest.mark.parametrize("n", SLOTS)
def test_sharded_rows_bitwise_equal_unsharded(n, schedule, prep, families):
    want, wstats = _plain(schedule, prep, families)
    mesh = _cpu_mesh(n)
    bx = BatchedExtractor(device="cpu", mesh=mesh, schedule=schedule, prep=prep,
                          families=families)
    assert bx.mesh is mesh and bx.data_axis == "data"
    rows, stats = bx.run(_cases())
    np.testing.assert_array_equal(_stack(rows), want)
    assert stats["data_parallel"] == n and wstats["data_parallel"] == 1
    assert stats["empty_cases"] == wstats["empty_cases"] == 1
    assert stats["host_fetches"] == wstats["host_fetches"]
    assert stats["plan"] == wstats["plan"]
    # each launch gives its real rows to a prefix of the slots, a shard each
    received = mesh.received.ravel()
    assert received[0] > 0 and (np.diff(received) <= 0).all()


@pytest.mark.parametrize("n", SLOTS)
def test_ambient_mesh_is_adopted(n):
    mesh = _cpu_mesh(n)
    with use_mesh(mesh):
        assert sharding.active_mesh() is mesh
        bx = BatchedExtractor(device="cpu")
    assert sharding.active_mesh() is None
    assert bx.mesh is mesh  # picked up from the ambient use_mesh context
    rows, stats = bx.run(_cases())
    np.testing.assert_array_equal(_stack(rows), _plain()[0])
    assert stats["data_parallel"] == n and stats["empty_cases"] == 1


def test_ambient_mesh_without_the_data_axis_is_not_adopted():
    with use_mesh(_cpu_mesh(2, ("model",))):
        bx = BatchedExtractor(device="cpu")
    assert bx.mesh is None
    _, stats = bx.run(_cases()[:1])
    assert stats["data_parallel"] == 1


@pytest.fixture(scope="module")
def _jax_rows():
    rows, stats = JaxBatchedExtractor(backend="ref", families=FAMS).run(_cases())
    return _stack(rows), stats


@pytest.mark.parametrize("n", SLOTS)
def test_sharded_rows_match_jax_unsharded(n, _jax_rows):
    theirs, tstats = _jax_rows
    rows, stats = BatchedExtractor(device="cpu", mesh=_cpu_mesh(n), families=FAMS).run(_cases())
    ours = _stack(rows)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    np.testing.assert_array_equal(ours[:, 6], theirs[:, 6])  # the vertex count
    assert stats["empty_cases"] == tstats["empty_cases"] == 1
    assert stats["host_fetches"] == tstats["host_fetches"]


@pytest.mark.parametrize("kwargs", [{"prune": False}, {"device_compact": False},
                                    {"batch_size": 2}], ids=["one_pass", "host_compact",
                                                             "batch_size"])
def test_baseline_paths_sharded_bitwise(kwargs):
    """The one-pass and host-compaction baselines, and chunks of a
    ``batch_size`` (rounded up to the axis multiple, as in the reference:
    the census is the unsharded run's at chunks of 3)."""
    batch_size = kwargs.pop("batch_size", None)
    want, wstats = BatchedExtractor(device="cpu", families=FAMS, **kwargs).run(
        _cases(), batch_size and 3)
    rows, stats = BatchedExtractor(device="cpu", mesh=_cpu_mesh(3), families=FAMS,
                                   **kwargs).run(_cases(), batch_size)
    np.testing.assert_array_equal(_stack(rows), _stack(want))
    assert stats["host_fetches"] == wstats["host_fetches"]


def test_extract_one_and_tiled_cases_run_on_the_first_device():
    fams = ("shape", "firstorder")
    bx = BatchedExtractor(device="cpu", mesh=_cpu_mesh(3), families=fams)
    img, msk, sp = _cases()[0]
    plain = BatchedExtractor(device="cpu", families=fams)
    np.testing.assert_array_equal(bx.extract_one(img, msk, sp), plain.extract_one(img, msk, sp))
    rows, stats = bx.run([TiledCase(msk, image=img, spacing=sp), *_cases()[1:]])
    assert stats["tiled"]["cases"] == 1 and stats["data_parallel"] == 3
    np.testing.assert_array_equal(_stack(rows), _stack(plain.run(_cases())[0]))


# -- the stream, the service, the runner, the re-submit ------------------------

@pytest.mark.parametrize("window", [2, "auto"])
def test_stream_over_a_mesh_bitwise(window):
    want = _plain("static", "hint", FAMS)[0]
    bx = BatchedExtractor(device="cpu", mesh=_cpu_mesh(3), schedule="static", prep="hint",
                          families=FAMS)
    np.testing.assert_array_equal(_stack(bx.extract_stream(iter(_cases()), window=window)),
                                  want)


def test_serve_over_a_mesh_bitwise():
    want = _plain("static", "hint")[0]
    bx = BatchedExtractor(device="cpu", mesh=_cpu_mesh(3), schedule="static", prep="hint")
    with bx.serve() as svc:
        futs = [svc.submit(list(_cases()[:2]), tenant="a"),
                svc.submit(list(_cases()[2:]), tenant="b")]
        res = [f.result(timeout=120) for f in futs]
    np.testing.assert_array_equal(_stack([r for rr in res for r in rr.rows]), want)


def test_resilient_runner_over_a_mesh_bitwise(tmp_path):
    named = [(f"c{i}", *c) for i, c in enumerate(_big_cases())]

    def records(ext, name):
        with RunManifest(tmp_path / name) as man:
            rep = ResilientRunner(ext, man, window=2).run(named)
            return rep, sorted((r["id"], r["features"]) for r in man.rows())

    rep, got = records(BatchedExtractor(device="cpu", mesh=_cpu_mesh(3), schedule="static",
                                        prep="hint", retry=RetryPolicy()), "mesh.jsonl")
    _, want = records(BatchedExtractor(device="cpu", schedule="static", prep="hint",
                                       retry=RetryPolicy()), "plain.jsonl")
    assert rep.status == "complete" and rep.processed == len(named)
    assert got == want


@pytest.mark.parametrize("schedule,prep", COMBOS)
def test_resubmit_over_a_mesh_collects_like_a_first_submit(schedule, prep):
    want, _ = _plain(schedule, prep, None, _big_cases)
    ex = BatchedExtractor(device="cpu", mesh=_cpu_mesh(3), schedule=schedule,
                          prep=prep).executor
    window = ex.submit_window(_big_cases())
    rows, _ = ex.collect_window(window)
    np.testing.assert_array_equal(_stack(rows), want)
    f0 = dict(ex.transfer_log)
    rows, _ = ex.collect_window(ex.resubmit_window(window))
    np.testing.assert_array_equal(_stack(rows), want)
    again = {k: v - f0.get(k, 0) for k, v in ex.transfer_log.items() if v - f0.get(k, 0)}
    assert again == {k: v for k, v in f0.items() if k != "prep"}


@pytest.mark.parametrize("schedule", ["counted", "static"])
def test_hint_overflow_retry_is_sharded(monkeypatch, schedule):
    """Every hint collapses to the bucket floor: the collect re-sweeps the
    48^3 blob count-sized, through the sharded pass-2b launch, bitwise."""
    cases = _big_cases()[:2]
    want, _ = BatchedExtractor(device="cpu", schedule=schedule).run(cases)
    monkeypatch.setattr(planlib, "vertex_hint", lambda *a, **k: 1)
    mesh = _cpu_mesh(3)
    seen = []
    real = sharding.data_parallel_map
    monkeypatch.setattr(sharding, "data_parallel_map",
                        lambda fn, m, axis: seen.append(m) or real(fn, m, axis))
    ex = BatchedExtractor(device="cpu", mesh=mesh, schedule=schedule, prep="hint").executor
    window = ex.submit_window(cases)
    n_submit = len(seen)
    rows, stats = ex.collect_window(window)
    np.testing.assert_array_equal(_stack(rows), _stack(want))
    assert ex.transfer_log["hint_retry"] >= 1
    assert len(seen) > n_submit and all(m is mesh for m in seen)


@pytest.mark.parametrize("error,retry", [(RuntimeError, None),
                                         (torch.cuda.OutOfMemoryError, 3)],
                         ids=["runtime", "out_of_memory_not_retried"])
def test_failed_slot_launch_raises_through_collect(monkeypatch, error, retry):
    """No fallback: a slot's launch that fails at collect (the hint
    retry's sweep, on the first slot, the only one its batch of one fills)
    raises out of ``collect_window``; an error of the card is raised at
    once, however many retries the policy allows."""
    monkeypatch.setattr(planlib, "vertex_hint", lambda *a, **k: 1)
    policy = None if retry is None else RetryPolicy(max_retries=retry, base_delay=0.0)
    ex = BatchedExtractor(device="cpu", mesh=_cpu_mesh(3), prep="hint", retry=policy).executor
    window = ex.submit_window(_big_cases()[:1])
    real, calls = exmod.ops.max_diameters_batch, []

    def flaky(*a, **k):
        calls.append(1)
        raise error("slot launch failed")

    monkeypatch.setattr(exmod.ops, "max_diameters_batch", flaky)
    with pytest.raises(error, match="slot launch failed"):
        ex.collect_window(window)
    assert len(calls) == 1 and ex.window_retries == 0


# -- the mesh helpers ------------------------------------------------------------

def test_pad_batch_copies_row_zero_and_is_a_no_op_without_a_mesh():
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    h = np.arange(8).reshape(4, 2)
    assert sharding.pad_batch((x, h), 4) == (x, h)
    px, ph = sharding.pad_batch((x, h), 4, _cpu_mesh(3))
    assert px.shape == (6, 3) and ph.shape == (6, 2)
    assert torch.equal(px[:4], x) and torch.equal(px[4:], x[:1].expand(2, 3))
    np.testing.assert_array_equal(ph, np.concatenate([h, h[:1], h[:1]]))
    assert sharding.pad_batch((x,), 4, _cpu_mesh(2, ("model",)))[0] is x
    assert sharding.pad_batch((x,), 4, _cpu_mesh(4))[0] is x


@pytest.mark.parametrize("n", [1, 2, 4])
def test_data_parallel_map_equals_the_plain_call(n):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
    s = rng.normal(size=(8, 2)).astype(np.float32)

    def fn(x, s):
        return x.sum(1, keepdim=True) * torch.from_numpy(s), (x > 0).sum(1)

    mesh = _cpu_mesh(n)
    got = sharding.data_parallel_map(fn, mesh)(x, s)
    want = fn(x, s)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sharding.data_parallel_map(lambda x: x * 2, mesh)(x).equal(x * 2)
    assert mesh.received.tolist() == [(2 * x.nbytes + s.nbytes) // n] * n


@pytest.mark.parametrize("rows,used", [(1, 1), (4, 2), (5, 3), (6, 3)])
def test_data_parallel_map_launches_only_the_slots_with_real_rows(rows, used):
    """Six padded rows on three slots: a slot whose shard holds only
    padding (rows at or past ``rows``) is not launched, and the output
    stops after the last launched shard."""
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    mesh, shards = _cpu_mesh(3), []

    def fn(x):
        shards.append(len(x))
        return x * 2

    got = sharding.data_parallel_map(fn, mesh)(x, rows=rows)
    assert shards == [2] * used and torch.equal(got, x[:2 * used] * 2)
    assert mesh.received.tolist() == [x[:2].nbytes] * used + [0] * (3 - used)


def test_data_parallel_map_raises_the_error_of_any_slot():
    def fn(x):
        if x[0] >= 2:  # the second slot's shard
            raise RuntimeError("slot launch failed")
        return x

    with pytest.raises(RuntimeError, match="slot launch failed"):
        sharding.data_parallel_map(fn, _cpu_mesh(3))(torch.arange(6))


def test_data_parallel_map_without_a_mesh_or_axis_is_the_plain_function():
    def fn(x):
        return x

    assert sharding.data_parallel_map(fn) is fn
    assert sharding.data_parallel_map(fn, _cpu_mesh(2, ("model",))) is fn
    with use_mesh(_cpu_mesh(2)):
        assert sharding.data_parallel_map(fn) is not fn
    with pytest.raises(ValueError, match="multiple"):
        sharding.data_parallel_map(fn, _cpu_mesh(3))(torch.zeros(4))
    with pytest.raises(ValueError, match="one length"):
        sharding.data_parallel_map(lambda a, b: a, _cpu_mesh(2))(torch.zeros(4), torch.zeros(2))


def test_mesh_shape_slots_and_axis_size():
    mesh = Mesh(np.array([["cpu"] * 2] * 3, dtype=object), ("data", "model"))
    assert mesh.shape == {"data": 3, "model": 2} and mesh.devices.shape == (3, 2)
    assert mesh.slots("data") == [(0, 0), (1, 0), (2, 0)]
    assert mesh.slots("model") == [(0, 0), (0, 1)]
    assert mesh.home == torch.device("cpu")
    assert sharding.axis_size(mesh) == 3 and sharding.axis_size(mesh, "model") == 2
    assert sharding.axis_size(None) == 1 and sharding.axis_size(mesh, "pod") == 1
    assert "data" in repr(mesh)


def _grid(shape):
    arr = np.empty(int(np.prod(shape)), dtype=object)
    arr[:] = [torch.device("cpu")] * arr.size
    return arr.reshape(shape)


@pytest.mark.parametrize("devices,axes", [(_grid((2,)), ("data", "model")),
                                          (_grid((0,)), ("data",)),
                                          (_grid((1, 1)), ("data", "data")),
                                          (["cpu", "meta"], ("data",))],
                         ids=["rank", "empty", "repeated_axis", "not_a_slot"])
def test_malformed_meshes_raise(devices, axes):
    with pytest.raises(ValueError):
        Mesh(devices, axes)


def test_make_host_mesh_on_cpu_slots():
    mesh = make_host_mesh(device="cpu", slots=8)
    assert mesh.shape == {"data": 8, "model": 1}
    assert make_host_mesh(2, device="cpu", slots=8).shape == {"data": 4, "model": 2}
    assert make_host_mesh(device="cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        make_host_mesh(3, device="cpu", slots=8)
    bx = BatchedExtractor(device="cpu", mesh=mesh)
    _, stats = bx.run(_cases()[:2])
    assert stats["data_parallel"] == 8


@pytest.mark.parametrize("n,mp,shape", [(5, 2, (2, 2)), (5, 1, (5, 1)), (3, 3, (1, 3))])
def test_surviving_mesh_drops_trailing_devices(n, mp, shape):
    survivors = [torch.device("cpu")] * n
    mesh = surviving_mesh(model_parallel=mp, devices=survivors)
    assert mesh.devices.shape == shape and mesh.shape == dict(zip(("data", "model"), shape))
    with pytest.raises(ValueError):
        surviving_mesh(model_parallel=n + 1, devices=survivors)


def test_cuda_meshes_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mesh(["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        surviving_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedExtractor(device="cuda", mesh=_cpu_mesh(2))


def test_mesh_refusals():
    with pytest.raises(TypeError, match="Mesh"):
        BatchedExtractor(device="cpu", mesh=object())
