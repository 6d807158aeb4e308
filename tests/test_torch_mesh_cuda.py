"""The data-parallel path on the card: ``mesh=`` over CUDA slots.

* a mesh of four slots of one card (each with a stream of its own) gives
  the unsharded run's rows, errors and host-fetch census bitwise under
  every schedule x prep with the three families, its kernels launched
  once for each slot a launch's rows fill (between one and four times as
  often as unsharded);
* a static/hint submit over that mesh makes no host sync
  (``PlanExecutor.strict_syncs``), and its collect gives the same rows;
* ``data_parallel_map`` queues each shard on its slot's stream and
  gathers on the first device;
* the slots' work overlaps: four slots of one card, and every card where
  there are two or more, each spinning, take well under four (N) spins;
* with two cards or more, ``make_host_mesh()`` and ``surviving_mesh()``
  over every card give the same rows, with the shards' peer copies.

Skipped without a CUDA device (the multi-card cases below two): the
fixtures decide, not the import.  Run on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_mesh_cuda.py``.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import compact, diameter, firstorder, glcm  # noqa: E402
from repro_torch.kernels import marching_cubes, masked_range, prune  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import Mesh  # noqa: E402
from repro_torch.runtime.fault_tolerance import surviving_mesh  # noqa: E402

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
    return torch.device("cuda", 0)


@pytest.fixture
def cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    return torch.cuda.device_count()


def _cases():
    cases = [synthetic.make_case(s, seed=seed) for s, seed in SHAPES]
    z = np.zeros((10, 10, 10), np.float32)
    cases.insert(2, (z, z.copy(), (1.0, 1.0, 1.0)))
    return cases


def _launches():
    return {"mc": marching_cubes.LAUNCHES, "diameter": sum(diameter.LAUNCHES.values()),
            "compact": compact.LAUNCHES, "firstorder": firstorder.LAUNCHES,
            "glcm": glcm.LAUNCHES, "masked_range": masked_range.LAUNCHES}


def _counted_run(ext, cases):
    before = _launches()
    rows, stats = ext.run(cases)
    return np.stack(rows), stats, {k: v - before[k] for k, v in _launches().items()}


@pytest.mark.parametrize("schedule,prep", COMBOS)
def test_four_slots_of_one_card_bitwise(dev, schedule, prep):
    cases = _cases()
    plain = BatchedExtractor(families=FAMS, schedule=schedule, prep=prep)
    plain.run(cases)  # first use: the libraries load, the tuner sweeps
    want, wstats, wl = _counted_run(plain, cases)
    mesh = Mesh([dev] * 4)
    bx = BatchedExtractor(mesh=mesh, families=FAMS, schedule=schedule, prep=prep)
    bx.run(cases)  # the shard depths' tuner keys
    rows, stats, launches = _counted_run(bx, cases)
    np.testing.assert_array_equal(rows, want)
    assert stats["data_parallel"] == 4 and stats["errors"] == wstats["errors"]
    assert stats["host_fetches"] == wstats["host_fetches"]
    assert all(wl.values()) and sum(launches.values()) > sum(wl.values())
    assert all(wl[k] <= launches[k] <= 4 * wl[k] for k in wl), (launches, wl)
    streams = list(mesh._streams.values())
    assert len(streams) == 4 and len({s.cuda_stream for s in streams}) == 4
    assert torch.cuda.default_stream(dev).cuda_stream not in {s.cuda_stream for s in streams}


def test_static_hint_submit_over_a_mesh_makes_no_sync(dev):
    cases = _cases()
    want, _ = BatchedExtractor(families=FAMS).run(cases)
    ex = BatchedExtractor(mesh=Mesh([dev] * 4), families=FAMS, schedule="static",
                          prep="hint").executor
    ex.collect_window(ex.submit_window(cases))  # first use: streams, tuner keys
    f0 = dict(ex.transfer_log)
    with ex.strict_syncs():
        window = ex.submit_window(cases)
    assert dict(ex.transfer_log) == f0
    rows, _ = ex.collect_window(window)
    np.testing.assert_array_equal(np.stack(rows), np.stack(want))


def test_data_parallel_map_queues_each_shard_on_its_slot_stream(dev):
    mesh = Mesh([dev] * 4)
    x = torch.randn(8, 4096, device=dev)
    seen = []

    def fn(x):
        seen.append(torch.cuda.current_stream(x.device).cuda_stream)
        torch.cuda._sleep(1_000_000)  # slot work still queued when the gather is
        return x.cumsum(1), x.amax(1)

    got = sharding.data_parallel_map(fn, mesh)(x)
    want = (x.cumsum(1), x.amax(1))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(g.device == dev for g in got)
    assert seen == [mesh.stream((k,)).cuda_stream for k in range(4)]
    assert mesh.received.tolist() == [x.nbytes // 4] * 4


def test_a_cached_constant_made_on_one_slot_is_ready_on_the_others(dev):
    """The first slot to need a cached device constant (a diameter tile
    schedule, the pruning bound's directions) queues its copy on its own
    stream, behind a spin here; the other slots, which find it cached, wait
    for that copy (``dispatcher.await_shared``) and give the unsharded bits."""
    nb, block, k_dirs = 37, 128, 13  # a schedule size and a k no other test uses
    diameter._SCHEDULES.pop((nb, dev), None)
    prune._constant_tensors.cache_clear()
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.normal(size=(4, nb * block, 3)).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.random((4, nb * block)) < 0.9).to(dev)
    calls = []

    def fn(v, m):
        if not calls:
            torch.cuda._sleep(200_000_000)  # the first slot's copies queue behind this
        calls.append(1)
        keep, _ = prune.keep_mask_batch(v, m, k_dirs)
        return keep, diameter.max_diameters_sq_batch(v, m, block=block, variant="nomask")

    keep, d = sharding.data_parallel_map(fn, Mesh([dev] * 4))(v, m)
    assert torch.equal(keep, prune.keep_mask_batch(v, m, k_dirs)[0])
    assert torch.equal(d, diameter.max_diameters_sq_batch(v, m, block=block, variant="nomask"))


SPIN_CYCLES = 100_000_000  # about 50 ms of one thread at the card's clock


def _spin_seconds(mesh):
    """Wall seconds of one ``data_parallel_map`` over ``mesh`` whose every
    shard spins ``SPIN_CYCLES`` on its slot's stream; the shards of a
    mesh over several cards are peer copies, there and back."""
    x = torch.arange(mesh.shape["data"] * 1024, dtype=torch.float32, device=mesh.home)

    def fn(x):
        torch.cuda._sleep(SPIN_CYCLES)
        return x * 2

    f = sharding.data_parallel_map(fn, mesh)
    assert torch.equal(f(x), x * 2)  # first use: the streams, peer access
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f(x)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


@pytest.mark.parametrize("which", ["one_card", "every_card"])
def test_slots_overlap(dev, which):
    """The slots' spins run at once: queued one after another they would
    take N spins, and N slots finish in well under (N + 1) / 2 of them."""
    if which == "every_card":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two CUDA devices or more")
        mesh = make_host_mesh()
    else:
        mesh = Mesh([dev] * 4)
    n = mesh.shape["data"]
    one = _spin_seconds(Mesh([dev]))
    wall = _spin_seconds(mesh)
    assert wall < 0.5 * (n + 1) * one, (n, wall, one)


def test_every_card_bitwise(cards):
    cases = _cases()
    want, wstats = BatchedExtractor(families=FAMS).run(cases)
    for mesh in (make_host_mesh(), surviving_mesh()):
        assert mesh.shape == {"data": cards, "model": 1}
        bx = BatchedExtractor(mesh=mesh, families=FAMS)
        rows, stats = bx.run(cases)
        np.testing.assert_array_equal(np.stack(rows), np.stack(want))
        assert stats["data_parallel"] == cards
        assert stats["host_fetches"] == wstats["host_fetches"]
        assert [d.index for d in mesh.devices.ravel()] == list(range(cards))
        received = mesh.received.ravel()
        assert received[0] > 0 and (np.diff(received) <= 0).all()


def test_every_card_static_hint_submit_makes_no_sync(cards):
    cases = _cases()
    want, _ = BatchedExtractor(families=FAMS, schedule="static", prep="hint").run(cases)
    ex = BatchedExtractor(mesh=make_host_mesh(), families=FAMS, schedule="static",
                          prep="hint").executor
    ex.collect_window(ex.submit_window(cases))
    with ex.strict_syncs():
        window = ex.submit_window(cases)
    rows, _ = ex.collect_window(window)
    np.testing.assert_array_equal(np.stack(rows), np.stack(want))
