"""The batched pipeline's CUDA kernels on the card: each against its plain
version or each case alone, and the batched extractor end to end.

Skipped without a CUDA device (a CUDA kernel has no CPU mode).  Run on an
H100 with ``PYTHONPATH=src python -m pytest -q tests/test_torch_batched_cuda.py``.
Compaction copies input bits, so kernel == plain bitwise.  The single-case
MC and diameter entries are the batched launches with a batch of one; a
case runs the same arithmetic in the same order alone or in a stack (MC:
the same grid per case; diameter: max is order-free), so batched == single
bitwise; batched MC == plain at rtol 1e-5, as for the single-case call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import compact, diameter, marching_cubes, ops, prune, ref  # noqa: E402

from conftest import sphere_mask  # noqa: E402

pytestmark = pytest.mark.cuda

PATTERNS = ["random", "zero-survivor", "all-survivor", "cap-boundary", "overflow"]


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


def _keep_for(case: str, m: int, cap: int, rng) -> np.ndarray:
    if case == "random":
        return rng.random(m) < 0.3
    if case == "zero-survivor":
        return np.zeros(m, bool)
    if case == "all-survivor":
        return np.ones(m, bool)
    keep = np.zeros(m, bool)
    keep[rng.choice(m, size=cap if case == "cap-boundary" else cap + 57, replace=False)] = True
    return keep


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("m", [512, 4096, 131072])
def test_compact_kernel_bitwise_equals_plain(dev, pattern, batch, m):
    cap = m // 2
    rng = np.random.default_rng(m + batch)
    verts = torch.from_numpy((rng.normal(size=(batch, m, 3)) * 20.0).astype(np.float32)).to(dev)
    keep = torch.from_numpy(np.stack([_keep_for(pattern, m, cap, rng)
                                      for _ in range(batch)])).to(dev)
    before = compact.LAUNCHES
    got = compact.compact_batch(verts, keep, cap)
    torch.cuda.synchronize()
    assert compact.LAUNCHES == before + 1
    want = ref.compact_batch(verts, keep, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


TILES = [512, 1024, 2048, 4096, 8192, 16384]  # every tile a multiple of 512 up to 1024 threads


def _compact_cases(dev):
    """Stacks the tile decomposition must handle: (label, verts, keep, cap)."""
    rng = np.random.default_rng(11)

    def stack(batch, m, frac):
        verts = torch.from_numpy((rng.normal(size=(batch, m, 3)) * 20.0)
                                 .astype(np.float32)).to(dev)
        return verts, torch.from_numpy(rng.random((batch, m)) < frac).to(dev)

    v, k = stack(16, 131072, 0.3)
    yield "B=16 M=131072", v, k, 8192
    v, k = stack(64, 37, 0.5)  # small lists, rows not 16-byte aligned
    yield "B=64 M=37", v, k, 16
    v, k = stack(3, 4099, 0.4)
    yield "n=0", v, torch.zeros_like(k), 512
    yield "n > cap", v, k, 100
    yield "cap > M", v, k, 5000
    v, k = stack(5, 65536, 0.06)  # the cohort's largest launch
    yield "B=5 M=65536", v, k, 1024


@pytest.mark.parametrize("tile", TILES)
def test_compact_kernel_bitwise_at_every_tile(dev, tile):
    """Bitwise the plain version at every tile, and each case alone."""
    for label, verts, keep, cap in _compact_cases(dev):
        got = compact.compact_batch(verts, keep, cap, block=tile)
        want = ref.compact_batch(verts, keep, cap)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (label, tile)
        for b in (0, len(verts) - 1):
            one = compact.compact_batch(verts[b:b + 1], keep[b:b + 1], cap, block=tile)
            assert all(torch.equal(o[0], g[b]) for o, g in zip(one, got)), (label, tile, b)


def test_compact_launch_floor_and_refusals(dev):
    floor = compact.launch_floor(5, 65536)
    before = compact.LAUNCHES
    floor()
    torch.cuda.synchronize()
    assert compact.LAUNCHES == before  # the floor is no launch of the kernel
    verts = torch.zeros((2, 64, 3), device=dev)
    keep = torch.ones((2, 64), dtype=torch.bool, device=dev)
    for bad in (256, 1000, 32768):
        with pytest.raises(ValueError, match="block"):
            compact.compact_batch(verts, keep, 8, block=bad)


def _volumes(dev):
    rng = np.random.default_rng(1)
    vols = [np.pad(sphere_mask(30, 12.0), 1),
            np.pad((rng.random((30, 30, 30)) < 0.5).astype(np.float32), 1),
            np.pad(synthetic.make_case((40, 34, 32), seed=5)[1][4:34, 2:32, 1:31]
                   .astype(np.float32), 1)]
    spacings = np.array([[1.0, 1.0, 1.0], [2.0, 1.0, 0.5], [0.8, 0.8, 3.0]], np.float32)
    return torch.from_numpy(np.stack(vols)).to(dev), spacings


@pytest.mark.parametrize("block", [128, 256])
def test_mc_batch_kernel_bitwise_equals_single(dev, block):
    vols, spacings = _volumes(dev)
    before = marching_cubes.LAUNCHES
    got = marching_cubes.mc_volume_area_batch(vols, 0.5, spacings, block=block)
    torch.cuda.synchronize()
    assert marching_cubes.LAUNCHES == before + 1
    plain = ref.mc_volume_area_batch(vols, 0.5, spacings)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(), rtol=1e-5)
    for b in range(len(vols)):
        v, a = marching_cubes.mc_volume_area(vols[b].contiguous(), 0.5, spacings[b], block=block)
        assert torch.equal(got[b], torch.stack([v, a]))


@pytest.mark.parametrize("block", [128, 256])
def test_diameter_batch_kernel_bitwise_equals_single(dev, block):
    rng = np.random.default_rng(4)
    m = 1000
    verts = torch.from_numpy((rng.normal(size=(5, m, 3)) * 50 + 200).astype(np.float32)).to(dev)
    masks = torch.from_numpy(rng.random((5, m)) < 0.7).to(dev)
    masks[:, m // 2] = True
    masks[4, :] = False
    masks[4, 3] = True  # one valid vertex: all maxima 0
    before = diameter.LAUNCHES["seqacc"]
    got = diameter.max_diameters_sq_batch(verts, masks, block=block)
    torch.cuda.synchronize()
    assert diameter.LAUNCHES["seqacc"] == before + 1
    assert torch.equal(got, ref.max_diameters_sq_batch(verts, masks, block))
    for b in range(len(verts)):
        assert torch.equal(got[b], diameter.max_diameters_sq(verts[b], masks[b], block=block))


def test_keep_mask_batch_equals_single_case_on_card(dev):
    rng = np.random.default_rng(2)
    verts = torch.from_numpy((rng.normal(size=(4, 4096, 3)) * [30.0, 12.0, 5.0])
                             .astype(np.float32)).to(dev)
    masks = torch.from_numpy(rng.random((4, 4096)) < 0.9).to(dev)
    keep, lower = prune.keep_mask_batch(verts, masks)
    for b in range(len(verts)):
        k1, l1 = prune.candidate_keep_mask(verts[b], masks[b])
        assert torch.equal(keep[b], k1) and torch.equal(lower[b], l1)


def test_new_wrappers_launch_their_kernels(dev, monkeypatch):
    """A CUDA tensor given to each batched entry launches its kernel, never
    the plain version: the launch counter moves on every call.  No autotune
    sweep runs (it would launch the kernels too)."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    counters = [lambda: compact.LAUNCHES, lambda: marching_cubes.LAUNCHES,
                lambda: diameter.LAUNCHES["seqacc"]]
    before = [count() for count in counters]
    verts = torch.randn((2, 512, 3), device=dev)
    keep = torch.rand((2, 512), device=dev) < 0.5
    ops.compact_survivors_batch(verts, keep, 512, device=dev)
    ops.mc_volume_area_batch(torch.ones((2, 4, 4, 4), device=dev), 0.5, device=dev)
    ops.max_diameters_batch(verts, keep | True, device=dev)
    torch.cuda.synchronize()
    after = [count() for count in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    with pytest.raises(ValueError):
        marching_cubes.mc_volume_area_batch(torch.ones((2, 4, 4, 4), device=dev), 0.5,
                                            torch.ones((2, 3), device=dev))
    with pytest.raises(ValueError):
        compact.compact_batch(verts, keep.cpu(), 512)


def test_batched_extractor_on_card_equals_extract_one(dev):
    cases = [synthetic.make_case(s, seed=seed) for s, seed in
             [((24, 20, 16), 1), ((28, 22, 18), 2), ((50, 24, 20), 2), ((52, 28, 22), 4)]]
    before = (compact.LAUNCHES, marching_cubes.LAUNCHES, sum(diameter.LAUNCHES.values()))
    ext = BatchedExtractor()
    rows, stats = ext.run(cases)
    after = (compact.LAUNCHES, marching_cubes.LAUNCHES, sum(diameter.LAUNCHES.values()))
    assert all(a > b for a, b in zip(after, before)), (before, after)
    for case, row in zip(cases, rows):
        np.testing.assert_array_equal(ext.extract_one(*case), row)
    cpu_rows, cpu_stats = BatchedExtractor(device="cpu").run(cases)
    np.testing.assert_allclose(np.stack(rows)[:, :6], np.stack(cpu_rows)[:, :6], rtol=1e-4)
    np.testing.assert_array_equal(np.stack(rows)[:, 6], np.stack(cpu_rows)[:, 6])
    assert stats["host_fetches"] == cpu_stats["host_fetches"]


@pytest.mark.parametrize("prune", [True, False])
def test_submit_window_syncs_only_in_fetch(dev, prune):
    """Under CUDA sync debugging, a window's submit and collect raise on any
    host sync but the counted fetches: ``transfer_log`` is the census."""
    cases = [synthetic.make_case(s, seed=seed) for s, seed in
             [((24, 20, 16), 1), ((28, 22, 18), 2), ((50, 24, 20), 2), ((52, 28, 22), 4)]]
    ext = BatchedExtractor(prune=prune)
    want, stats = ext.run(cases)  # first use: kernel builds, pinned buffers, caches
    ex = ext.executor
    fetches0 = dict(ex.transfer_log)
    with ex.strict_syncs():
        window = ex.submit_window(cases)
        rows, strict_stats = ex.collect_window(window)
    assert not strict_stats["errors"]  # a sync in prep would quarantine its case
    np.testing.assert_array_equal(np.stack(rows), np.stack(want))
    census = {k: v - fetches0.get(k, 0) for k, v in ex.transfer_log.items()
              if v - fetches0.get(k, 0)}
    assert census == stats["host_fetches"]
