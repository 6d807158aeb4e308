"""The port's batched two-pass extractor on the CPU vs the JAX package's.

``BatchedExtractor(device='cpu')`` runs the plain versions of the three
batched kernels (compaction, marching cubes, diameter).  Against JAX
``BatchedExtractor(backend='ref')`` on the same cases: float columns at
rtol 1e-4 (the tolerance the reference holds between its own backends),
the vertex count, the pruning counts, the plan stats and the per-stage
host-fetch census exactly.  Within the port, batching, the compaction
path and the chunk size never change a row: bitwise.  The kernels' plain
versions are held against the reference's (compaction exactly, MC at the
reference's own MC tolerance, ``tests/test_kernels_mc.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import BatchedExtractor as JaxBatchedExtractor  # noqa: E402
from repro.kernels import compact as jax_compact  # noqa: E402
from repro.kernels import marching_cubes as jax_mc  # noqa: E402
from repro.kernels import prune as jax_prune  # noqa: E402
from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ops, prune, ref  # noqa: E402
from repro_torch.parallel.sharding import Mesh  # noqa: E402
from repro_torch.runtime.resilience import RetryPolicy  # noqa: E402

from conftest import sphere_mask  # noqa: E402

# two shape buckets ((32, 32, 32) and (64, 32, 32)), isotropic and not
SHAPES = [
    ((24, 20, 16), 1, (1.0, 1.0, 1.0)),
    ((28, 22, 18), 2, (1.0, 1.0, 1.0)),
    ((40, 36, 30), 4, (0.8, 0.8, 2.0)),
    ((50, 24, 20), 2, (1.0, 1.0, 1.0)),
    ((52, 28, 22), 4, (2.0, 1.0, 0.5)),
]
EMPTY, POISONED = len(SHAPES), len(SHAPES) + 1
KINDS = {"default": {}, "host_compact": {"device_compact": False}, "one_pass": {"prune": False}}
STAT_KEYS = ["pruned_cases", "vertex_buckets", "buckets", "empty_cases",
             "quarantined_cases", "errors", "mean_keep_fraction", "plan", "host_fetches",
             "two_pass", "device_compact", "schedule", "prep", "cases"]


@pytest.fixture(autouse=True)
def _isolated_autotune(tmp_path, monkeypatch):
    # the reference's parity must not depend on (or pollute) an autotune cache
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
    cases = [synthetic.make_case(s, seed=seed, spacing=sp) for s, seed, sp in SHAPES]
    img, m, sp = cases[0]
    cases.append((img, np.zeros_like(m), sp))  # empty mask: a zero row
    poisoned = cases[1][1].astype(np.float32)
    poisoned[3, 3, 3] = np.nan
    cases.append((cases[1][0], poisoned, cases[1][2]))  # a NaN row + an error
    return tuple(cases)


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    rows, stats = JaxBatchedExtractor(backend="ref", **KINDS[kind]).run(_cases())
    return np.stack([np.asarray(r, np.float32) for r in rows]), stats


@functools.lru_cache(maxsize=None)
def _port_run(kind, batch_size=None):
    rows, stats = BatchedExtractor(device="cpu", **KINDS[kind]).run(_cases(), batch_size)
    return np.stack(rows), stats


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_rows_match_jax(kind):
    ours, _ = _port_run(kind)
    theirs, _ = _jax_run(kind)
    assert ours.dtype == np.float32 and ours.shape == (len(_cases()), 7)
    np.testing.assert_allclose(ours[:, :6], theirs[:, :6], rtol=1e-4)
    np.testing.assert_array_equal(ours[:, 6], theirs[:, 6])  # n_vertices, NaN row too
    assert not ours[EMPTY].any()
    assert np.isnan(ours[POISONED]).all()
    assert np.isfinite(ours[:EMPTY]).all() and (ours[:EMPTY, :6] > 0).all()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stats_match_jax(kind):
    _, ours = _port_run(kind)
    _, theirs = _jax_run(kind)
    for key in STAT_KEYS:
        assert ours[key] == theirs[key], key
    if kind == "default":  # one count fetch per non-empty case, one per cap group
        assert ours["host_fetches"]["prep"] == len(SHAPES)
        assert ours["host_fetches"]["pass1"] == ours["plan"]["cap_buckets"]
        assert ours["pruned_cases"] > 0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_run_equals_extract_one_bitwise(kind):
    ext = BatchedExtractor(device="cpu", **KINDS[kind])
    rows, _ = _port_run(kind)
    for i, case in enumerate(_cases()[:POISONED]):
        np.testing.assert_array_equal(ext.extract_one(*case), rows[i])


@pytest.mark.parametrize("kind", ["host_compact", "one_pass"])
def test_baselines_equal_default_bitwise(kind):
    rows, _ = _port_run(kind)
    default, _ = _port_run("default")
    if kind == "one_pass":  # unpruned, hint-sized sweeps: the same diameters
        np.testing.assert_array_equal(rows[:, 2:], default[:, 2:])
    else:
        np.testing.assert_array_equal(rows, default)


def test_batch_size_one_equals_default_bitwise():
    rows, stats = _port_run("default", batch_size=1)
    default, dstats = _port_run("default")
    np.testing.assert_array_equal(rows, default)
    assert stats["host_fetches"]["pass2a"] == len(SHAPES)  # one fetch per chunk
    assert stats["host_fetches"]["pass2b"] == len(SHAPES)
    assert dstats["host_fetches"]["pass2a"] == dstats["buckets"]


def test_window_api_equals_run_bitwise():
    """prep_case + submit_prepped + collect_window, a resubmitted window and
    extract_batch all give run's rows."""
    default, dstats = _port_run("default")
    ex = BatchedExtractor(device="cpu").executor
    prepped = [ex.prep_case(c) for c in _cases()]
    metas = [ex.case_meta(p) for p in prepped]
    assert [m.empty for m in metas] == [False] * len(SHAPES) + [True, True]
    window = ex.submit_prepped(prepped)
    rows, stats = ex.collect_window(window)
    np.testing.assert_array_equal(np.stack(rows), default)
    assert stats["plan"] == dstats["plan"] and stats["errors"] == dstats["errors"]
    rows, _ = ex.collect_window(ex.resubmit_window(window))
    np.testing.assert_array_equal(np.stack(rows), default)
    rows, _ = BatchedExtractor(device="cpu").extract_batch(_cases())
    np.testing.assert_array_equal(np.stack(rows), default)


def test_transfer_callback_sees_every_fetch():
    seen = []
    ext = BatchedExtractor(device="cpu", transfer_callback=lambda stage, x: seen.append(stage))
    _, stats = ext.run(_cases()[:3])
    assert sum(stats["host_fetches"].values()) == len(seen)
    assert ext.executor.transfer_log == dict(stats["host_fetches"])


@pytest.mark.parametrize("kwargs", [
    {"schedule": "auto", "retry": True}, {"schedule": "auto", "prep": "hint"},
    {"schedule": "static"}, {}, {"retry": True},
], ids=["auto-retry", "auto-hint", "static", "plain", "retry"])
def test_mesh_runs_bitwise_as_unsharded(kwargs):
    """``mesh=`` under each combination of options it was once refused
    with: a 3-slot CPU mesh gives the unsharded run's rows, errors and
    host-fetch census bitwise."""
    kwargs = dict(kwargs)
    if kwargs.pop("retry", False):
        kwargs["retry"] = RetryPolicy(max_retries=1, base_delay=0.0)
    want, wstats = BatchedExtractor(device="cpu", **kwargs).run(_cases())
    rows, stats = BatchedExtractor(device="cpu", mesh=Mesh(["cpu"] * 3), **kwargs).run(_cases())
    np.testing.assert_array_equal(np.stack(rows), np.stack(want))
    assert stats["data_parallel"] == 3 and stats["errors"] == wstats["errors"]
    assert stats["host_fetches"] == wstats["host_fetches"]


@pytest.mark.parametrize("families,n_features", [(("shape", "glcm"), 11), ("firstorder", 9)])
def test_family_requests_are_accepted(families, n_features):
    ext = BatchedExtractor(device="cpu", families=families)
    assert ext.n_features == n_features and ext.n_bins == 32


def test_extract_stream_raises_naming_roadmap_item():
    """Both stream windows are ported: ``'auto'`` (the cost model's, ROADMAP
    item 4(b)ii) streams the fixed window's rows; a junk window raises."""
    ext = BatchedExtractor(device="cpu")
    cases = _cases()[:3]
    want, _ = ext.run(cases)
    for a, b in zip(want, ext.extract_stream(iter(cases), window="auto")):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="window must be a positive int or 'auto'"):
        ext.extract_stream(iter(cases), window="adaptive")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedExtractor()


# ---------------------------------------------------------------------------
# the batched kernels' plain versions against the reference
# ---------------------------------------------------------------------------

PATTERNS = ["random", "zero-survivor", "all-survivor", "cap-boundary", "overflow"]


def _keep_for(case: str, m: int, cap: int, rng) -> np.ndarray:
    """The five keep patterns of ``tests/test_pipeline_device_compact.py``."""
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
@pytest.mark.parametrize("batch", [1, 3])
def test_compact_batch_equals_reference_exactly(pattern, batch):
    m, cap = 1024, 512
    rng = np.random.default_rng(7)
    verts = (rng.normal(size=(batch, m, 3)) * 20.0).astype(np.float32)
    keep = np.stack([_keep_for(pattern, m, cap, rng) for _ in range(batch)])
    ours = ops.compact_survivors_batch(verts, keep, cap, device="cpu")
    for theirs in (jax_compact.compact_batch_ref(verts, keep, cap),
                   jax_compact.compact_batch_pallas(verts, keep, cap, block=256,
                                                    interpret=True)):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.numpy().dtype == np.asarray(b).dtype


def _vertex_stack():
    """Unpruned vertex lists of three cases at one cap, as pass 1 sees them."""
    lists = []
    for shape, seed in [((24, 20, 16), 1), ((28, 22, 18), 2), ((26, 21, 17), 3)]:
        _, m, _ = synthetic.make_case(shape, seed=seed)
        f = ref.vertex_fields(torch.from_numpy(np.pad(m.astype(np.float32), 1)), 0.5)
        lists.append(ref.compact_vertices(f, 2048)[:2])
    sphere = ref.vertex_fields(torch.from_numpy(np.pad(sphere_mask(14, 5.0), 1)), 0.5)
    lists.append(ref.compact_vertices(sphere, 2048)[:2])
    return torch.stack([v for v, _ in lists]), torch.stack([k for _, k in lists])


def test_keep_mask_batch_equals_reference_and_single_case():
    verts, masks = _vertex_stack()
    keep, lower = prune.keep_mask_batch(verts, masks)
    jkeep, jlower = jax_prune.keep_mask_batch(verts.numpy(), masks.numpy(), 16)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(lower.numpy(), np.asarray(jlower), rtol=1e-6)
    for b in range(len(verts)):
        k1, l1 = prune.candidate_keep_mask(verts[b], masks[b])
        assert torch.equal(keep[b], k1) and torch.equal(lower[b], l1)
        assert 2 <= int(keep[b].sum()) < int(masks[b].sum())


def test_prune_candidates_batch_equals_single_case():
    verts, masks = _vertex_stack()
    batch = ops.prune_candidates_batch(verts.numpy(), masks.numpy(), device="cpu")
    for b, (v2, m2, info) in enumerate(batch):
        w2, n2, jnfo = ops.prune_candidates(verts[b], masks[b])
        np.testing.assert_array_equal(v2, w2)
        np.testing.assert_array_equal(m2, n2)
        assert info == jnfo and info.pruned


def test_diameter_batch_equals_single_case():
    verts, masks = _vertex_stack()
    for block in (128, 256):
        v = ref.diameter_input_batch(verts, masks, block)
        for b in range(len(verts)):
            assert torch.equal(v[b], ref.diameter_input(verts[b], masks[b], block))
    d = ops.max_diameters_batch(verts, masks, device="cpu")
    for b in range(len(verts)):
        assert torch.equal(d[b], ops.max_diameters(verts[b], masks[b], device="cpu"))


def test_mc_volume_area_batch_matches_reference_interpret():
    rng = np.random.default_rng(3)
    vols = np.stack([np.pad(sphere_mask(18, 7.0), 1),
                     np.pad((rng.random((18, 18, 18)) < 0.5).astype(np.float32), 1)])
    spacings = np.array([[1.0, 1.0, 1.0], [2.0, 1.0, 0.5]], np.float32)
    ours = ops.mc_volume_area_batch(vols, 0.5, spacings, device="cpu")
    theirs = np.asarray(jax_mc.mc_volume_area_batch_pallas(vols, 0.5, spacings,
                                                           interpret=True))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-3)
    for b in range(2):
        v, a = ops.mc_volume_area(vols[b], 0.5, spacings[b], device="cpu")
        assert torch.equal(ours[b], torch.stack([v, a]))
