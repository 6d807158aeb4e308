"""The port's intensity families (first-order, GLCM) on the CPU vs the JAX package's.

The same cases, made from a seed with numpy, go through the JAX function
and its counterpart in the port:

* ``intensity_range`` and ``quantize_intensity``: exactly, on bin edges too;
* the first-order plain version against ``firstorder_packed_batch_ref`` and
  the Pallas kernel in interpret mode: count, histogram and range exactly,
  the two sums at rtol 1e-5 (XLA sums each chunk in an order of its own;
  the port's order is the fixed pairwise tree of ``kernels/firstorder``);
* the GLCM plain version against ``glcm_matrix_batch_ref`` and the
  interpret-mode kernel: exactly (integer counts);
* the host derivations, bitwise on the same input;
* ``BatchedExtractor(device='cpu', families=...)`` against JAX
  ``BatchedExtractor(backend='ref', families=...)``: the shape columns at
  rtol 1e-4 (``tests/test_torch_batched.py``), the GLCM columns and the
  first-order min, max, percentiles and entropy (functions of the exact
  count, histogram and range) exactly, mean, std and energy at rtol 1e-4;
  ``host_fetches`` equal per stage;
* the reference's executor contracts (``tests/test_features_families.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import BatchedExtractor as JaxBatchedExtractor  # noqa: E402
from repro.kernels import firstorder as jax_fo  # noqa: E402
from repro.kernels import glcm as jax_glcm  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core import plan as planlib  # noqa: E402
from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data.synthetic import make_case  # noqa: E402
from repro_torch.kernels import firstorder, glcm, ops, ref  # noqa: E402

N_BINS = 32
FAMS = ("shape", "firstorder", "glcm")
# two shape buckets; the last case has a second ROI shape
SHAPES = [((20, 22, 18), 0), ((20, 22, 18), 1), ((20, 22, 18), 2), ((26, 20, 16), 3)]
FO_EXACT = [2, 3, 4, 5, 6, 8]  # min, max, P10, median, P90, entropy


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
    return tuple(make_case(s, seed=seed) for s, seed in SHAPES)


def _stack(cases):
    imgs = np.stack([np.asarray(c[0], np.float32) for c in cases])
    msks = np.stack([np.asarray(c[1], np.float32) for c in cases])
    return imgs, msks


def _edge_volumes(kind):
    """(image, mask) with a known edge: random, empty, constant, bin edge."""
    rng = np.random.default_rng(5)
    if kind == "bin-edge":  # integers 0..31: the max sits on the top edge
        img = np.tile(np.arange(32, dtype=np.float32), 32).reshape(8, 16, 8)
        return img, np.ones((8, 16, 8), np.float32)
    img = (rng.normal(40.0, 15.0, (10, 12, 9))).astype(np.float32)
    msk = np.zeros((10, 12, 9), np.float32)
    if kind != "empty":
        msk[2:7, 3:9, 2:6] = 1.0
    if kind == "constant":
        img[:] = 7.0
    return img, msk


EDGES = ["random", "empty", "constant", "bin-edge"]


@pytest.mark.parametrize("kind", EDGES)
def test_intensity_range_equals_reference(kind):
    img, msk = _edge_volumes(kind)
    lo, hi = ref.intensity_range(torch.from_numpy(img), torch.from_numpy(msk))
    jlo, jhi = jax_ref.intensity_range(img, msk)
    assert lo.item() == float(jlo) and hi.item() == float(jhi)
    if kind == "empty":
        assert (lo.item(), hi.item()) == (0.0, 0.0)


@pytest.mark.parametrize("kind", EDGES)
def test_quantize_equals_reference(kind):
    img, msk = _edge_volumes(kind)
    jlo, jhi = jax_ref.intensity_range(img, msk)
    q, width = ref.quantize_intensity(torch.from_numpy(img), torch.from_numpy(msk),
                                      torch.tensor(float(jlo)), torch.tensor(float(jhi)),
                                      N_BINS)
    jq, jwidth = jax_ref.quantize_intensity(img, msk, jlo, jhi, N_BINS)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert width.item() == float(jwidth)
    if kind == "bin-edge":
        assert q.max().item() == N_BINS - 1
        np.testing.assert_array_equal(np.bincount(q.numpy().astype(int).ravel()),
                                      np.full(N_BINS, img.size // N_BINS))


@pytest.mark.parametrize("multiple", [1024, 2048])
def test_flatten_batch_equals_reference(multiple):
    imgs, msks = _stack(_cases()[:3])
    ours = firstorder._flatten_batch(torch.from_numpy(imgs), torch.from_numpy(msks),
                                     N_BINS, multiple)
    theirs = jax_fo._flatten_batch(imgs, msks, N_BINS, multiple)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pair_arrays_equal_reference():
    img, msk, _ = _cases()[0]
    q, m = glcm._quantize_batch(torch.from_numpy(img[None]), torch.from_numpy(msk[None]),
                                N_BINS)
    jq, jm = jax_glcm._quantize_batch(img[None], msk[None], N_BINS)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    for a, b in zip(glcm.pair_arrays(q[0], m[0]), jax_glcm.pair_arrays(jq[0], jm[0])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@functools.lru_cache(maxsize=None)
def _jax_packed(route, n_bins=N_BINS):
    imgs, msks = _stack(_cases()[:3])
    if route == "ref":
        return np.asarray(jax_fo.firstorder_packed_batch_ref(imgs, msks, n_bins=n_bins))
    return np.asarray(jax_fo.firstorder_packed_batch_pallas(imgs, msks, n_bins=n_bins,
                                                            interpret=True))


@functools.lru_cache(maxsize=None)
def _jax_glcm(route, n_bins=N_BINS):
    imgs, msks = _stack(_cases()[:3])
    if route == "ref":
        return np.asarray(jax_glcm.glcm_matrix_batch_ref(imgs, msks, n_bins=n_bins))
    return np.asarray(jax_glcm.glcm_matrix_batch_pallas(imgs, msks, n_bins=n_bins,
                                                        interpret=True))


ROUTES = [("ref", N_BINS), ("interpret", N_BINS), ("ref", 8)]


@pytest.mark.parametrize("route,n_bins", ROUTES)
def test_firstorder_plain_matches_reference(route, n_bins):
    imgs, msks = _stack(_cases()[:3])
    ours = ops.firstorder_packed_batch(imgs, msks, device="cpu", n_bins=n_bins).numpy()
    theirs = _jax_packed(route, n_bins)
    assert ours.shape == (3, firstorder.packed_width(n_bins)) and ours.dtype == np.float32
    exact = [0] + list(range(3, firstorder.packed_width(n_bins)))  # all but the sums
    np.testing.assert_array_equal(ours[:, exact], theirs[:, exact])
    np.testing.assert_allclose(ours[:, 1:3], theirs[:, 1:3], rtol=1e-5)
    assert (ours[:, 0] == msks.reshape(3, -1).sum(1)).all()
    assert (ours[:, 3:3 + n_bins].sum(1) == ours[:, 0]).all()


@pytest.mark.parametrize("route,n_bins", ROUTES)
def test_glcm_plain_equals_reference(route, n_bins):
    imgs, msks = _stack(_cases()[:3])
    ours = ops.glcm_matrix_batch(imgs, msks, device="cpu", n_bins=n_bins).numpy()
    assert ours.shape == (3, n_bins, n_bins) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, _jax_glcm(route, n_bins))


def test_host_derivations_bitwise_equal_reference():
    packed = _jax_packed("ref")
    np.testing.assert_array_equal(firstorder.features_from_packed_np(packed),
                                  jax_fo.features_from_packed_np(packed))
    mats = _jax_glcm("ref")
    np.testing.assert_array_equal(glcm.glcm_features_from_matrix_np(mats),
                                  jax_glcm.glcm_features_from_matrix_np(mats))
    # empty and single-gray-level inputs: the documented zero and one rows
    np.testing.assert_array_equal(firstorder.features_from_packed_np(np.zeros((1, 38))),
                                  np.zeros((1, 9), np.float32))
    one = np.zeros((N_BINS, N_BINS), np.float32)
    one[4, 4] = 10.0
    np.testing.assert_array_equal(glcm.glcm_features_from_matrix_np(one), [0.0, 1.0, 1.0, 1.0])


@pytest.mark.parametrize("op", [ops.firstorder_packed_batch, ops.glcm_matrix_batch])
def test_plain_batched_equals_batch_of_one(op):
    imgs, msks = _stack(_cases()[:3])
    batched = op(imgs, msks, device="cpu")
    for b in range(3):
        assert torch.equal(op(imgs[b:b + 1], msks[b:b + 1], device="cpu")[0], batched[b])


@pytest.mark.parametrize("op", [ops.firstorder_packed_batch, ops.glcm_matrix_batch])
def test_given_range_is_the_range_used(op):
    """The executor takes each pool's masked range once and hands it to
    both families: the same range gives the same bits as the wrapper's
    own, and a given range is the one quantised against."""
    imgs, msks = _stack(_cases()[:3])
    lo, hi = ref.intensity_range(imgs.reshape(3, -1), msks.reshape(3, -1), dim=1)
    own = op(imgs, msks, device="cpu")
    assert torch.equal(op(imgs, msks, device="cpu", value_range=(lo, hi)), own)
    wider = op(imgs, msks, device="cpu", value_range=(lo - 100.0, hi + 100.0))
    assert not torch.equal(wider, own)
    if op is ops.firstorder_packed_batch:
        assert torch.equal(wider[:, -3], lo - 100.0) and torch.equal(wider[:, -2], hi + 100.0)


@pytest.mark.parametrize("op,block", [(ops.firstorder_packed_batch, 1536),
                                      (ops.glcm_matrix_batch, 100)])
def test_block_off_the_grain_raises(op, block):
    imgs, msks = _stack(_cases()[:1])
    with pytest.raises(ValueError, match="block"):
        op(imgs, msks, device="cpu", block=block)
    with pytest.raises(ValueError, match="n_bins"):
        op(imgs, msks, device="cpu", n_bins=65)


@functools.lru_cache(maxsize=None)
def _runs(families, n_cases=len(SHAPES)):
    cases = _cases()[:n_cases]
    ours, ostats = BatchedExtractor(device="cpu", families=families).run(cases)
    theirs, tstats = JaxBatchedExtractor(backend="ref", families=families).run(cases)
    return (np.stack(ours), ostats,
            np.stack([np.asarray(r, np.float32) for r in theirs]), tstats)


@pytest.mark.parametrize("families", [FAMS, "firstorder", ("glcm", "shape")])
def test_rows_and_fetches_match_jax(families):
    ours, ostats, theirs, tstats = _runs(families)
    fams = planlib.resolve_families(families)
    assert ours.shape == theirs.shape == (len(SHAPES), planlib.row_width(fams))
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    sl = planlib.family_slices(fams)
    for fam, cols in sl.items():
        o, t = ours[:, cols], theirs[:, cols]
        if fam == "shape":
            np.testing.assert_allclose(o[:, :6], t[:, :6], rtol=1e-4)
            np.testing.assert_array_equal(o[:, 6], t[:, 6])
        elif fam == "glcm":
            np.testing.assert_array_equal(o, t)
        else:
            np.testing.assert_array_equal(o[:, FO_EXACT], t[:, FO_EXACT])
            np.testing.assert_allclose(o, t, rtol=1e-4)
    assert ostats["host_fetches"] == tstats["host_fetches"]
    assert ostats["plan"] == tstats["plan"]
    for fam in sl:
        if fam != "shape":
            assert ostats["host_fetches"][fam] == ostats["plan"]["shape_buckets"]


def test_run_equals_extract_one_bitwise():
    ext = BatchedExtractor(device="cpu", families=FAMS)
    rows, _, _, _ = _runs(FAMS)
    for i, case in enumerate(_cases()):
        np.testing.assert_array_equal(ext.extract_one(*case), rows[i])


@pytest.mark.parametrize("kwargs", [{}, {"prune": False}, {"device_compact": False}])
def test_shape_columns_equal_shape_only_run(kwargs):
    cases = _cases()
    multi, mstats = BatchedExtractor(device="cpu", families=FAMS, **kwargs).run(cases)
    shape, sstats = BatchedExtractor(device="cpu", **kwargs).run(cases)
    np.testing.assert_array_equal(np.stack(multi)[:, :7], np.stack(shape))
    for stage, n in sstats["host_fetches"].items():  # the families add no shape fetch
        assert mstats["host_fetches"][stage] == n, stage
    if not kwargs:
        np.testing.assert_array_equal(np.stack(multi), _runs(FAMS)[0])


def test_intensity_only_request_skips_shape_passes():
    rows, stats, _, _ = _runs("firstorder")
    assert set(stats["host_fetches"]) == {"firstorder"}  # no prep, pass1 or pass2* fetch
    full, _, _, _ = _runs(FAMS)
    np.testing.assert_array_equal(rows, full[:, planlib.family_slices(FAMS)["firstorder"]])


def test_quarantine_gives_full_width_nan_rows():
    good = list(_cases()[:3])
    img, msk, sp = make_case((16, 16, 16), seed=9)
    poisoned = img.copy()
    poisoned[8, 8, 8] = np.nan
    ex = BatchedExtractor(device="cpu", families=FAMS)
    rows, stats = ex.run(good + [(poisoned, msk, sp), (None, msk, sp),
                                 (img[:-1], msk, sp), (img, np.zeros_like(msk), sp)])
    for i in (3, 4, 5):
        assert rows[i].shape == (20,) and np.isnan(rows[i]).all()
    assert set(stats["errors"]) == {3, 4, 5}
    assert "non-finite intensity" in stats["errors"][3]
    assert "intensity image" in stats["errors"][4] and "intensity image" in stats["errors"][5]
    assert rows[6].shape == (20,) and not rows[6].any()  # empty mask: a zero row
    np.testing.assert_array_equal(np.stack(rows[:3]), _runs(FAMS)[0][:3])


def test_missing_image_ok_when_shape_only():
    img, msk, sp = make_case((16, 16, 16), seed=2)
    rows, stats = BatchedExtractor(device="cpu").run([(None, msk, sp), (img, msk, sp)])
    assert not stats["errors"]
    np.testing.assert_array_equal(rows[0], rows[1])
