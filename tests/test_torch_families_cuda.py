"""The intensity families' CUDA kernels on the card: each against its plain
version, and the three-family batched extractor end to end.

Skipped without a CUDA device (a CUDA kernel has no CPU mode).  Run on an
H100 with ``PYTHONPATH=src python -m pytest -q tests/test_torch_families_cuda.py``.
The first-order kernel does the plain version's arithmetic in its order
(a fixed pairwise tree per 1024-voxel chunk, a left fold over chunks), so
the two agree bitwise, at every ``block`` and batch depth; the GLCM
kernel's integer counts equal the plain version's exactly.  The masked
range kernel's ``(lo, hi)`` equal ``ref.intensity_range``'s by value (a
min and a max are exact in any order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import crop_to_roi  # noqa: E402
from repro_torch.core.pipeline import BatchedExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import firstorder, glcm, masked_range, ref  # noqa: E402

pytestmark = pytest.mark.cuda

FAMS = ("shape", "firstorder", "glcm")
KERNELS = {"firstorder": (firstorder, firstorder.firstorder_packed_batch,
                          firstorder.firstorder_packed_batch_ref),
           "glcm": (glcm, glcm.glcm_matrix_batch, glcm.glcm_matrix_batch_ref)}


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


def _random_stack(dev, shape=(3, 33, 20, 17), seed=0):
    """CT-like images and random masks; case 1 is constant, the last empty."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(40.0, 15.0, shape).astype(np.float32)
    msks = (rng.random(shape) < 0.6).astype(np.float32)
    imgs[1] = 7.0
    msks[-1] = 0.0
    return torch.from_numpy(imgs).to(dev), torch.from_numpy(msks).to(dev)


def _case_00001_1(dev):
    name, img, msk, _ = synthetic.table2_suite(seed=0)[2]
    assert name == "00001-1"
    im, m, _ = crop_to_roi(img, msk)
    return torch.from_numpy(im[None]).to(dev), torch.from_numpy(m[None]).to(dev)


def _inputs(kind, dev):
    return _case_00001_1(dev) if kind == "00001-1" else _random_stack(dev)


@pytest.mark.parametrize("kind", ["random", "00001-1"])
@pytest.mark.parametrize("family", sorted(KERNELS))
def test_kernel_equals_plain(dev, family, kind):
    module, kernel, plain = KERNELS[family]
    imgs, msks = _inputs(kind, dev)
    before = module.LAUNCHES
    got = kernel(imgs, msks)
    torch.cuda.synchronize()
    assert module.LAUNCHES == before + 1  # the kernel ran, not the plain version
    want = plain(imgs, msks)
    assert got.dtype == want.dtype == torch.float32 and torch.equal(got, want)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("n_bins", [8, 64])
@pytest.mark.parametrize("family", sorted(KERNELS))
def test_kernel_equals_plain_other_bin_counts(dev, family, n_bins):
    _, kernel, plain = KERNELS[family]
    imgs, msks = _random_stack(dev, seed=3)
    assert torch.equal(kernel(imgs, msks, n_bins=n_bins), plain(imgs, msks, n_bins))


@pytest.mark.parametrize("family,blocks", [("firstorder", (1024, 2048, 8192)),
                                           ("glcm", (1, 2, 4, 8, 16, 64))])
def test_block_never_changes_a_bit(dev, family, blocks):
    _, kernel, _ = KERNELS[family]
    imgs, msks = _case_00001_1(dev)
    outs = [kernel(imgs, msks, block=b) for b in blocks]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


GLCM_BLOCKS = (1, 2, 4, 8, 16, 64)


def _glcm_case(dev, kind):
    """(images, masks) of the GLCM tile kernel's hard cases."""
    rng = np.random.default_rng(5)
    shape = {"y-split": (2, 3, 700, 700), "z-split": (2, 2, 3, 5000),
             "unaligned": (3, 9, 13, 37)}.get(kind, (2, 40, 33, 48))
    imgs = rng.normal(40.0, 15.0, shape).astype(np.float32)
    msks = (rng.random(shape) < 0.6).astype(np.float32)
    if kind == "one-level":  # every masked voxel in one bin: the worst collisions
        imgs[:] = 11.0
    elif kind == "empty":
        msks[:] = 0.0
    elif kind == "full":
        msks[:] = 1.0
    return torch.from_numpy(imgs).to(dev), torch.from_numpy(msks).to(dev)


@pytest.mark.parametrize("kind", ["one-level", "empty", "full", "y-split", "z-split",
                                  "unaligned"])
def test_glcm_exact_at_every_block(dev, kind):
    """The tile kernel == the plain version exactly at every block, and a
    case alone == its row of the stack (a y-split: a 700 x 700 plane is
    larger than a block's shared memory; a z-split: 5,000-voxel rows)."""
    imgs, msks = _glcm_case(dev, kind)
    want = glcm.glcm_matrix_batch_ref(imgs, msks)
    for block in GLCM_BLOCKS:
        got = glcm.glcm_matrix_batch(imgs, msks, block=block)
        assert torch.equal(got, want), (kind, block)
        one = glcm.glcm_matrix_batch(imgs[1:2], msks[1:2], block=block)
        assert torch.equal(one[0], got[1]), (kind, block)
    if kind == "empty":
        assert not want.any()
    elif kind == "one-level":
        assert int((want > 0).sum()) == len(imgs)


@pytest.mark.parametrize("n_bins", [1, 2, 5, 16, 31, 32, 33, 45, 63, 64])
def test_glcm_exact_at_every_bin_count(dev, n_bins):
    imgs, msks = _glcm_case(dev, "random")
    want = glcm.glcm_matrix_batch_ref(imgs, msks, n_bins)
    for block in (1, glcm.DEFAULT_BLOCK, 64):
        assert torch.equal(glcm.glcm_matrix_batch(imgs, msks, n_bins=n_bins, block=block), want)


@pytest.mark.parametrize("family", sorted(KERNELS))
def test_batched_equals_batch_of_one(dev, family):
    _, kernel, _ = KERNELS[family]
    imgs, msks = _random_stack(dev, seed=1)
    batched = kernel(imgs, msks)
    for b in range(len(imgs)):
        assert torch.equal(kernel(imgs[b:b + 1], msks[b:b + 1])[0], batched[b])


@pytest.mark.parametrize("family", sorted(KERNELS))
def test_given_range_equals_own_range(dev, family):
    """The executor hands both kernels the masked range its pool took once."""
    _, kernel, plain = KERNELS[family]
    imgs, msks = _random_stack(dev, seed=2)
    flat = (len(imgs), -1)
    rng = ref.intensity_range(imgs.reshape(flat), msks.reshape(flat), dim=1)
    got = kernel(imgs, msks, value_range=rng)
    assert torch.equal(got, kernel(imgs, msks))
    assert torch.equal(got, plain(imgs, msks, value_range=rng))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    imgs, msks = _random_stack(dev)
    for _, kernel, _ in KERNELS.values():
        with pytest.raises(ValueError):
            kernel(imgs, msks.cpu())
        with pytest.raises(ValueError):
            kernel(imgs, msks.to(torch.float64))
        with pytest.raises(ValueError):
            kernel(imgs[:, :, :, 1:], msks[:, :, :, 1:])  # not contiguous


def test_three_family_run_on_card(dev):
    """Rows equal extract_one bitwise and the CPU path (GLCM and the exact
    first-order columns exactly); the window syncs only in its fetches."""
    cases = [synthetic.make_case(s, seed=seed) for s, seed in
             [((24, 20, 16), 1), ((28, 22, 18), 2), ((50, 24, 20), 2), ((52, 28, 22), 4)]]
    ext = BatchedExtractor(families=FAMS)
    ext.run(cases)  # first use: the autotune sweeps of the family blocks
    before = (firstorder.LAUNCHES, glcm.LAUNCHES)
    rows, stats = ext.run(cases)
    assert (firstorder.LAUNCHES - before[0], glcm.LAUNCHES - before[1]) == (
        stats["plan"]["shape_buckets"],) * 2
    rows = np.stack(rows)
    for case, row in zip(cases, rows):
        np.testing.assert_array_equal(ext.extract_one(*case), row)
    cpu, cpu_stats = BatchedExtractor(device="cpu", families=FAMS).run(cases)
    cpu = np.stack(cpu)
    np.testing.assert_allclose(rows[:, :6], cpu[:, :6], rtol=1e-4)
    np.testing.assert_array_equal(rows[:, 6:], cpu[:, 6:])  # the families: bitwise
    assert stats["host_fetches"] == cpu_stats["host_fetches"]
    with ext.executor.strict_syncs():
        strict, strict_stats = ext.run(cases)
    assert not strict_stats["errors"]  # a sync in prep would quarantine its case
    np.testing.assert_array_equal(np.stack(strict), rows)
    assert strict_stats["host_fetches"] == stats["host_fetches"]


def _stack(dev, batch, voxels, density, seed=1):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(-300.0, 400.0, (batch, 1, 1, voxels)).astype(np.float32)
    msks = (rng.random((batch, 1, 1, voxels)) < density).astype(np.float32)
    return torch.from_numpy(imgs).to(dev), torch.from_numpy(msks).to(dev)


def _fo_both(imgs, msks, **kw):
    got = firstorder.firstorder_packed_batch(imgs, msks, **kw)
    plain = firstorder.firstorder_packed_batch_ref(imgs, msks, kw.get("n_bins", firstorder.N_BINS))
    return got, plain


@pytest.mark.parametrize("voxels", [1024, 2048, 33 * 1024, 1000, 2 * 1024 + 3, 5 * 1024 + 517])
def test_firstorder_chunk_counts_and_ragged_ends_bitwise(dev, voxels):
    """1, 2 and 33 whole chunks, and volumes whose last chunk is cut short
    (an odd voxel count also puts every other case off 16-byte alignment,
    the kernel's scalar loads)."""
    got, plain = _fo_both(*_stack(dev, 3, voxels, 0.7))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("density", [0.0, 1.0])
def test_firstorder_no_voxel_or_every_voxel_masked_bitwise(dev, density):
    got, plain = _fo_both(*_stack(dev, 2, 9 * 1024 + 5, density))
    assert torch.equal(got, plain)
    assert float(got[0, 0]) == (0.0 if density == 0.0 else 9 * 1024 + 5)


@pytest.mark.parametrize("n_bins", [1, 32, 64])
def test_firstorder_bin_counts_bitwise(dev, n_bins):
    got, plain = _fo_both(*_stack(dev, 2, 40 * 1024 + 7, 0.5), n_bins=n_bins)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("block", [1024, 2048, 3072, 4096, 5120, 8192])
def test_firstorder_every_block_bitwise(dev, block):
    imgs, msks = _case_00001_1(dev)
    assert torch.equal(firstorder.firstorder_packed_batch(imgs, msks, block=block),
                       firstorder.firstorder_packed_batch_ref(imgs, msks))


def test_fold_past_2_24_masked_voxels_bitwise(dev):
    """16,400 chunks with 1,023 or 1,024 masked voxels each: the count
    passes 2^24, where a float fold of the counts rounds; the kernel keeps
    the plain version's (and the reference's) float order there."""
    rng = np.random.default_rng(7)
    n, C = 16_400, firstorder.CANON_CHUNK
    m = np.ones((n, C), np.float32)
    m[np.arange(n), rng.integers(0, C, n)] = rng.random(n) < 0.5
    x = np.where(m > 0, rng.normal(50.0, 20.0, (n, C)), 0.0).astype(np.float32)
    xt, mt = torch.from_numpy(x).to(dev), torch.from_numpy(m).to(dev)
    lo, hi = xt[mt > 0].min(), xt[mt > 0].max()
    got = firstorder.fold_packed_chunks(xt, mt, lo, hi)
    stack = (1, n, 1, C)
    plain = firstorder.firstorder_packed_batch_ref(xt.reshape(stack), mt.reshape(stack),
                                                   firstorder.N_BINS,
                                                   (lo.reshape(1), hi.reshape(1)))[0]
    assert torch.equal(got, plain)
    exact = int(m.sum())
    assert exact > 2 ** 24 and float(got[0]) != exact  # the float fold rounded


# -- the masked range (csrc/masked_range.cu) ---------------------------------


def _range_stack(dev, batch, shape, kind, seed=0):
    """(batch, *shape) float32 images and masks; the last case of a stack
    of more than one is empty.  ``kind``: 'random'; 'nan' (a masked NaN in
    case 0, unmasked NaNs everywhere); 'zero_tie' (-0.0 and +0.0 the
    smallest masked values); 'inf' (a masked +inf and -inf)."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(40.0, 15.0, (batch, *shape)).astype(np.float32)
    msks = (rng.random((batch, *shape)) < 0.3).astype(np.float32)
    flat_i, flat_m = imgs.reshape(batch, -1), msks.reshape(batch, -1)
    if kind == "nan":
        flat_i[flat_m == 0] = np.nan
        flat_m[0, 2] = 1.0
        flat_i[0, 2] = np.nan
    elif kind == "zero_tie":
        flat_i[:] = np.abs(flat_i) + 1.0
        flat_m[:, [3, -2]] = 1.0
        flat_i[:, 3], flat_i[:, -2] = -0.0, 0.0
    elif kind == "inf":
        flat_m[:, [1, -1]] = 1.0
        flat_i[:, 1], flat_i[:, -1] = np.inf, -np.inf
    if batch > 1:
        msks[-1] = 0.0
    return torch.from_numpy(imgs).to(dev), torch.from_numpy(msks).to(dev)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _range_agrees(got, imgs, msks):
    """Kernel (lo, hi) == the plain version's by value (NaN == NaN), and
    bitwise where that is neither a zero nor a NaN."""
    flat = (len(imgs), -1)
    want = ref.intensity_range(imgs.reshape(flat), msks.reshape(flat), dim=1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0.0, atol=0.0, equal_nan=True)
        other = (w != 0) & ~torch.isnan(w)
        assert torch.equal(_bits(g)[other], _bits(w)[other])


@pytest.mark.parametrize("kind", ["random", "nan", "zero_tie", "inf"])
@pytest.mark.parametrize("shape", [(37, 21, 13), (40, 30, 20), (2, 2, 1)])
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_masked_range_kernel_equals_plain(dev, batch, shape, kind):
    """Odd voxel counts misalign every other row by 4 to 12 bytes (the
    head and tail voxels); (40, 30, 20) spans three blocks; (2, 2, 1) is
    one 16-byte group.  Each stack row == its batch of one, bitwise."""
    imgs, msks = _range_stack(dev, batch, shape, kind)
    before = masked_range.LAUNCHES
    got = masked_range.masked_range_batch(imgs, msks)
    assert masked_range.LAUNCHES == before + 1  # the kernel ran, not the plain version
    assert got[0].shape == got[1].shape == (batch,) and got[0].device.type == "cuda"
    _range_agrees(got, imgs, msks)
    if batch > 1:
        assert float(got[0][-1]) == float(got[1][-1]) == 0.0  # the empty case
    for b in range(batch):
        one = masked_range.masked_range_batch(imgs[b:b + 1], msks[b:b + 1])
        assert torch.equal(_bits(one[0]), _bits(got[0][b:b + 1]))
        assert torch.equal(_bits(one[1]), _bits(got[1][b:b + 1]))


def test_masked_range_rows_aligned_apart(dev):
    """Image and mask rows at different offsets from a 16-byte boundary:
    the voxel-by-voxel read gives the same range."""
    imgs, msks = _range_stack(dev, 3, (40, 30, 20), "random", seed=3)
    store = torch.empty(imgs.numel() + 1, device=dev)
    shifted = store[1:].view(imgs.shape)  # 4 bytes past the mask's alignment
    shifted.copy_(imgs)
    assert shifted.is_contiguous() and (shifted.data_ptr() - msks.data_ptr()) % 16
    got = masked_range.masked_range_batch(shifted, msks)
    _range_agrees(got, imgs, msks)
    assert all(torch.equal(g, w) for g, w in zip(got, masked_range.masked_range_batch(imgs, msks)))


def test_masked_range_refuses_what_the_kernel_does_not_take(dev):
    imgs, msks = _range_stack(dev, 2, (8, 8, 8), "random")
    with pytest.raises(ValueError):
        masked_range.masked_range_batch(imgs, msks.cpu())
    with pytest.raises(ValueError):
        masked_range.masked_range_batch(imgs, msks.bool())
    with pytest.raises(ValueError):
        masked_range.masked_range_batch(imgs[:, :, :, 1:], msks[:, :, :, 1:])


def test_executor_pools_launch_the_range_kernel(dev):
    """One range launch per shape pool of a three-family window; the
    families read it and take no range of their own."""
    cases = [synthetic.make_case(s, seed=seed) for s, seed in
             [((24, 20, 16), 1), ((28, 22, 18), 2), ((50, 24, 20), 2), ((52, 28, 22), 4)]]
    ext = BatchedExtractor(families=FAMS)
    ext.run(cases)  # first use: the autotune sweeps of the family blocks
    before = masked_range.LAUNCHES
    _, stats = ext.run(cases)
    assert masked_range.LAUNCHES - before == stats["plan"]["shape_buckets"]
