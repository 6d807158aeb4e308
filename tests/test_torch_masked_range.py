"""The masked intensity range: the kernel's decomposition, modelled in torch.

``csrc/masked_range.cu`` cuts each case of a (B, L) stack into blocks of
``masked_range.CHUNK`` voxels, reads the mask as 16-byte groups from the
row's first 16-byte-aligned voxel on (block 0 also takes the at most 3
voxels before it and after the last whole group; rows whose image and mask
are aligned apart are read voxel by voxel), folds each block's masked
values into a partial (lo, hi, count) with a min and a max that keep a
NaN, and folds a case's partials into ``(lo, hi)``, ``(0, 0)`` where the
count is 0.  The model below follows those rules and must equal the plain
version (``ref.intensity_range``) by value on every mask and value case;
the plain version must equal the JAX package's, and a -0.0/+0.0 tie at the
extremum (the one place the kernel may pick the other sign) must change
no bit of either family's bins.  CPU only; the card tests are in
``tests/test_torch_families_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import firstorder, glcm, masked_range, ref  # noqa: E402

CHUNK = masked_range.CHUNK
GROUPS = CHUNK // 4  # 16-byte groups a block reads
L = 2 * CHUNK + 4 * 37 + 3  # three blocks a case, a ragged last one


def _min_nan(a, b):
    return torch.where((b < a) | torch.isnan(b), b, a)


def _max_nan(a, b):
    return torch.where((b > a) | torch.isnan(b), b, a)


def _partial(x, m):
    """One block's (lo, hi, n): its masked values folded by the kernel's
    compare-and-select, in a pairwise tree."""
    vals = x[m > 0]
    inf = torch.tensor([np.inf], dtype=torch.float32)
    lo, hi = torch.cat([vals, inf]), torch.cat([vals, -inf])
    while len(lo) > 1:
        if len(lo) % 2:
            lo, hi = torch.cat([lo, inf]), torch.cat([hi, -inf])
        lo = _min_nan(lo[0::2], lo[1::2])
        hi = _max_nan(hi[0::2], hi[1::2])
    return lo[0], hi[0], int(vals.numel())


def model_range(images, masks, offset=0, vec=True):
    """The kernel's ``(lo, hi)`` of a (B, L) stack whose row b starts
    ``offset + b L`` floats past a 16-byte boundary (``vec``: the rows are
    read as 16-byte groups, else voxel by voxel)."""
    batch, voxels = images.shape
    chunks = -(-voxels // CHUNK)
    lo_out, hi_out = [], []
    for b in range(batch):
        x, m = images[b], masks[b]
        owner = torch.empty(voxels, dtype=torch.long)  # the block that reads each voxel
        if vec:
            head = min(voxels, (-(offset + b * voxels)) % 4)
            ng = (voxels - head) // 4
            owner[:] = 0  # head and tail: block 0
            owner[head:head + 4 * ng] = torch.arange(4 * ng) // 4 // GROUPS
        else:
            owner[:] = torch.arange(voxels) // CHUNK
        assert int(owner.max()) < chunks
        parts = [_partial(x[owner == c], m[owner == c]) for c in range(chunks)]
        lo = torch.tensor(np.inf, dtype=torch.float32)
        hi = torch.tensor(-np.inf, dtype=torch.float32)
        n = 0
        for plo, phi, pn in parts:  # the fold kernel: any order
            lo, hi, n = _min_nan(lo, plo), _max_nan(hi, phi), n + pn
        lo_out.append(lo if n else torch.tensor(0.0))
        hi_out.append(hi if n else torch.tensor(0.0))
    return torch.stack(lo_out), torch.stack(hi_out)


def _stack(kind, seed=0, batch=3):
    """(images, masks), (batch, L) float32, with mask and value case ``kind``."""
    rng = np.random.default_rng(seed)
    img = rng.normal(40.0, 15.0, size=(batch, L)).astype(np.float32)
    s = np.arange(L)
    borders = np.zeros(L, bool)
    for c in (CHUNK, 2 * CHUNK):  # both sides of each block border
        borders[c - 5:c + 3] = True
    borders[::16] = True  # one voxel of every fourth 16-byte group
    masks = {
        "empty": np.zeros(L, bool),
        "one_voxel": s == L // 2 + 1,
        "full": np.ones(L, bool),
        "random": rng.random(L) < 0.3,
        "borders": borders,
        "last_voxel": s == L - 1,
        "first_voxel": s == 0,
    }
    if kind in masks:
        m = np.broadcast_to(masks[kind], (batch, L)).copy()
    else:
        m = rng.random((batch, L)) < 0.3
        m[:, CHUNK] = True
        if kind == "masked_nan":
            img[0, CHUNK] = np.nan
        elif kind == "unmasked_nan":
            img[~m] = np.nan
        elif kind == "inf":
            img[0, CHUNK] = np.inf
            m[0, 2 * CHUNK + 1] = True
            img[0, 2 * CHUNK + 1] = -np.inf
            img[1][m[1]] = np.inf  # every masked value +inf: lo == hi == +inf
        elif kind == "zero_tie":
            img[:] = np.abs(img) + 1.0
            img[:, CHUNK] = -0.0
            m[:, 2 * CHUNK + 1] = True
            img[:, 2 * CHUNK + 1] = 0.0
        else:
            raise ValueError(kind)
    m[-1] = False  # an empty case
    return torch.from_numpy(img), torch.from_numpy(m.astype(np.float32))


KINDS = ("empty", "one_voxel", "full", "random", "borders", "last_voxel", "first_voxel",
         "masked_nan", "unmasked_nan", "inf", "zero_tie")


def _same(got, want):
    """Equal by value, NaN equal to NaN (-0.0 == +0.0)."""
    torch.testing.assert_close(got, want, rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("offset,vec", [(0, True), (1, True), (3, True), (0, False)])
def test_kernel_model_equals_plain(kind, offset, vec):
    images, masks = _stack(kind)
    want = ref.intensity_range(images, masks, dim=1)
    got = model_range(images, masks, offset, vec)
    for g, w in zip(got, want):
        _same(g, w)
    assert float(want[0][2]) == 0.0 and float(want[1][2]) == 0.0  # the empty case


def test_plain_cases_read_as_expected():
    """The value cases say what they claim."""
    lo, hi = ref.intensity_range(*_stack("masked_nan"), dim=1)
    assert torch.isnan(lo[0]) and torch.isnan(hi[0]) and not torch.isnan(lo[1])
    lo, hi = ref.intensity_range(*_stack("unmasked_nan"), dim=1)
    assert not torch.isnan(lo).any() and not torch.isnan(hi).any()
    lo, hi = ref.intensity_range(*_stack("inf"), dim=1)
    assert lo[0] == -np.inf and hi[0] == np.inf and lo[1] == hi[1] == np.inf
    lo, hi = ref.intensity_range(*_stack("zero_tie"), dim=1)
    assert (lo[:2] == 0.0).all() and (hi[:2] > 1.0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_equals_the_jax_package(kind):
    images, masks = _stack(kind, seed=1)
    lo, hi = ref.intensity_range(images, masks, dim=1)
    for b in range(len(images)):
        jlo, jhi = jax_ref.intensity_range(images[b].numpy(), masks[b].numpy())
        _same(lo[b], torch.tensor(float(jlo)))
        _same(hi[b], torch.tensor(float(jhi)))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    images, masks = _stack("random", seed=2)
    vols, mvols = images.reshape(3, 1, 1, L), masks.reshape(3, 1, 1, L)
    before = masked_range.LAUNCHES
    got = masked_range.masked_range_batch(vols, mvols)
    assert masked_range.LAUNCHES == before  # a CPU tensor launches nothing
    for g, w in zip(got, ref.intensity_range(images, masks, dim=1)):
        assert torch.equal(g, w)


def test_zero_tie_sign_changes_no_family_bin():
    """``lo`` = -0.0 or +0.0 (the kernel's tie may give either): the same
    first-order stats and histogram, the same GLCM counts, and feature
    rows equal by value."""
    rng = np.random.default_rng(5)
    shape = (2, 12, 10, 9)
    img = np.abs(rng.normal(40.0, 15.0, size=shape)).astype(np.float32)
    msk = (rng.random(shape) < 0.6).astype(np.float32)
    img[:, 3, 4, 5], msk[:, 3, 4, 5] = -0.0, 1.0
    img[:, 6, 2, 1], msk[:, 6, 2, 1] = 0.0, 1.0
    images, masks = torch.from_numpy(img), torch.from_numpy(msk)
    _, hi = ref.intensity_range(images.reshape(2, -1), masks.reshape(2, -1), dim=1)
    pos, neg = torch.zeros(2), torch.full((2,), -0.0)
    assert torch.signbit(neg).all() and not torch.signbit(pos).any()
    fo_pos = firstorder.firstorder_packed_batch_ref(images, masks, value_range=(pos, hi))
    fo_neg = firstorder.firstorder_packed_batch_ref(images, masks, value_range=(neg, hi))
    w = firstorder.stats_width(firstorder.N_BINS)
    assert torch.equal(fo_pos[:, :w], fo_neg[:, :w])  # count, sums, histogram: bitwise
    assert np.array_equal(firstorder.features_from_packed_np(fo_pos.numpy()),
                          firstorder.features_from_packed_np(fo_neg.numpy()))
    gl_pos = glcm.glcm_matrix_batch_ref(images, masks, value_range=(pos, hi))
    gl_neg = glcm.glcm_matrix_batch_ref(images, masks, value_range=(neg, hi))
    assert torch.equal(gl_pos, gl_neg)
    assert np.array_equal(glcm.glcm_features_from_matrix_np(gl_pos.numpy()),
                          glcm.glcm_features_from_matrix_np(gl_neg.numpy()))
