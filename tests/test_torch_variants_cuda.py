"""The diameter variants' CUDA kernels and the autotuner, on the card.

Skipped without a CUDA device (a CUDA kernel has no CPU mode).  Run on an
H100 with ``PYTHONPATH=src python -m pytest -q tests/test_torch_variants_cuda.py``.
The direct variants repeat the plain version's per-pair arithmetic, so
each kernel's maxima must equal its plain version's and the ``seqacc``
kernel's bitwise; ``gram`` rounds the FP64 tensor-core product once, as its
plain version rounds a float64 product, and is held to rtol 1e-6 (the two
float64 sums may round apart before the float32 rounding).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import BatchedExtractor, ShapeFeatureExtractor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import diameter, ref  # noqa: E402
from repro_torch.runtime import autotune  # noqa: E402

pytestmark = pytest.mark.cuda

VARIANTS = diameter.VARIANTS
GRAM_PLAIN_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _autotune_cache(tmp_path, monkeypatch):
    """Each test's 'auto' sweeps go to a cache file of its own."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _agree(got, want, variant):
    if variant == "gram":
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=GRAM_PLAIN_RTOL)
    else:
        assert torch.equal(got, want), (variant, got, want)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("m", [1, 2, 513, 4096])
@pytest.mark.parametrize("block", [128, 256])
def test_variant_kernel_matches_plain(dev, variant, m, block):
    rng = np.random.default_rng(m)
    verts = torch.from_numpy((rng.normal(size=(m, 3)) * 50 + 200).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(m) < 0.7).to(dev)
    mask[m // 2] = True
    before = diameter.LAUNCHES[variant]
    k = diameter.max_diameters_sq(verts, mask, block=block, variant=variant)
    torch.cuda.synchronize()
    assert diameter.LAUNCHES[variant] == before + (4 if variant == "naive" else 1)
    assert bool(torch.isfinite(k).all())
    _agree(k, ref.max_diameters_sq(verts, mask, block, variant), variant)
    _agree(k, diameter.max_diameters_sq(verts, mask, block=block), variant)  # seqacc's kernel


TILE_VARIANTS = ("fused", "tri", "naive", "tri_prefetch", "gram")
SCHEDULED = ("tri_prefetch", "gram")  # diameter_sched_launch


def _tile_masks(m, block, rng):
    """The masked tile kernels' skip cases on a list of ``m`` slots."""
    s = np.arange(m)
    hole = np.ones(m, bool)
    hole[block:2 * block] = False
    one = np.zeros(m, bool)
    one[m // 2] = True
    return {"random": rng.random(m) < 0.6, "row_tile_hole": hole, "one_valid": one,
            "none_valid": np.zeros(m, bool), "past_diagonal": s >= block + 3,
            "tile_borders": (s // block) % 2 == 0,
            "tile_borders_off_by_one": ((s + 1) // block) % 2 == 0,
            "prefix": s < 2 * block + 5}


def _raw_launch(v, m, block, variant):
    """The variant's C entry on a prepared (B, 3, Mp) input and (B, Mp)
    mask as given (no fill): (B, 4) maxima, 'naive' one launch a combo."""
    lib = diameter._build.load("diameter", diameter._SIGNATURES)
    batch, _, mp = v.shape
    nb = mp // block
    stream = torch.cuda.current_stream(v.device).cuda_stream
    outs = []
    combos = [1 << c for c in range(4)] if variant == "naive" else [0xF]
    for combo in combos:
        ntiles = nb * (nb + 1) // 2 if variant in SCHEDULED else nb * nb
        partials = torch.empty(4 * ntiles * batch, device=v.device)
        out = torch.empty((batch, 4), device=v.device)
        if variant in SCHEDULED:
            ij = diameter._schedule(nb, v.device)
            err = lib.diameter_sched_launch(v.data_ptr(), m.data_ptr(), ij.data_ptr(), ntiles,
                                            batch, mp, block, int(variant == "gram"),
                                            partials.data_ptr(), out.data_ptr(), stream)
        else:
            err = lib.diameter_partial_launch(v.data_ptr(), m.data_ptr(), batch, mp, block,
                                              int(variant == "tri"), combo, partials.data_ptr(),
                                              out.data_ptr(), stream)
        assert err == 0, err
        outs.append(out)
    if variant == "naive":
        return torch.stack([o[:, c] for c, o in enumerate(outs)], dim=1)
    return outs[0]


@pytest.mark.parametrize("variant", TILE_VARIANTS)
@pytest.mark.parametrize("block", range(32, 1025, 32))
def test_tile_variants_at_every_block(dev, variant, block):
    """The hoisted mask's skip cases at every block the kernels take: the
    prepared input == the plain version and seqacc's kernel (gram rtol
    1e-6); an unfilled input (invalid slots far out, where only the mask
    keeps them out of the maxima) == the plain select on every pair."""
    rng = np.random.default_rng(block)
    m = 3 * block + 11
    verts = torch.from_numpy((rng.normal(size=(m, 3)) * [40, 70, 25] + 150).astype(np.float32))
    for name, mask in _tile_masks(m, block, rng).items():
        v, k = verts.to(dev), torch.from_numpy(mask).to(dev)
        got = diameter.max_diameters_sq(v, k, block=block, variant=variant)
        _agree(got, ref.max_diameters_sq(v, k, block, variant), variant)
        _agree(got, diameter.max_diameters_sq(v, k, block=block), variant)
        raw = ref.diameter_input_batch(v[None], torch.ones_like(k)[None], block).clone()
        mk = ref.diameter_mask_batch(k[None], block)
        raw[:, :, ~mk[0]] += 1e4
        got = _raw_launch(raw, mk, block, variant)[0]
        if variant == "naive":
            want = torch.cat([ref.pair_sweep(raw[0], mk[0], (c,)) for c in range(4)])
        else:
            want = ref.pair_sweep(raw[0], mk[0], gram=variant == "gram")
        _agree(got, want, variant)
        assert not mask.any() or bool((got < 1e7).all()), (name, got)  # no far slot counted


@pytest.mark.parametrize("variant", TILE_VARIANTS)
@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("block", [128, 256])
def test_tile_variant_stacks_with_differing_valid_regions(dev, variant, batch, block):
    """Stacks whose lists hold their valid slots in different tiles: the
    stack == the plain version and seqacc's kernel (gram rtol 1e-6), and
    each row == its batch of one bitwise."""
    rng = np.random.default_rng(batch * block)
    m = 5 * block - 9
    verts = (rng.normal(size=(batch, m, 3)) * [40, 70, 25] + 150).astype(np.float32)
    masks = np.zeros((batch, m), bool)
    for b in range(batch):
        lo = int(rng.integers(0, m - 1))
        hi = int(rng.integers(lo + 1, m + 1))
        masks[b, lo:hi] = rng.random(hi - lo) < (0.3 + 0.7 * (b % 2))
        masks[b, lo] = True
    v, k = torch.from_numpy(verts).to(dev), torch.from_numpy(masks).to(dev)
    got = diameter.max_diameters_sq_batch(v, k, block=block, variant=variant)
    _agree(got, ref.max_diameters_sq_batch(v, k, block, variant), variant)
    _agree(got, diameter.max_diameters_sq_batch(v, k, block=block), variant)
    for b in range(batch):
        assert torch.equal(got[b], diameter.max_diameters_sq(v[b], k[b], block=block,
                                                             variant=variant)), (variant, b)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_batch_equals_single(dev, variant):
    rng = np.random.default_rng(4)
    m = 1000
    verts = torch.from_numpy((rng.normal(size=(5, m, 3)) * 50 + 200).astype(np.float32)).to(dev)
    masks = torch.from_numpy(rng.random((5, m)) < 0.7).to(dev)
    masks[:, m // 2] = True
    masks[4, :] = False
    masks[4, 3] = True  # one valid vertex: all maxima 0
    got = diameter.max_diameters_sq_batch(verts, masks, block=128, variant=variant)
    _agree(got, ref.max_diameters_sq_batch(verts, masks, 128, variant), variant)
    assert torch.equal(got[4], torch.zeros(4, device=dev))
    for b in range(len(verts)):
        assert torch.equal(got[b], diameter.max_diameters_sq(verts[b], masks[b], block=128,
                                                             variant=variant))


@pytest.mark.parametrize("seed", range(3))
def test_gram_kernel_at_paper_scale(dev, seed):
    rng = np.random.default_rng(seed)
    verts = (rng.uniform(0.0, 1.0, size=(384, 3)) * 512 * [0.7, 0.7, 5.0]).astype(np.float32)
    v = verts.astype(np.float64)
    q = (v[:, None, :] - v[None, :, :]) ** 2
    want = np.sqrt([p.max() for p in (q.sum(-1), q[..., 0] + q[..., 1],
                                       q[..., 0] + q[..., 2], q[..., 1] + q[..., 2])])
    t = torch.from_numpy(verts).to(dev)
    got = diameter.max_diameters(t, torch.ones(384, dtype=torch.bool, device=dev), block=128,
                                 variant="gram").double().cpu().numpy()
    assert np.max(np.abs(got - want) / want) < 1e-3


def _extent_case(mp, extent, seed, batch=1):
    """(batch, mp) lists, each with scattered valid slots below ``extent``
    and its last valid slot at ``extent - 1``."""
    rng = np.random.default_rng(seed)
    verts = (rng.normal(size=(batch, mp, 3)) * [40.0, 70.0, 25.0] + 150.0).astype(np.float32)
    masks = rng.random((batch, mp)) < 0.5
    masks[:, extent:] = False
    masks[:, extent - 1] = True
    return torch.from_numpy(verts), torch.from_numpy(masks)


@pytest.mark.parametrize("variant", ["seqacc", "nomask"])
@pytest.mark.parametrize("block", sorted({64, 1024, *autotune.DEFAULT_BLOCKS}))
def test_extent_sweep_matches_plain_at_tile_edges(dev, variant, block):
    """The persistent sweep computes only the tiles of each list's extent;
    at extents 1, tile - 1, tile, tile + 1 and the whole list, with
    scattered masks, it equals the plain whole-list sweep bitwise."""
    mp = 3 * block
    for extent in (1, block - 1, block, block + 1, mp):
        verts, masks = _extent_case(mp, extent, seed=block + extent)
        verts, masks = verts.to(dev), masks.to(dev)
        assert int(ref.list_extent(masks)[0]) == extent
        before = diameter.LAUNCHES[variant]
        got = diameter.max_diameters_sq_batch(verts, masks, block=block, variant=variant)
        torch.cuda.synchronize()
        assert diameter.LAUNCHES[variant] == before + 1
        want = ref.max_diameters_sq_batch(verts, masks, block, variant)
        assert torch.equal(got, want), (variant, block, extent, got, want)


@pytest.mark.parametrize("block", [128, 256])
def test_extent_stack_rows_equal_their_batch_of_one(dev, block):
    """Rows of one stack with different extents: each row is its batch of
    one bitwise, and seqacc == nomask == the unchanged direct variants."""
    mp = 8 * block
    rows = [_extent_case(mp, e, seed=e) for e in (1, block - 1, 3 * block + 5, 6 * block, mp)]
    verts = torch.cat([v for v, _ in rows]).to(dev)
    masks = torch.cat([m for _, m in rows]).to(dev)
    got = {v: diameter.max_diameters_sq_batch(verts, masks, block=block, variant=v)
           for v in VARIANTS if v != "gram"}
    assert torch.equal(got["seqacc"], ref.max_diameters_sq_batch(verts, masks, block))
    for variant, out in got.items():
        assert torch.equal(out, got["seqacc"]), variant
    for variant in ("seqacc", "nomask"):
        for b in range(len(verts)):
            one = diameter.max_diameters_sq(verts[b], masks[b], block=block, variant=variant)
            assert torch.equal(got[variant][b], one), (variant, b)


def test_sweep_grid_is_fixed_by_the_padded_shape(dev):
    """The persistent grid depends on the block, the depth and the padded
    list only: never on an extent (which would need a host sync)."""
    lib = diameter._build.load("diameter", diameter._SIGNATURES)
    for variant in ("seqacc", "nomask"):
        for block in (128, 256, 512):
            g1 = diameter.sweep_grid(lib, block, variant, 1, 10 ** 6, dev)
            g4 = diameter.sweep_grid(lib, block, variant, 4, 10 ** 6, dev)
            assert g1 >= torch.cuda.get_device_properties(dev).multi_processor_count
            assert g4 == -(-g1 // 4)
            assert diameter.sweep_grid(lib, block, variant, 1, 3, dev) == 3


def test_schedule_is_built_once_per_size(dev):
    v = torch.randn((1, 600, 3), device=dev)
    m = torch.ones((1, 600), dtype=torch.bool, device=dev)
    diameter.max_diameters_sq_batch(v, m, block=128, variant="tri_prefetch")
    ij, ready = diameter._SCHEDULES[(5, v.device)]  # the schedule and its copy's event
    assert torch.equal(ij.cpu(), ref.tile_schedule(5)) and ready is not None
    diameter.max_diameters_sq_batch(v, m, block=128, variant="nomask")
    assert diameter._SCHEDULES[(5, v.device)][0] is ij


def test_variant_wrappers_refuse_bad_inputs(dev):
    v = torch.zeros((4, 3), device=dev)
    m = torch.ones(4, dtype=torch.bool, device=dev)
    for variant in VARIANTS:
        with pytest.raises(ValueError):
            diameter.max_diameters_sq(v, m, block=100, variant=variant)
        with pytest.raises(ValueError):
            diameter.max_diameters_sq(v.double(), m, variant=variant)
    with pytest.raises(ValueError):
        diameter.max_diameters_sq(v, m, variant="bogus")


def test_real_sweep_roundtrip(dev, tmp_path):
    """A cold lookup sweeps on the card and stores the argmin of its own
    table; the second lookup launches nothing."""
    sweeps = autotune.SWEEPS
    cfg = autotune.get_diameter_config(2048, dev, batch=3)
    assert autotune.SWEEPS == sweeps + 1
    rec = json.load(open(tmp_path / "autotune.json"))["entries"]["diameter/cuda/M2048/B4"]
    assert rec["table"][f"{cfg.variant}/{cfg.block}"] == min(rec["table"].values())
    assert cfg.variant in autotune.DEFAULT_VARIANTS
    launches = dict(diameter.LAUNCHES)
    assert autotune.get_diameter_config(2048, dev, batch=4) == cfg
    assert diameter.LAUNCHES == launches and autotune.SWEEPS == sweeps + 1
    assert autotune.get_compact_config(4096, dev, batch=2).block in autotune.DEFAULT_COMPACT_BLOCKS
    assert autotune.get_family_config("glcm", (32, 32, 32), dev).block in \
        autotune.DEFAULT_GLCM_BLOCKS
    assert autotune.SWEEPS == sweeps + 3


def test_extractors_take_every_variant(dev):
    cases = [synthetic.make_case(s, seed=seed) for s, seed in
             [((24, 20, 16), 1), ((50, 24, 20), 2), ((52, 28, 22), 4)]]
    base = np.stack(BatchedExtractor(variant="seqacc").run(cases)[0])
    single = ShapeFeatureExtractor(diameter_variant="seqacc").execute(*cases[1])
    keys = ["Maximum3DDiameter", "Maximum2DDiameterSlice", "Maximum2DDiameterRow",
            "Maximum2DDiameterColumn"]
    for variant in ("auto",) + VARIANTS:
        before = dict(diameter.LAUNCHES)
        rows = np.stack(BatchedExtractor(variant=variant).run(cases)[0])
        feats = ShapeFeatureExtractor(diameter_variant=variant).execute(*cases[1])
        if variant != "auto":
            assert diameter.LAUNCHES[variant] > before[variant], variant
        got, want = np.array([feats[k] for k in keys]), np.array([single[k] for k in keys])
        if variant == "gram":
            np.testing.assert_allclose(rows, base, rtol=GRAM_PLAIN_RTOL)
            np.testing.assert_allclose(got, want, rtol=GRAM_PLAIN_RTOL)
        else:
            np.testing.assert_array_equal(rows, base, err_msg=variant)
            np.testing.assert_array_equal(got, want, err_msg=variant)
