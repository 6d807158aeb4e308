"""The masked tile kernels' rules, modelled in torch, against the plain version.

``csrc/diameter.cu`` applies the mask of 'fused', 'tri', 'naive',
'tri_prefetch' and 'gram' outside the pair loop (``plan_tile``): a tile with no valid row or
no valid column is skipped, only a tile's valid columns are staged (in
order, padded to the kernel's unit with copies of the first valid one),
and an invalid row's maxima are reset once after the loop.  The model
below follows those rules on the plain version's own per-axis squares and
must equal ``ref.pair_sweep``'s select on every pair bitwise, for every
variant (``gram`` too) and mask; the counted work
(``diameter.computed_pairs`` and the estimates built on it) must equal a
brute-force count of the tiles the model computes.  CPU only, small lists.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import diameter, ref

TILE_VARIANTS = ("fused", "tri", "naive", "tri_prefetch", "gram")
TRIANGULAR = ("tri", "tri_prefetch", "gram")  # the upper triangle only
BLOCKS = (32, 64, 96)
NTILES = 5  # tiles a side of every list


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These cases' tensors are small: one intra-op thread runs them about
    as fast alone, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(block):
    """Masks of a list of ``NTILES * block - 7`` slots, by name."""
    m = NTILES * block - 7
    rng = np.random.default_rng(block)
    s = np.arange(m)
    hole = np.ones(m, bool)
    hole[2 * block:3 * block] = False
    one = np.zeros(m, bool)
    one[m // 2] = True
    return {
        "random": rng.random(m) < 0.6,
        "row_tile_hole": hole,  # a wholly invalid tile inside valid ones
        "one_valid": one,
        "none_valid": np.zeros(m, bool),
        "past_diagonal": s >= 2 * block + 3,  # no valid slot in tiles 0 and 1
        "last_tile_only": s >= (NTILES - 1) * block,
        "tile_borders": (s // block) % 2 == 0,  # changes at every tile border
        "tile_borders_off_by_one": ((s + 1) // block) % 2 == 0,
        "prefix": s < 3 * block + 5,  # the main path's active-first list
    }


MASK_NAMES = tuple(_masks(32))


def _list(block, name):
    masks = _masks(block)
    m = len(masks[name])
    rng = np.random.default_rng(7 * block + len(name))
    verts = (rng.normal(size=(m, 3)) * [40.0, 70.0, 25.0] + 150.0).astype(np.float32)
    return torch.from_numpy(verts), torch.from_numpy(masks[name])


def hoisted_sweep(v, mask, block, combos, gram, triangular, unit):
    """The masked tile kernels' maxima under the hoisted-mask rules, on
    the (Mp, Mp) per-axis squares ``pair_sweep`` forms for a list of at
    most 4096 slots (one row block: the same call, the same bits)."""
    mp = v.shape[1]
    axes = sorted({a for c in combos for a in ref.COMBOS[c]})
    q = ref._axis_squares(v, 0, mp, axes, gram)
    sums = []
    for c in combos:
        first, *rest = ref.COMBOS[c]
        s = q[first]
        for a in rest:
            s = s + q[a]
        sums.append(s)
    best = torch.full((len(combos),), ref.NEG, dtype=torch.float32)
    nb = mp // block
    for i in range(nb):
        rm = mask[i * block:(i + 1) * block]
        for j in range(nb):
            cm = mask[j * block:(j + 1) * block]
            if (triangular and j < i) or not rm.any() or not cm.any():
                continue  # the tile's empty partial
            cols = j * block + torch.nonzero(cm).reshape(-1)  # staged in order
            pad = -len(cols) % unit
            cols = torch.cat([cols, cols[:1].expand(pad)])  # copies of the first
            for k, s in enumerate(sums):
                row_max = s[i * block:(i + 1) * block][:, cols].amax(1)
                row_max = torch.where(rm, row_max, torch.tensor(ref.NEG))  # the row reset
                best[k] = torch.maximum(best[k], row_max.amax())
    return best.clamp(min=0.0)


def unfilled_input(verts, mask, block):
    """(3, Mp) SoA of ``verts`` with every invalid and padding slot moved
    far out (x + 1e4): unlike the prepared input, whose filled slots
    duplicate a valid vertex, a pair with such an end wins every maximum
    unless the mask drops it."""
    v = ref.diameter_input_batch(verts[None], torch.ones_like(mask)[None], block)[0].clone()
    m = ref.diameter_mask_batch(mask[None], block)[0]
    v[:, ~m] += 1e4
    return v


def _model(verts, mask, block, variant, filled=True):
    """The model of ``variant``'s launches on one list: (4,) maxima."""
    v = (ref.diameter_input_batch(verts[None], mask[None], block)[0] if filled
         else unfilled_input(verts, mask, block))
    m = ref.diameter_mask_batch(mask[None], block)[0]
    unit = diameter.column_unit(block, variant)
    tri = variant in TRIANGULAR
    if variant == "naive":  # one launch a combo
        return torch.cat([hoisted_sweep(v, m, block, (c,), False, False, unit)
                          for c in range(len(ref.COMBOS))])
    return hoisted_sweep(v, m, block, (0, 1, 2, 3), variant == "gram", tri, unit)


@pytest.mark.parametrize("name", MASK_NAMES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("variant", TILE_VARIANTS)
def test_hoisted_mask_equals_select_on_every_pair(variant, block, name):
    verts, mask = _list(block, name)
    got = _model(verts, mask, block, variant)
    want = ref.max_diameters_sq(verts, mask, block, variant)  # pair_sweep, a select a pair
    assert torch.equal(got, want), (variant, block, name, got, want)
    if variant != "gram":  # the direct variants also equal the unmasked sweep
        assert torch.equal(got, ref.max_diameters_sq(verts, mask, block, "seqacc"))
    if not mask.any():
        assert torch.equal(got, torch.zeros(4))


@pytest.mark.parametrize("name", MASK_NAMES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("variant", TILE_VARIANTS)
def test_hoisted_mask_on_an_unfilled_list(variant, block, name):
    """Invalid slots far out: the skips and the row reset decide the bits."""
    verts, mask = _list(block, name)
    got = _model(verts, mask, block, variant, filled=False)
    v = unfilled_input(verts, mask, block)
    m = ref.diameter_mask_batch(mask[None], block)[0]
    if variant == "naive":
        want = torch.cat([ref.pair_sweep(v, m, (c,)) for c in range(len(ref.COMBOS))])
    else:
        want = ref.pair_sweep(v, m, gram=variant == "gram")
    assert torch.equal(got, want), (variant, block, name, got, want)
    assert torch.equal(want, ref.max_diameters_sq(verts, mask, block, variant))


def _brute_force(mask, block, variant):
    """(computed tiles, computed pairs) of one list, tile by tile."""
    m = ref.diameter_mask_batch(mask[None], block)[0].numpy()
    nb = len(m) // block
    unit = diameter.column_unit(block, variant)
    tiles = pairs = 0
    for i in range(nb):
        for j in range(nb):
            rows, cols = m[i * block:(i + 1) * block], m[j * block:(j + 1) * block]
            if variant in TRIANGULAR and j < i:
                continue
            if rows.any() and cols.any():
                tiles += 1
                pairs += block * (-(-int(cols.sum()) // unit) * unit)
    return tiles, pairs


@pytest.mark.parametrize("name", MASK_NAMES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("variant", TILE_VARIANTS)
def test_counted_work_matches_the_computed_tiles(variant, block, name):
    _, mask = _list(block, name)
    m = len(mask)
    tiles, pairs = _brute_force(mask, block, variant)
    assert diameter._computed_tiles(m, block, variant, mask=mask) == tiles
    assert diameter.computed_pairs(m, block, variant, mask=mask) == pairs
    per_pair = {"fused": 14, "tri": 14, "tri_prefetch": 14, "naive": 9 + 3 * 6,
                "gram": 3 + 4 + 4}[variant]
    assert diameter.flop_estimate(m, block, variant, mask=mask) == per_pair * pairs
    assert diameter.tensor_flop_estimate(m, block, variant, mask=mask) == (
        24 * pairs if variant == "gram" else 0)
    nb = NTILES
    scheduled = variant in ("tri_prefetch", "gram")  # the upper triangle's tiles only
    launched = nb * (nb + 1) // 2 if scheduled else nb * nb
    visited = nb * (nb + 1) // 2 if variant in TRIANGULAR else nb * nb
    sched = 8 if scheduled else 0
    per_launch = visited * (2 * block + sched) + tiles * 24 * block + 32 * launched + 16
    assert diameter.bytes_estimate(m, block, variant, mask=mask) == per_launch * (
        4 if variant == "naive" else 1)


@pytest.mark.parametrize("block", [32, 64, 96, 128, 256, 512, 1024])
def test_column_unit_divides_the_tile(block):
    """The staged columns, padded to the unit, fit the tile, and each
    column group's run is whole 16-byte loads."""
    for variant in TILE_VARIANTS:
        unit = diameter.column_unit(block, variant)
        assert block % unit == 0 and unit % 4 == 0
