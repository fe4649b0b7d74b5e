"""The grouped k=3 conv kernel's row order and weight tiles, without a card:
(a) every grouped map of a build_unet_geometry pyramid (ResUNetSmall2 at
one and two pairs, with and without truncated levels; self, strided,
transposed and adjoint maps) carries the order the kernel reads its rows
in, held to a numpy reference (a stable sort of the rows' used-group
masks) and each 64-row tile's groups; (b) the plain version walked as
the kernel walks a map (a tile takes only the groups in its mask) gives
the plain version's own bits, in the map's order and in any other; (c)
the bf16 weight tiles' layout, decoded in numpy, and their cache, which
an in-place update of the weights (as the optimizer's) invalidates. The
kernels (csrc/grouped_row_order.cu, csrc/sparse_conv_grouped.cu) run
only on the card: chip_smoke.py's grouped_row_order, grouped_layer and
grouped_forced lines hold them to these plain versions there."""
import pathlib
import re

import numpy as np
import pytest
import torch

from _torch_parity import t, voxel_cloud
from umeregrobust_tpu_torch.models.resunet import ARCHS, build_unet_geometry
from umeregrobust_tpu_torch.ops import cuda_grouped
from umeregrobust_tpu_torch.ops.sparse import (
    GroupedMap, group_kernel_map, sparse_conv_grouped_ordered_plain,
    sparse_conv_grouped_plain)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CAPS = (192, 160, 128, 96, 64)
TIGHT = (192, 40, 16, 8, 4)  # every level past the first truncated


def _pyramid(pairs, caps):
    coords, mask = [], []
    for b in range(pairs):
        c4, m = voxel_cloud(3 + b, n_vox=170, cap=192)
        c4[:, 0] = np.where(m, c4[:, 0] + 2 * b, c4[:, 0])
        coords.append(c4)
        mask.append(m)
    return build_unet_geometry(t(np.concatenate(coords)),
                               t(np.concatenate(mask)),
                               ARCHS["ResUNetSmall2"], caps, pairs=pairs)


PYRAMIDS = {"one_pair": (1, CAPS), "two_pairs": (2, CAPS),
            "one_pair_truncated": (1, TIGHT),
            "two_pairs_truncated": (2, TIGHT)}


@pytest.fixture(scope="module")
def pyramids():
    return {k: _pyramid(*v) for k, v in PYRAMIDS.items()}


def _maps(geom, kind):
    """The pyramid's grouped maps of one kind (with their input rows):
    block (self) maps, encoder (strided) maps, decoder (transposed) maps,
    and the adjoint of each encoder map (the decoder map its dX runs
    over, as ResUNet._forward hands it)."""
    rows = [int(lv.coords.shape[0]) for lv in geom["levels"]]
    L = len(rows)
    if kind == "self":
        return [(m, rows[i]) for i, m in enumerate(geom["block_g"])]
    if kind == "strided":
        return [(geom["enc_g"][i], rows[i - 1]) for i in range(1, L)]
    if kind == "transposed":
        return [(geom["dec_g"][d], rows[L - 1 - d]) for d in range(L - 1)]
    return [(geom["dec_g"][L - 1 - i], rows[i]) for i in range(1, L)]


def _numpy_order(gmap):
    """The reference: keys = sum of 2^g over groups whose window has a
    slot that reads; a stable sort of the keys; each 64-row tile's OR."""
    masks, patho = gmap.masks.numpy(), gmap.patho.numpy()
    used = masks.any(axis=1) | patho  # (9, N)
    key = (used.astype(np.int64) << np.arange(9)[:, None]).sum(0)
    order = np.argsort(key, kind="stable")
    n = len(key)
    kt = np.zeros(-(-n // 64) * 64, np.int64)
    kt[:n] = key[order]
    tiles = np.bitwise_or.reduce(kt.reshape(-1, 64), axis=1)
    return key, order, tiles


@pytest.mark.parametrize("kind", ["self", "strided", "transposed",
                                  "adjoint"])
@pytest.mark.parametrize("pyr", list(PYRAMIDS))
def test_pyramid_maps_carry_the_reference_row_order(pyramids, pyr, kind):
    geom = pyramids[pyr]
    maps = _maps(geom, kind)
    assert maps
    for gmap, _ in maps:
        assert gmap.order.dtype == gmap.tiles.dtype == torch.int32
        key, order, tiles = _numpy_order(gmap)
        np.testing.assert_array_equal(gmap.order.numpy(), order)
        np.testing.assert_array_equal(gmap.tiles.numpy(), tiles)
        # the order is a permutation whose keys never fall, and a tile's
        # mask holds every group its rows use
        assert np.array_equal(np.sort(order), np.arange(len(key)))
        assert (np.diff(key[order]) >= 0).all()
        tile_of = np.empty(len(key), np.int64)
        tile_of[order] = np.arange(len(key)) // 64
        assert (key & ~tiles[tile_of] == 0).all()
    # each map is ordered once: the stem's map is level 0's block map
    assert geom["enc_g"][0] is geom["block_g"][0]


def test_order_constants_match_the_kernel():
    src = (ROOT / "umeregrobust_tpu_torch" / "csrc"
           / "grouped_row_order.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kTileRows"], const["kKeys"], const["kMaxMaps"],
            const["kMaxCluster"]) == (
        cuda_grouped._ORDER_TILE, cuda_grouped._ORDER_KEYS,
        cuda_grouped._ORDER_MAX_MAPS, cuda_grouped._ORDER_MAX_CLUSTER)
    assert const["kKeys"] == 2 ** 9  # a 9-bit group mask
    assert const["kThreads"] == const["kKeys"]  # a thread a key
    rows = re.search(r"constexpr long long kMaxRows = \(1ll << (\d+)\) - "
                     r"(\d+);", src)
    assert 2 ** int(rows.group(1)) - int(rows.group(2)) == \
        cuda_grouped._ORDER_MAX_ROWS
    assert 1 <= cuda_grouped._ORDER_CLUSTER <= const["kMaxCluster"]
    # the cap on maps a launch covers every arch's pyramid: at most one
    # self map a level, one strided map into each level past the first
    # (the stem's is level 0's self map) and one transposed map back
    for name, arch in ARCHS.items():
        assert 3 * len(arch.channels) - 2 <= const["kMaxMaps"], name


def _distinct_maps(geom):
    return list({id(m): m for k in ("enc_g", "block_g", "dec_g")
                 for m in geom[k]}.values())


@pytest.mark.parametrize("pyr", ["one_pair", "two_pairs",
                                 "two_pairs_truncated"])
def test_orders_of_a_pyramid_are_each_maps_plain_order(pyramids, pyr):
    # the list form gives each map what the one-map plain version gives
    # it, in the list's order; a map given twice gets its result twice
    maps = _distinct_maps(pyramids[pyr])
    assert len(maps) == 13  # ResUNetSmall2: 5 self, 4 strided, 4 transposed
    bare = [m._replace(order=None, tiles=None) for m in maps]
    listed = bare + [bare[3]]
    got = cuda_grouped.grouped_row_orders_plain(listed)
    assert len(got) == len(listed)
    for m, (order, tiles) in zip(listed, got):
        want_order, want_tiles = cuda_grouped.grouped_row_order_plain(m)
        assert torch.equal(order, want_order)
        assert torch.equal(tiles, want_tiles)
    assert torch.equal(got[-1][0], got[3][0])
    # the wrapper on CPU maps takes the plain version, launching nothing;
    # the pyramid's maps carry those orders
    before = cuda_grouped.LAUNCHES["grouped_row_order"]
    for (o1, t1), (o2, t2), m in zip(cuda_grouped.grouped_row_orders(bare),
                                     got, maps):
        assert torch.equal(o1, o2) and torch.equal(t1, t2)
        assert torch.equal(m.order, o2) and torch.equal(m.tiles, t2)
    assert cuda_grouped.LAUNCHES["grouped_row_order"] == before
    assert cuda_grouped.grouped_row_orders([]) == []


def test_with_row_orders_keeps_the_maps_that_carry_one(pyramids):
    maps = _distinct_maps(pyramids["one_pair"])
    mixed = [m if i % 2 else m._replace(order=None, tiles=None)
             for i, m in enumerate(maps)]
    out = cuda_grouped.with_row_orders(mixed)
    for i, (m, o) in enumerate(zip(maps, out)):
        if i % 2:
            assert o is m  # carried its order: as it was
        assert torch.equal(o.order, m.order)
        assert torch.equal(o.tiles, m.tiles)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_row_orders_refuse_more_maps_than_a_launch_takes(device):
    # past the cap the wrapper raises, on the CPU as on the card, before
    # it looks for the kernel; at the cap it runs
    gmap = _forced_map(9, 40, 50)
    gmap = gmap._replace(masks=gmap.masks.to(device),
                         patho=gmap.patho.to(device))
    cap = cuda_grouped._ORDER_MAX_MAPS
    with pytest.raises(ValueError, match="at most 16 maps"):
        cuda_grouped.grouped_row_orders([gmap] * (cap + 1))
    if device == "cpu":
        assert len(cuda_grouped.grouped_row_orders([gmap] * cap)) == cap


def _forced_map(seed, n_in, n_out, p=0.5, transposed=False, edit=None):
    rng = np.random.default_rng(seed)
    center = rng.integers(0, n_in + 4, (9, n_out))
    masks = rng.random((9, 3, n_out)) < p
    pat = (rng.random((9, n_out)) < 0.05) & ~masks[:, 2]
    if edit is not None:
        edit(center, masks, pat)
    return GroupedMap(center=t(center), masks=t(masks), patho=t(pat),
                      worder=torch.tensor([2, 1, 0] if transposed
                                          else [0, 1, 2]))


def _group8_in_row0_only(center, masks, pat):
    masks[8], pat[8] = False, False
    masks[8, 1, 0] = True  # its one user is row 0...
    masks[:8, 1] = True  # ...whose mask is the highest: the last place


def _nothing_used(center, masks, pat):
    masks[:], pat[:] = False, False


@pytest.mark.parametrize("case", ["ragged", "group8_last", "unused"])
def test_row_order_edge_cases(case):
    if case == "ragged":  # N_out no multiple of 64, mixed masks
        gmap = _forced_map(1, 300, 201, p=0.2)
    elif case == "group8_last":
        gmap = _forced_map(2, 500, 700, edit=_group8_in_row0_only)
    else:
        gmap = _forced_map(3, 100, 130, edit=_nothing_used)
    order, tiles = cuda_grouped.grouped_row_order(gmap)
    _, want_order, want_tiles = _numpy_order(gmap)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(tiles.numpy(), want_tiles)
    assert tiles.shape == (-(-gmap.masks.shape[-1] // 64),)
    if case == "group8_last":
        assert int(order[-1]) == 0
        assert [int(x) >> 8 & 1 for x in tiles] == [0] * 10 + [1]
    if case == "unused":  # keys all 0: the code order, no group anywhere
        np.testing.assert_array_equal(order.numpy(), np.arange(130))
        assert not tiles.any()
    assert cuda_grouped.LAUNCHES["grouped_row_order"] == 0  # CPU: plain


def _inputs(seed, n_in, cin, cout):
    rng = np.random.default_rng(seed)
    f = t(rng.standard_normal((n_in, cin)).astype(np.float32))
    w = t((rng.standard_normal((27, cin, cout)) / np.sqrt(27 * cin))
          .astype(np.float32))
    b = t(rng.standard_normal(cout).astype(np.float32))
    return f, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["self", "strided", "transposed"])
@pytest.mark.parametrize("pyr", ["one_pair", "two_pairs_truncated"])
def test_plain_version_through_the_order_gives_its_own_bits(
        pyramids, pyr, kind, dtype):
    # a tile takes only the groups its mask names; the groups it skips
    # are all-zero windows for its rows, so every row keeps its bits
    pairs = PYRAMIDS[pyr][0]
    for j, (gmap, n_in) in enumerate(_maps(pyramids[pyr], kind)):
        f, w, b = _inputs(10 + j, n_in, 12, 20)
        want = sparse_conv_grouped_plain(f, w, gmap, b, dtype, pairs)
        got = sparse_conv_grouped_ordered_plain(f, w, gmap, b, dtype, pairs)
        assert torch.equal(got, want)


@pytest.mark.parametrize("order_kind", ["code", "reversed", "random"])
def test_plain_version_in_any_order_gives_its_own_bits(order_kind):
    gmap = _forced_map(4, 400, 450, p=0.15, transposed=True)
    n = gmap.masks.shape[-1]
    order = {"code": torch.arange(n, dtype=torch.int32),
             "reversed": torch.arange(n - 1, -1, -1, dtype=torch.int32),
             "random": torch.randperm(n, generator=torch.Generator()
                                      .manual_seed(5)).to(torch.int32)
             }[order_kind]
    tiled = gmap._replace(order=order,
                          tiles=cuda_grouped.tiles_of_order(gmap, order))
    f, w, b = _inputs(6, 400, 16, 8)
    want = sparse_conv_grouped_plain(f, w, gmap, b, torch.bfloat16)
    assert torch.equal(sparse_conv_grouped_ordered_plain(
        f, w, tiled, b, torch.bfloat16), want)


def test_a_tile_that_skips_a_used_group_is_caught():
    # the check above can fail: drop one used group from one tile's mask
    gmap = cuda_grouped.with_row_order(_forced_map(7, 300, 256, p=0.3))
    f, w, b = _inputs(8, 300, 8, 8)
    want = sparse_conv_grouped_plain(f, w, gmap, b)
    tiles = gmap.tiles.clone()
    g = int(torch.nonzero(tiles[1] >> torch.arange(9) & 1)[0])
    tiles[1] &= ~(1 << g)
    bad = sparse_conv_grouped_ordered_plain(f, w, gmap._replace(tiles=tiles),
                                            b)
    assert not torch.equal(bad, want)


def _decode_tiles(wt, cin, cout, cols):
    """numpy: the weight tiles back to a (9, 3 cin8, cout) bf16-valued
    array, K entry p cin8 + c of group g at block (g, k // 64, n // cols),
    row n % cols, piece (k % 64 // 8) ^ (n % 8), lane k % 8."""
    cin8 = -(-cin // 8) * 8
    steps = -(-3 * cin8 // 64)
    nt = -(-cout // cols)
    blocks = wt.float().numpy().reshape(9, steps, nt, cols, 8, 8)
    out = np.zeros((9, 3 * cin8, cout), np.float32)
    for k in range(3 * cin8):
        for n in range(cout):
            r = n % cols
            out[:, k, n] = blocks[:, k // 64, n // cols, r,
                                  (k % 64 // 8) ^ (r % 8), k % 8]
    return out, steps, nt


@pytest.mark.parametrize("dx_taps", [0, 1, 2])
@pytest.mark.parametrize("cin,cout", [(1, 32), (20, 7), (24, 48),
                                      (72, 130)])
def test_weight_tiles_hold_each_tap_at_its_k_place(cin, cout, dx_taps):
    rng = np.random.default_rng(cin * 7 + cout)
    w = rng.standard_normal((27, cin, cout)).astype(np.float32)
    # a dX's tiles: the conv of (27, Cout, Cin) weights read transposed
    conv_w = (w if dx_taps == 0 else
              np.swapaxes(w[::-1] if dx_taps == 2 else w, 1, 2))
    ci, co = conv_w.shape[1:]
    cols = cuda_grouped.grouped_plan(1, 1, ci, co).tile_cols
    wt = cuda_grouped.weight_tiles_plain(t(w), dx_taps)
    assert wt.dtype == torch.bfloat16
    got, steps, nt = _decode_tiles(wt, ci, co, cols)
    ci8 = -(-ci // 8) * 8
    want = np.zeros((9, 3, ci8, co), np.float32)
    want[:, :, :ci] = n_bf16(conv_w).reshape(9, 3, ci, co)
    np.testing.assert_array_equal(got, want.reshape(9, 3 * ci8, co))
    # every entry past Cin, 3 Cin8 and Cout is zero: the rest of the
    # tiles sums to what the decoded part holds
    assert float(wt.float().abs().sum()) == pytest.approx(
        float(np.abs(got).sum()), rel=1e-6)
    assert wt.numel() == 9 * steps * nt * cols * 64


def n_bf16(x):
    return t(np.ascontiguousarray(x)).to(torch.bfloat16).float().numpy()


@pytest.fixture
def fresh_cache():
    cuda_grouped.clear_weight_tiles()
    yield
    cuda_grouped.clear_weight_tiles()


def test_weight_tile_cache_is_invalidated_by_an_in_place_update(
        fresh_cache):
    w = torch.randn(27, 16, 24, generator=torch.Generator().manual_seed(1))
    a = cuda_grouped.weight_tiles(w)
    assert cuda_grouped.weight_tiles(w) is a  # cached
    assert cuda_grouped.weight_tiles(w.detach()) is a  # the same storage
    with torch.no_grad():
        w.sub_(1e-2 * torch.ones_like(w))  # as the optimizer updates
    b = cuda_grouped.weight_tiles(w)
    assert b is not a and not torch.equal(a, b)
    assert torch.equal(b, cuda_grouped.weight_tiles_plain(w))
    assert cuda_grouped.weight_tiles(w) is b
    with torch.no_grad():
        w[3].add_(1.0)  # an update through a view bumps the same counter
    c = cuda_grouped.weight_tiles(w)
    assert c is not b and torch.equal(c, cuda_grouped.weight_tiles_plain(w))


def test_weight_tile_cache_keys(fresh_cache):
    w = torch.randn(27, 8, 40, generator=torch.Generator().manual_seed(2))
    same = w.clone()  # equal values, its own storage: its own entry
    tiles = {d: cuda_grouped.weight_tiles(w, d) for d in (0, 1, 2)}
    assert len({id(x) for x in tiles.values()}) == 3  # a layout each
    for d in (0, 1, 2):
        assert torch.equal(tiles[d], cuda_grouped.weight_tiles_plain(w, d))
        assert cuda_grouped.weight_tiles(w, d) is tiles[d]
    assert cuda_grouped.weight_tiles(same) is not tiles[0]
    assert torch.equal(cuda_grouped.weight_tiles(same), tiles[0])
    # another channel tile (a plan that picks it) is another layout
    plan = cuda_grouped.grouped_plan
    try:
        cuda_grouped.grouped_plan = lambda *a, **k: plan(*a, **k)._replace(
            tile_cols=128)
        other = cuda_grouped.weight_tiles(w, 0)
    finally:
        cuda_grouped.grouped_plan = plan
    assert other is not tiles[0] and other.numel() != tiles[0].numel()
    assert cuda_grouped.weight_tiles(w, 0) is tiles[0]
    with torch.inference_mode():  # no version counter: never cached
        wi = torch.randn(27, 8, 40)
        x = cuda_grouped.weight_tiles(wi)
        assert cuda_grouped.weight_tiles(wi) is not x
    # the cache holds at most its size, the least recently used dropped
    ws = [torch.randn(27, 8, 8) for _ in range(cuda_grouped._TILE_CACHE_SIZE
                                               + 1)]
    first = cuda_grouped.weight_tiles(ws[0])
    for x in ws[1:]:
        cuda_grouped.weight_tiles(x)
    assert cuda_grouped.weight_tiles(ws[0]) is not first
    assert len(cuda_grouped._TILE_CACHE) <= cuda_grouped._TILE_CACHE_SIZE


def test_geometry_from_per_tap_maps_orders_like_the_pyramid(pyramids):
    # a map regrouped from its per-tap form gets the same order and tiles
    geom = pyramids["one_pair"]
    for d, gmap in enumerate(geom["dec_g"]):
        regrouped = cuda_grouped.with_row_order(
            group_kernel_map(geom["dec_maps"][d], z_reversed=True))
        assert torch.equal(regrouped.order, gmap.order)
        assert torch.equal(regrouped.tiles, gmap.tiles)
        assert cuda_grouped.with_row_order(gmap) is gmap  # made once
