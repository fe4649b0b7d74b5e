"""The grouped k=3 conv's backward in the port (ops/sparse.GroupedConv):
dX is the forward conv of dY over the adjoint map that the pyramid builds
beside each map, dW the sparse_conv_grouped_wgrad kernel. Here, without a
card: (a) the adjoint identities hold exactly on build_unet_geometry
pyramids; (b) the two routes' plain versions (the weight gradient's
plain version, the plain forward over the adjoint map) against jax.vjp
of the JAX package's ops/sparse.sparse_conv_grouped; (c) is in
tests/test_torch_grouped_conv.py (GroupedConv on CPU tensors against
autograd through the plain version); (d) a ResUNetSmall2 training
forward and backward with every grouped conv through GroupedConv against
the plain path; (e) the wrappers' refusals. The kernels themselves run
only on the card: chip_smoke.py phase 5j's grouped_bwd_layer and
grouped_wgrad_forced lines hold them to these plain versions there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t, voxel_cloud
from umeregrobust_tpu.ops.sparse import GroupedMap as JGroupedMap
from umeregrobust_tpu.ops.sparse import sparse_conv_grouped as jax_grouped
import umeregrobust_tpu_torch.models.resunet as resunet
from umeregrobust_tpu_torch.models.resunet import (
    ARCHS, build_unet_geometry, init_resunet)
from umeregrobust_tpu_torch.ops import _build, cuda_grouped
from umeregrobust_tpu_torch.ops.sparse import (
    GroupedConv, GroupedMap, invert_map_batch, round_to,
    sparse_conv_grouped_plain, sparse_conv_grouped_wgrad_plain,
    ungroup_kernel_map)

CAPS = (192, 160, 128, 96, 64)
TIGHT = (192, 40, 16, 8, 4)  # every level past the first truncated


def _pyramid(arch, pairs, caps):
    """A pyramid of `pairs` pairs (two voxel clouds each, seeds 3, 4, ...)
    as tests/test_torch_grouped_conv.py builds it."""
    coords, mask = [], []
    for b in range(pairs):
        c4, m = voxel_cloud(3 + b, n_vox=170, cap=192)
        c4[:, 0] = np.where(m, c4[:, 0] + 2 * b, c4[:, 0])
        coords.append(c4)
        mask.append(m)
    return build_unet_geometry(t(np.concatenate(coords)),
                               t(np.concatenate(mask)), ARCHS[arch], caps,
                               pairs=pairs)


def _rows(geom):
    return [int(lv.coords.shape[0]) for lv in geom["levels"]]


@pytest.mark.parametrize("arch,pairs,caps", [
    ("ResUNetSmall2", 1, CAPS), ("ResUNetSmall2", 2, CAPS),
    ("ResUNetSmall2", 1, TIGHT), ("ResUNetSmall2", 2, TIGHT),
    ("ResUNet4", 1, CAPS + (32,))], ids=[
        "small2_one_pair", "small2_two_pairs", "small2_one_pair_truncated",
        "small2_two_pairs_truncated", "resunet4_generic_path"])
def test_adjoint_identities_hold_exactly(arch, pairs, caps):
    # each k3 map's scatter-inverse is, tap for tap, the ungrouped map
    # the model hands its backward: a self map's own with the taps
    # reversed, an encoder map's decoder map, a decoder map's encoder map
    geom = _pyramid(arch, pairs, caps)
    rows, ks = _rows(geom), ARCHS[arch].kernel_sizes
    L = len(rows)
    if caps == TIGHT:  # the capacities do cut levels 1-3 of every pair
        assert [int(lv.mask.sum()) for lv in geom["levels"][1:4]] == [
            c * pairs for c in caps[1:4]]
    checked = 0
    for lv in range(L):
        m = ungroup_kernel_map(geom["block_g"][lv])
        assert torch.equal(invert_map_batch(m, rows[lv]), m.flip(0)), lv
        checked += 1
    for i in range(1, L):
        if ks[i] != 3:
            continue
        enc = ungroup_kernel_map(geom["enc_g"][i])
        dec = ungroup_kernel_map(geom["dec_g"][L - 1 - i])
        assert int((enc >= 0).sum()) > 0
        assert torch.equal(invert_map_batch(enc, rows[i - 1]), dec), i
        assert torch.equal(invert_map_batch(dec, rows[i]), enc), i
        checked += 2
    assert checked >= (2 * L - 1 if all(k == 3 for k in ks) else L + 4)


@pytest.fixture(scope="module")
def maps():
    """(map, its adjoint, reverse_taps, N_in) of a self, a strided and a
    transposed conv of ResUNetSmall2 pyramids of one and two pairs."""
    out = {}
    for pairs in (1, 2):
        g = _pyramid("ResUNetSmall2", pairs, CAPS)
        rows = _rows(g)
        out[pairs] = {
            "self": (g["block_g"][1], g["block_g"][1], True, rows[1]),
            "strided": (g["enc_g"][1], g["dec_g"][-1], False, rows[0]),
            "transposed": (g["dec_g"][-1], g["enc_g"][1], False, rows[1])}
    return out


def _jax_map(gmap):
    return JGroupedMap(*(jnp.asarray(n(x).astype(np.int32))
                         if x.dtype == torch.int64 else jnp.asarray(n(x))
                         for x in gmap[:4]))


def _inputs(seed, n_in, n_out, cin, cout, bias):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n_in, cin)).astype(np.float32)
    w = (rng.standard_normal((27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    dy = rng.standard_normal((n_out, cout)).astype(np.float32)
    return f, w, b, dy


def _close(got, want, tol):
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("pairs", [1, 2])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("cout", [7, 48])
@pytest.mark.parametrize("cin", [1, 20, 96])
@pytest.mark.parametrize("which", ["self", "strided", "transposed"])
def test_backward_plain_versions_match_jax_vjp(maps, which, cin, cout, bias,
                                               pairs):
    # fp32: the same sums in another order, 1e-5 x max |JAX|
    gmap, adj, reverse, n_in = maps[pairs][which]
    n_out = gmap.center.shape[1]
    f, w, b, dy = _inputs(cin * 100 + cout, n_in, n_out, cin, cout, bias)
    jm = _jax_map(gmap)
    args = [jnp.asarray(f), jnp.asarray(w)] + ([] if b is None
                                               else [jnp.asarray(b)])
    _, vjp = jax.vjp(lambda *a: jax_grouped(
        a[0], a[1], jm, bias=a[2] if len(a) > 2 else None), *args)
    grads = [np.asarray(x) for x in vjp(jnp.asarray(dy))]
    dw = n(sparse_conv_grouped_wgrad_plain(t(f), t(dy), gmap))
    wv = t(w).flip(0) if reverse else t(w)
    dx = n(sparse_conv_grouped_plain(t(dy), wv.transpose(1, 2), adj, None,
                                     torch.float32, pairs))
    assert dx.shape == f.shape and dw.shape == w.shape
    _close(dx, grads[0], 1e-5)
    _close(dw, grads[1], 1e-5)
    if b is not None:
        _close(dy.sum(0), grads[2], 1e-5)


# The bf16 backward against JAX's autodiff (ROADMAP Queue 3 item 13, for
# this conv). jax.vjp of the JAX package's grouped conv at
# compute_dtype=bfloat16 takes dY unrounded, as both of the port's routes
# do (dY's hi and lo bf16 parts on the card). dX: JAX rounds each group's
# window cotangent to bf16 and adds the groups' and the three column
# blocks' shares in bf16 (the transposes of its gather and
# concatenations), where the port sums every product in fp32 and rounds
# dX once: entries land up to about one bf16 ulp of max |dX| apart (2^-8;
# measured up to 5.8e-3 x max here). dW: JAX's product of the rounded
# windows with the unrounded cotangent, in fp32, rounded once, is the
# port's, bit for bit.
BF16_JAX_LIMIT = 2 ** -7


@pytest.mark.parametrize("pairs", [1, 2])
@pytest.mark.parametrize("which", ["self", "strided", "transposed"])
def test_bf16_backward_against_jax_vjp(maps, which, pairs):
    gmap, adj, reverse, n_in = maps[pairs][which]
    n_out = gmap.center.shape[1]
    f, w, _, dy = _inputs(pairs * 10 + len(which), n_in, n_out, 20, 48,
                          False)
    jm = _jax_map(gmap)
    _, vjp = jax.vjp(lambda a, b: jax_grouped(a, b, jm,
                                              compute_dtype=jnp.bfloat16),
                     jnp.asarray(f), jnp.asarray(w))
    jdx, jdw = (np.asarray(x) for x in vjp(jnp.asarray(dy)))
    bf = torch.bfloat16
    dx = n(cuda_grouped.sparse_conv_grouped_dx(t(dy), t(w), adj, reverse,
                                               bf))
    dw = n(cuda_grouped.sparse_conv_grouped_wgrad(t(f), t(dy), gmap, bf))
    _close(dx, jdx, BF16_JAX_LIMIT)
    assert np.abs(jdw).max() > 0.05
    np.testing.assert_array_equal(dw, jdw)


def test_dy_hi_and_lo_parts_carry_dy():
    # the bf16 kernels take dY as hi = bf16(dY) and lo = bf16(dY - hi):
    # their sum is dY to within 2^-16 of each entry (2^-18 in fact: two
    # roundings of 2^-9 each)
    rng = np.random.default_rng(31)
    dy = t((rng.standard_normal((4096, 48))
            * np.exp(rng.uniform(-20, 20, (4096, 48)))).astype(np.float32))
    hi = dy.to(torch.bfloat16).to(torch.float32)
    lo = (dy - hi).to(torch.bfloat16).to(torch.float32)
    assert torch.equal(dy - hi, (dy.double() - hi.double()).float())
    err = ((hi.double() + lo.double()) - dy.double()).abs()
    assert float((err / dy.double().abs()).max()) <= 2 ** -16
    # hi alone, the rounding the weight gradient made before, is 2^-9
    assert float(((hi - dy).abs() / dy.abs()).max()) > 2 ** -12


def _patch_grouped(monkeypatch):
    """Every grouped conv of the model through GroupedConv (the card's
    autograd route; on CPU tensors its kernels' plain versions)."""
    def grouped(feats, w, gmap, bias=None, compute_dtype=torch.float32,
                pairs=1, adjoint=None):
        return GroupedConv.apply(feats, w, bias, gmap, adjoint, compute_dtype)

    monkeypatch.setattr(resunet, "sparse_conv_grouped", grouped)


def test_training_backward_through_grouped_conv_matches_the_plain_path(
        monkeypatch):
    # ResUNetSmall2 in training (per-cloud BN) on a two-pair pyramid at
    # fp32: every gradient leaf within 1e-4 of its max |grad| (the limit
    # tests/test_torch_train.py holds the port's step to against JAX)
    geom = _pyramid("ResUNetSmall2", 2, CAPS)
    rng = np.random.default_rng(21)
    feats_in = t(geom["levels"][0].mask.numpy()[geom["inv0"].numpy(), None]
                 .astype(np.float32))
    g = t(rng.standard_normal((feats_in.shape[0], 32)).astype(np.float32))
    grads = []
    for through in (False, True):
        model = init_resunet(ARCHS["ResUNetSmall2"], 1, 32, device="cpu",
                             generator=torch.Generator().manual_seed(5))
        with monkeypatch.context() as mp:
            if through:
                _patch_grouped(mp)
            out, _ = model(geom, feats_in, torch.float32, train=True)
        torch.sum(out * g).backward()
        grads.append({k: p.grad.detach().clone()
                      for k, p in model.named_parameters()})
    plain, routed = grads
    assert len(plain) == len(routed) == sum(
        1 for _ in init_resunet(ARCHS["ResUNetSmall2"], device="cpu")
        .parameters())
    for k, want in plain.items():
        scale = float(want.abs().max())
        assert scale > 0, k
        err = float((routed[k] - want).abs().max())
        assert err <= 1e-4 * scale, (k, err / scale)


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """A process that has no kernel library and cannot build one."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)


def _map(d, n_out=12, center_dtype=torch.int64):
    return GroupedMap(
        center=torch.zeros((9, n_out), dtype=center_dtype, device=d),
        masks=torch.zeros((9, 3, n_out), dtype=torch.bool, device=d),
        patho=torch.zeros((9, n_out), dtype=torch.bool, device=d),
        worder=torch.arange(3, device=d))


def _wgrad_args(case):
    """(feats, dout, gmap, compute_dtype) on the meta device with one
    fault (or none)."""
    d = "meta"
    f, dy = torch.zeros((10, 4), device=d), torch.zeros((12, 6), device=d)
    gmap, cd = _map(d), torch.bfloat16
    if case == "feats_dtype":
        f = f.to(torch.bfloat16)
    elif case == "dout_dtype":
        dy = dy.to(torch.float64)
    elif case == "dout_rows":
        dy = torch.zeros((11, 6), device=d)
    elif case == "feats_rank":
        f = torch.zeros((10, 4, 1), device=d)
    elif case == "center_dtype":
        gmap = _map(d, center_dtype=torch.int16)
    elif case == "masks_shape":
        gmap = gmap._replace(masks=torch.zeros((9, 12), dtype=torch.bool,
                                               device=d))
    elif case == "noncontiguous":
        dy = torch.zeros((6, 12), device=d).T
    elif case == "compute_dtype":
        cd = torch.float16
    return f, dy, gmap, cd


@pytest.mark.parametrize("case", [
    "feats_dtype", "dout_dtype", "dout_rows", "feats_rank", "center_dtype",
    "masks_shape", "noncontiguous", "compute_dtype"])
def test_wgrad_wrapper_refuses_what_the_kernel_does_not_take(case):
    # checked before the kernel library is looked for: a ValueError, never
    # the plain version
    with pytest.raises(ValueError):
        cuda_grouped.sparse_conv_grouped_wgrad(*_wgrad_args(case))


@pytest.mark.parametrize("call", [
    lambda: cuda_grouped.sparse_conv_grouped_wgrad(*_wgrad_args(None)),
    lambda: cuda_grouped.sparse_conv_grouped_dx(
        torch.zeros(12, 6, device="meta"),
        torch.zeros(27, 4, 6, device="meta"), _map("meta", 10), True,
        torch.bfloat16)], ids=["wgrad", "dx_route"])
def test_backward_kernels_raise_without_a_kernel_library(no_nvcc, call):
    # a CUDA-side tensor (here on the meta device) never takes the plain
    # version: without a library the wrapper raises
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call()


@pytest.mark.parametrize("width", [4, 7])
def test_dx_route_checks_the_transposed_weights(width):
    # the weights are the forward's (27, Cin, Cout): dY must be Cout wide
    with pytest.raises(ValueError):
        cuda_grouped.sparse_conv_grouped_dx(
            torch.zeros(12, width, device="meta"),
            torch.zeros(27, 4, 6, device="meta"), _map("meta", 10), False)


def test_input_gradient_without_an_adjoint_raises():
    gmap = _map("cpu")
    f = torch.zeros((10, 4), requires_grad=True)
    w = torch.zeros((27, 4, 6), requires_grad=True)
    out = GroupedConv.apply(f, w, None, gmap, None, torch.float32)
    with pytest.raises(ValueError, match="adjoint"):
        out.sum().backward()
    # the weights alone need no adjoint
    w2 = torch.zeros((27, 4, 6), requires_grad=True)
    GroupedConv.apply(f.detach(), w2, None, gmap, None,
                      torch.float32).sum().backward()
    assert w2.grad is not None and w2.grad.shape == w2.shape


@pytest.mark.parametrize("n_out,cin,cout,want", [
    # (kind, warpgroups, atoms, col_blocks, cout_blocks, ranges, stages)
    (262144, 32, 32, ("mma", 1, 2, 1, 1, 132, 4)),  # block1 at B = 8
    (262144, 1, 32, ("stem", 1, 1, 1, 1, 264, 4)),  # the stem: packed
    (2048, 256, 256, ("mma", 2, 2, 6, 2, 11, 4)),  # 12 atoms, 256 channels
    (10240, 64, 64, ("mma", 1, 3, 1, 1, 132, 4)),
    (20, 5, 7, ("mma", 1, 1, 1, 1, 132, 4)),  # one tile
    (196608, 192, 64, ("mma", 1, 3, 3, 1, 44, 4)),  # conv2_tr
    (106496, 256, 128, ("mma", 2, 2, 6, 1, 22, 4)),  # conv3_tr
    (300, 768, 256, ("mma", 2, 2, 18, 2, 3, 4)),
    (900, 2, 300, ("stem", 2, 1, 1, 3, 15, 4)),  # a run a tile
])
def test_wgrad_plan_is_a_rule_on_shapes(n_out, cin, cout, want):
    import re

    src = (_build.CSRC / "sparse_conv_grouped_wgrad.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    plan = cuda_grouped.wgrad_plan(n_out, cin, cout, torch.bfloat16)
    assert (plan.kind, plan.warpgroups, plan.atoms, plan.col_blocks,
            plan.cout_blocks, plan.ranges, plan.stages) == want
    cin8, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
    atom, unit = const["kAtom"], const["kUnitRows"]
    stem = cin <= const["kStemCin"]
    n_tiles = -(-n_out // unit)
    # the CTA's channels hold round8(Cout), its columns the 3 round8(Cin)
    # window columns (the stem: 27 Cin packed into one atom)
    assert plan.warpgroups == (1 if cout8 <= atom else 2)
    assert plan.cout_blocks == -(-cout8 // (plan.warpgroups * atom))
    most = const["kMaxAtoms1"] if plan.warpgroups == 1 else \
        const["kMaxAtoms2"]
    if stem:
        assert 27 * cin <= atom and plan.atoms == plan.col_blocks == 1
    else:
        assert plan.atoms <= most
        assert (plan.col_blocks * plan.atoms - 1) * atom < 3 * cin8 <= \
            plan.col_blocks * plan.atoms * atom
    # the runs fill the card once (the stem: kStemCtas CTAs an SM with one
    # warpgroup) and no run is empty where there are tiles enough
    ctas = const["kStemCtas"] if stem and plan.warpgroups == 1 else 1
    cap = ctas * const["kSMs"]
    assert plan.grid == (plan.ranges * plan.col_blocks, plan.cout_blocks)
    assert plan.ranges * plan.col_blocks * plan.cout_blocks <= cap or \
        plan.ranges == 1
    if stem:
        assert plan.ranges <= n_tiles
    # the ring: stages of windows and fp32 dY rows, within a CTA's share
    stage = plan.atoms * const["kAtomBytes"] + unit * (
        plan.warpgroups * atom + const["kYPad"]) * 4
    stage = -(-stage // 1024) * 1024
    assert 1 <= plan.stages <= const["kMaxStages"]
    assert plan.smem_bytes == 1024 + plan.stages * (stage + 16)
    assert plan.smem_bytes + 4 * const["kListChunk"] <= \
        const["kMaxSmem"] // ctas
    room = const["kMaxSmem"] // ctas - 4 * const["kListChunk"] - 1024 \
        - 16 * const["kMaxStages"]
    assert plan.stages == min(const["kMaxStages"], room // stage)
    # scratch: a partial a (run, group touched) slot; the codes and lists
    slots = plan.ranges + (0 if stem else 8)
    assert plan.part_elems == slots * plan.cout_blocks * plan.warpgroups \
        * atom * plan.col_blocks * plan.atoms * atom
    assert plan.xb_cols == (0 if stem else cin8)
    assert plan.code_elems == (0 if stem else 16 + -(-9 * n_tiles // 4) * 4
                               + 9 * n_out)
    assert 1 <= plan.sum_lanes <= (32 if stem else 1)
    assert 27 * cin * cout * plan.sum_lanes <= const["kSumThreads"] or \
        plan.sum_lanes == 1
    # fp32: the FMA tile's splits (at most kWSteps steps of kWR rows)
    fma = cuda_grouped.wgrad_plan(n_out, cin, cout, torch.float32)
    assert fma.kind == "fma" and fma.split_rows % const["kWR"] == 0
    assert fma.split_rows <= const["kWR"] * const["kWSteps"]
    assert (fma.splits - 1) * fma.split_rows < n_out <= \
        fma.splits * fma.split_rows
    tiles = -(-3 * cin8 // const["kWM"]) * -(-cout8 // const["kWN"])
    assert fma.grid == (fma.splits, tiles, 9)
    assert fma.part_elems == fma.splits * 9 * 3 * cin8 * cout8
    assert (fma.xb_cols, fma.code_elems, fma.ranges) == (0, 0, 0)


def _pyramid_maps(pairs, caps):
    """Every grouped map of a ResUNetSmall2 pyramid (each map once: the
    encoder, self and decoder maps, which are one another's adjoints)."""
    g = _pyramid("ResUNetSmall2", pairs, caps)
    seen, out = set(), []
    for key in ("enc_g", "block_g", "dec_g"):
        for i, m in enumerate(g[key]):
            if isinstance(m, GroupedMap) and id(m) not in seen:
                seen.add(id(m))
                out.append((f"{key}[{i}]", m))
    return out


@pytest.mark.parametrize("pairs,caps", [(1, CAPS), (2, CAPS), (1, TIGHT),
                                        (2, TIGHT)],
                         ids=["one_pair", "two_pairs", "one_pair_truncated",
                              "two_pairs_truncated"])
def test_wgrad_units_cover_every_used_window(pairs, caps):
    # the bf16 weight gradient sums group g over the rows of the tiles of
    # the map's order whose mask names g (wgrad_units_plain): every (row,
    # g) whose window has a slot that reads lies in one of them, each row
    # once; on the pyramid's maps (strided, self and transposed, each the
    # adjoint of another) and on a map passed without its order
    maps = _pyramid_maps(pairs, caps)
    assert len(maps) == 13
    kinds = {name.split("[")[0] for name, _ in maps}
    assert kinds == {"enc_g", "block_g", "dec_g"}
    for name, gmap in maps:
        n_out = gmap.masks.shape[-1]
        used = gmap.masks.any(1) | gmap.patho  # (9, N_out)
        lists = cuda_grouped.wgrad_units_plain(gmap)
        bare = cuda_grouped.wgrad_units_plain(GroupedMap(*gmap[:4]))
        order = gmap.order.to(torch.int64)
        staged = 0
        for g in range(9):
            assert torch.equal(lists[g], bare[g]), (name, g)
            pos = (lists[g][:, None] * 64 + torch.arange(64)).reshape(-1)
            rows = order[pos[pos < n_out]]
            assert rows.unique().numel() == rows.numel(), (name, g)
            covered = torch.zeros(n_out, dtype=torch.bool)
            covered[rows] = True
            assert not bool((used[g] & ~covered).any()), (name, g)
            staged += int(lists[g].numel()) * 64
        # no more tiles than the tiles' masks name
        assert staged == 64 * sum(bin(int(x)).count("1")
                                  for x in gmap.tiles)
        assert staged >= int(used.sum())
