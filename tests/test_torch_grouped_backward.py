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
# this conv). dX: jax.vjp of the JAX package's grouped conv at
# compute_dtype=bfloat16 takes dY unrounded, as the port's dX route now
# does (dY's hi and lo bf16 parts on the card), but rounds each group's
# window cotangent to bf16 and adds the groups' and the three column
# blocks' shares in bf16 (the transposes of its gather and
# concatenations), where the port sums every product in fp32 and rounds
# dX once: entries land up to about one bf16 ulp of max |dX| apart
# (2^-8; measured up to 5.8e-3 x max here, and up to 7.4e-3 with dY
# rounded, as the route had it before). dW: the weight-gradient kernel
# (left as it is, bits and all) takes dY rounded to bf16, which JAX's
# autodiff does not: that rounding is the whole gap (without it the two
# are bit for bit the same; with it up to 7.0e-3 x max here).
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
    _close(dw, jdw, BF16_JAX_LIMIT)
    # dW's gap is dY's rounding alone
    unrounded = n(round_to(sparse_conv_grouped_wgrad_plain(
        round_to(t(f), bf), t(dy), gmap), bf))
    np.testing.assert_array_equal(unrounded, jdw)


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


@pytest.mark.parametrize("n_out,cin,cout,want_split,want_splits", [
    (262144, 32, 32, 8192, 32),  # level 0 at B = 8: 256 steps a split
    (262144, 1, 32, 8192, 32),  # the stem
    (2048, 256, 256, 2048, 1),  # 432 blocks without a split
    (10240, 64, 64, 1024, 10),  # 9 x 3 tiles: 270 blocks, two an SM
    (20, 5, 7, 32, 1),  # one step
])
def test_wgrad_plan_is_a_rule_on_shapes(n_out, cin, cout, want_split,
                                        want_splits):
    import re

    src = (_build.CSRC / "sparse_conv_grouped_wgrad.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    plan = cuda_grouped.wgrad_plan(n_out, cin, cout, torch.bfloat16)
    assert (plan.split_rows, plan.splits) == (want_split, want_splits)
    assert plan.split_rows % const["kWR"] == 0
    assert plan.split_rows <= const["kWR"] * const["kWSteps"]
    assert (plan.splits - 1) * plan.split_rows < n_out <= \
        plan.splits * plan.split_rows
    cin8, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
    tiles = -(-3 * cin8 // const["kWM"]) * -(-cout8 // const["kWN"])
    assert plan.grid == (plan.splits, tiles, 9)
    assert plan.part_elems == plan.splits * 9 * 3 * cin8 * cout8
    assert (plan.xb_cols, plan.yb_cols) == (cin8, cout8)
    fma = cuda_grouped.wgrad_plan(n_out, cin, cout, torch.float32)
    assert fma.kind == "fma" and fma.splits == plan.splits
    assert (fma.xb_cols, fma.yb_cols) == (0, 0)
