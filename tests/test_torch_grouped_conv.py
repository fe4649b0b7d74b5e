"""The grouped k=3 conv of the port: its plain version against the JAX
package's ops/sparse.sparse_conv_grouped on maps of a real
build_unet_geometry pyramid (self, strided and transposed maps, one and
two pairs), `GroupedConv`'s backward (its kernels' plain versions on
CPU tensors) against autograd through the plain version, the CPU
dispatch, the kernel wrapper's refusals, and the kernel's plan as a rule
on shapes. The kernel itself (csrc/sparse_conv_grouped.cu) runs only on
the card: chip_smoke.py phase 3's `grouped_layer` and `grouped_forced`
lines hold it to the plain version there; the backward's own tests are
tests/test_torch_grouped_backward.py."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t, voxel_cloud
from umeregrobust_tpu.ops.sparse import GroupedMap as JGroupedMap
from umeregrobust_tpu.ops.sparse import sparse_conv_grouped as jax_grouped
from umeregrobust_tpu_torch.models.resunet import ARCHS, build_unet_geometry
from umeregrobust_tpu_torch.ops import cuda_grouped
from umeregrobust_tpu_torch.ops.sparse import (
    GroupedConv, GroupedMap, sparse_conv_grouped, sparse_conv_grouped_plain)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CAPS = (192, 160, 128, 96, 64)


def _pyramid(pairs):
    """A ResUNetSmall2 pyramid of `pairs` pairs (two clouds each) made
    from voxel clouds of seeds 3, 4, ..."""
    coords, mask = [], []
    for b in range(pairs):
        c4, m = voxel_cloud(3 + b, n_vox=170, cap=192)
        c4[:, 0] = np.where(m, c4[:, 0] + 2 * b, c4[:, 0])
        coords.append(c4)
        mask.append(m)
    geom = build_unet_geometry(t(np.concatenate(coords)),
                               t(np.concatenate(mask)), ARCHS["ResUNetSmall2"],
                               CAPS, pairs=pairs)
    rows = [int(lv.coords.shape[0]) for lv in geom["levels"]]
    return {"self": (geom["block_g"][1], rows[1]),
            "strided": (geom["enc_g"][1], rows[0]),
            "transposed": (geom["dec_g"][-1], rows[1]),
            # each map's adjoint (dX of its conv runs over it) and whether
            # its taps run reversed
            "adjoint": {"self": (geom["block_g"][1], True),
                        "strided": (geom["dec_g"][-1], False),
                        "transposed": (geom["enc_g"][1], False)}}


@pytest.fixture(scope="module")
def maps():
    return {1: _pyramid(1), 2: _pyramid(2)}


def _inputs(seed, n_in, cin, cout, bias):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n_in, cin)).astype(np.float32)
    w = (rng.standard_normal((27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    return f, w, b


def _jax_map(gmap):
    return JGroupedMap(*(jnp.asarray(n(x).astype(np.int32))
                         if x.dtype == torch.int64 else jnp.asarray(n(x))
                         for x in gmap[:4]))


@pytest.mark.parametrize("pairs", [1, 2])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
@pytest.mark.parametrize("which", ["self", "strided", "transposed"])
@pytest.mark.parametrize("cin,cout,bias", [(1, 48, True), (32, 7, False),
                                           (32, 48, True), (96, 7, True),
                                           (96, 48, False)])
def test_plain_version_matches_jax(maps, cin, cout, bias, which, dtype, tol,
                                   pairs):
    gmap, n_in = maps[pairs][which]
    f, w, b = _inputs(cin * 100 + cout, n_in, cin, cout, bias)
    want = np.asarray(jax_grouped(
        jnp.asarray(f), jnp.asarray(w), _jax_map(gmap),
        bias=None if b is None else jnp.asarray(b),
        compute_dtype=getattr(jnp, dtype)))
    got = n(sparse_conv_grouped_plain(
        t(f), t(w), gmap, None if b is None else t(b),
        getattr(torch, dtype), pairs))
    assert got.shape == (gmap.center.shape[1], cout)
    assert got.dtype == np.float32
    assert np.abs(want).max() > 0.1
    # same operands (rounded alike); only the order of fp32 sums differs
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# GroupedConv's backward against autograd through the plain version, x
# max |autograd's|: fp32, the same sums in another order; bf16, dX and dW
# (both from dY unrounded, as autograd takes it) rounded to bf16 as
# autograd rounds them, so a value near a rounding boundary may land one
# bf16 ulp (2^-8 of its size) away
BACKWARD_LIMITS = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["self", "strided", "transposed"])
def test_recompute_backward_is_autograd_of_the_plain_version(
        maps, which, dtype, bias):
    # GroupedConv on CPU tensors runs the card's backward route with its
    # kernels' plain versions (dX: sparse_conv_grouped_dx_plain, the
    # forward over the adjoint map with the weights transposed and dY
    # unrounded; dW: sparse_conv_grouped_wgrad_plain; db: a
    # sum of dY): the forward, bit for bit, and dX, dW and db, within
    # BACKWARD_LIMITS, are autograd's through the plain version (the form
    # the backward recomputed before it had kernels of its own)
    gmap, n_in = maps[2][which]
    adjoint = maps[2]["adjoint"][which]
    f, w, b = _inputs(7, n_in, 20, 12, bias)
    g = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (gmap.center.shape[1], 12)).astype(np.float32))
    leaves = [None if x is None else t(x).requires_grad_() for x in (f, w, b)]
    out = GroupedConv.apply(*leaves, gmap, adjoint, dtype)
    torch.autograd.backward(out, g)
    ref = [None if x is None else t(x).requires_grad_() for x in (f, w, b)]
    want = sparse_conv_grouped_plain(ref[0], ref[1], gmap, ref[2], dtype, 2)
    torch.autograd.backward(want, g)
    assert torch.equal(out, sparse_conv_grouped_plain(
        *(None if x is None else x.detach() for x in ref[:2]), gmap,
        None if b is None else ref[2].detach(), dtype))
    for a, r in zip(leaves, ref):
        if a is not None:
            scale = float(r.grad.abs().max())
            assert scale > 0
            lim = BACKWARD_LIMITS[dtype] if a is not leaves[2] else 1e-6
            assert float((a.grad - r.grad).abs().max()) <= lim * scale


def test_cpu_dispatch_takes_the_plain_version_and_counts_nothing(maps):
    gmap, n_in = maps[1]["transposed"]
    f, w, b = _inputs(9, n_in, 8, 5, True)
    before = dict(cuda_grouped.LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        want = sparse_conv_grouped_plain(t(f), t(w), gmap, t(b), dt)
        assert torch.equal(sparse_conv_grouped(t(f), t(w), gmap, t(b), dt),
                           want)
        assert torch.equal(cuda_grouped.sparse_conv_grouped_kernel(
            t(f), t(w), gmap, t(b), dt), want)
    assert cuda_grouped.LAUNCHES == before  # no kernel was launched


def _meta_map(n_out, center_dtype=torch.int64):
    d = "meta"
    return GroupedMap(center=torch.zeros((9, n_out), dtype=center_dtype,
                                         device=d),
                      masks=torch.zeros((9, 3, n_out), dtype=torch.bool,
                                        device=d),
                      patho=torch.zeros((9, n_out), dtype=torch.bool,
                                        device=d),
                      worder=torch.zeros(3, dtype=torch.int64, device=d))


def _bad(case):
    """(feats, weights, gmap, bias, compute_dtype) with one fault."""
    d = "meta"
    f = torch.zeros((10, 4), device=d)
    w = torch.zeros((27, 4, 6), device=d)
    gmap, bias, cd = _meta_map(12), None, torch.bfloat16
    if case == "taps":
        w = torch.zeros((125, 4, 6), device=d)
    elif case == "feats_width":
        f = torch.zeros((10, 5), device=d)
    elif case == "feats_dtype":
        f = f.to(torch.bfloat16)
    elif case == "weights_dtype":
        w = w.to(torch.float64)
    elif case == "center_dtype":
        gmap = _meta_map(12, torch.int16)
    elif case == "center_groups":
        gmap = gmap._replace(center=torch.zeros((27, 12), dtype=torch.int64,
                                                device=d))
    elif case == "masks_shape":
        gmap = gmap._replace(masks=torch.zeros((9, 12), dtype=torch.bool,
                                               device=d))
    elif case == "masks_dtype":
        gmap = gmap._replace(masks=torch.zeros((9, 3, 12), dtype=torch.uint8,
                                               device=d))
    elif case == "patho_rows":
        gmap = gmap._replace(patho=torch.zeros((9, 11), dtype=torch.bool,
                                               device=d))
    elif case == "worder_dtype":
        gmap = gmap._replace(worder=torch.zeros(3, dtype=torch.int32,
                                                device=d))
    elif case == "bias_shape":
        bias = torch.zeros(7, device=d)
    elif case == "noncontiguous":
        f = torch.zeros((4, 10), device=d).T
    elif case == "compute_dtype":
        cd = torch.float16
    return f, w, gmap, bias, cd


@pytest.mark.parametrize("case", [
    "taps", "feats_width", "feats_dtype", "weights_dtype", "center_dtype",
    "center_groups", "masks_shape", "masks_dtype", "patho_rows",
    "worder_dtype", "bias_shape", "noncontiguous", "compute_dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    # checked before the kernel library is looked for: a ValueError, never
    # the plain version
    with pytest.raises(ValueError):
        cuda_grouped.sparse_conv_grouped_kernel(*_bad(case))


def _kernel_constants():
    src = (ROOT / "umeregrobust_tpu_torch" / "csrc"
           / "sparse_conv_grouped.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


@pytest.mark.parametrize("n_in,n_out,cin,cout,want_steps,want_cols,"
                         "want_cluster", [
    (32768, 32768, 1, 32, 1, 32, 1),  # the stem: K = 3 x 8, one chunk
    (32768, 20480, 32, 64, 2, 64, 1),  # 9 x 2 steps a tile: one CTA
    (20480, 32768, 128, 64, 6, 64, 1),  # conv1_tr: 54 steps, one CTA
    (2560, 8192, 256, 128, 12, 128, 2),  # conv3_tr: 216 steps, two CTAs
    (512, 512, 256, 256, 12, 128, 4),  # block5: 432 steps, four CTAs
    (2560, 2560, 128, 128, 6, 128, 1),  # block4: 108 steps
    (512, 512, 128, 256, 6, 128, 2),  # conv5
    (400, 400, 768, 48, 36, 64, 3),  # ResUNetSmall's widest decoder input
    (100, 260, 20, 5, 2, 32, 1),  # 3 x 24 = 72 K entries: 2 chunks
])
def test_plan_is_a_rule_on_shapes(n_in, n_out, cin, cout, want_steps,
                                  want_cols, want_cluster):
    const = _kernel_constants()
    plan = cuda_grouped.grouped_plan(n_in, n_out, cin, cout, torch.bfloat16)
    assert plan.kind == "mma" and not plan.split
    # 64-row tiles of the map's order (the order kernel's tile too)
    assert (plan.tile_rows, plan.k_chunk) == (const["kBM"], const["kKC"])
    assert _order_constants()["kTileRows"] == const["kBM"]
    assert plan.k_steps == want_steps
    cin8, cout8 = -(-cin // 8) * 8, -(-cout // 8) * 8
    assert (plan.k_steps - 1) * plan.k_chunk < 3 * cin8 <= \
        plan.k_steps * plan.k_chunk
    # the channel tile: the least of 32, 64 and 128 that holds round8(Cout),
    # 128 past it
    assert plan.tile_cols == want_cols
    assert plan.tile_cols == next((c for c in (32, 64, 128) if cout8 <= c),
                                  128)
    # the cluster: a tile's work (9 k_steps ceil(Cout / 64) steps) over
    # about one CTA a 128 steps, at most kMaxCluster; Cin and Cout alone
    # fix it (it sets the order of a row's sums), never N_out
    assert plan.cluster == want_cluster
    assert 1 <= plan.cluster <= const["kMaxCluster"]
    assert all(cuda_grouped.grouped_plan(m, m2, cin, cout).cluster
               == plan.cluster for m, m2 in ((1, 1), (10 ** 6, 3 * 10 ** 6)))
    col_tiles = -(-cout // plan.tile_cols)
    assert plan.grid == (-(-n_out // 64) * plan.cluster, col_tiles)
    assert plan.xb_elems == n_in * cin8
    assert plan.wt_elems == 9 * want_steps * col_tiles * plan.tile_cols * 64
    assert plan.wt_elems == cuda_grouped.weight_tiles_plain(
        torch.zeros(27, cin, cout)).numel()
    # the stages of A (64 rows x 64 bf16) and weights (64 x cols bf16), the
    # barriers and 1 KB to align, within the 227 KB a block may have
    stage = 2 * const["kBM"] * const["kKC"] + 2 * plan.tile_cols * 64
    assert plan.smem_bytes == 1024 + const["kStages"] * (stage + 16)
    assert plan.smem_bytes <= 232448
    # a dX's plan: dY's hi and lo parts double A and the feature copy
    dx = cuda_grouped.grouped_plan(n_in, n_out, cin, cout, torch.bfloat16,
                                   split=True)
    assert dx.split and dx.xb_elems == 2 * plan.xb_elems
    assert dx.smem_bytes - plan.smem_bytes == \
        const["kStages"] * 2 * const["kBM"] * const["kKC"]
    assert dx.smem_bytes <= 232448
    assert dx._replace(split=False, xb_elems=plan.xb_elems,
                       smem_bytes=plan.smem_bytes) == plan
    fma = cuda_grouped.grouped_plan(n_in, n_out, cin, cout, torch.float32)
    assert (fma.kind, fma.tile_rows, fma.tile_cols, fma.k_chunk) == (
        "fma", const["kFM"], const["kFN"], const["kFK"])
    assert fma.k_steps == -(-3 * cin // 16) and fma.xb_elems == 0
    assert fma.cluster == 1 and fma.smem_bytes <= 48 * 1024


def _order_constants():
    src = (ROOT / "umeregrobust_tpu_torch" / "csrc"
           / "grouped_row_order.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}
