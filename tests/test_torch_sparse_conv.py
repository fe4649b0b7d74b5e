"""The per-tap sparse conv and the row gather of the port against the JAX
package (ops/sparse.sparse_conv, ops/neighbors.gather_padded: the
functions the Pallas experiment kernels check themselves against), on CPU
tensors, where the wrappers run their plain versions; the kernel-choice
rule; and the grouped conv against the per-tap conv on the same maps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t, voxel_cloud as _cloud
from umeregrobust_tpu.ops.neighbors import gather_padded as jax_gather
from umeregrobust_tpu.ops.sparse import sparse_conv as jax_sparse_conv
from umeregrobust_tpu_torch.models.resunet import ARCHS, build_unet_geometry
from umeregrobust_tpu_torch.ops import cuda_conv, cuda_gather
from umeregrobust_tpu_torch.ops.neighbors import gather_padded
from umeregrobust_tpu_torch.ops.sparse import (
    group_kernel_map, sparse_conv, sparse_conv_grouped)

N = 512


def make_maps(rng, K, n_rows=N):
    """Per tap a monotone subsequence with ~45% validity, identity centre
    tap (tools/exp_pallas_gather.py make_maps)."""
    maps = np.full((K, n_rows), -1, np.int32)
    for k in range(K):
        hit = rng.random(n_rows) < 0.45
        maps[k, np.nonzero(hit)[0]] = np.sort(
            rng.choice(n_rows, size=hit.sum(), replace=False))
    maps[K // 2] = np.arange(n_rows)
    return maps


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
@pytest.mark.parametrize("cin", [1, 32, 96])
@pytest.mark.parametrize("K", [27, 125, 343])
def test_sparse_conv_matches_jax(K, cin, dtype, tol, bias):
    rng = np.random.default_rng(K * 1000 + cin)
    cout = 48
    nbr = make_maps(rng, K)
    feats = rng.standard_normal((N, cin)).astype(np.float32)
    w = (rng.standard_normal((K, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    want = np.asarray(jax_sparse_conv(
        jnp.asarray(feats), jnp.asarray(w), jnp.asarray(nbr),
        bias=None if b is None else jnp.asarray(b),
        compute_dtype=getattr(jnp, dtype)))
    got = n(sparse_conv(t(feats), t(w), t(nbr).long(),
                        bias=None if b is None else t(b),
                        compute_dtype=getattr(torch, dtype)))
    assert got.shape == (N, cout) and got.dtype == np.float32
    # same operands (rounded alike); only the order of fp32 sums differs
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("wrapper", [cuda_conv.sparse_conv_rowtile,
                                     cuda_conv.sparse_conv_tapsplit])
def test_kernel_wrappers_take_the_plain_version_on_cpu(wrapper):
    rng = np.random.default_rng(2)
    nbr = t(make_maps(rng, 27, 64))
    f = t(rng.standard_normal((64, 8)).astype(np.float32))
    w = t(rng.standard_normal((27, 8, 5)).astype(np.float32))
    before = dict(cuda_conv.LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        torch.testing.assert_close(
            wrapper(f, w, nbr, dt), cuda_conv.sparse_conv_plain(f, w, nbr, dt),
            rtol=0, atol=0)
    assert cuda_conv.LAUNCHES == before  # no kernel was launched


# (n_out, cout, k_vol) of the ResUNet forward on the nominal suite pair
# and of the ResUNetSmall2 conv_impl="scan" forward, with the kernel each
# is routed to (per-layer device times of both kernels, chip_smoke.py)
_ROUTES = [
    ((32768, 32, 343), "rowtile"),  # ResUNet k7 stem: one input channel
    ((4352, 64, 125), "tapsplit"),  # conv2
    ((1536, 128, 125), "tapsplit"),  # conv3
    ((256, 1024, 125), "tapsplit"),  # conv6
    ((768, 512, 125), "tapsplit"),  # conv4_tr
    ((4352, 256, 125), "tapsplit"),  # conv2_tr
    ((32768, 128, 125), "tapsplit"),  # conv1_tr: few entries a tap
    ((32768, 32, 125), "rowtile"),  # a k5 stem (ResUNet2..5)
    ((32768, 32, 27), "rowtile"),  # scan level 0
    ((20480, 64, 27), "rowtile"),  # scan level 1
    ((8192, 128, 27), "tapsplit"),  # scan level 2
    ((2560, 128, 27), "tapsplit"),  # scan level 3
    ((512, 256, 27), "tapsplit"),  # scan level 4
    ((77, 48, 27), "tapsplit"),
    ((5000, 8, 1), "rowtile"),
]


@pytest.mark.parametrize("shape,kind", _ROUTES,
                         ids=[f"{a}x{b}x{c}" for (a, b, c), _ in _ROUTES])
def test_choose_kernel_is_a_fixed_rule_on_shapes(shape, kind):
    n_out, cout, k = shape
    got, S = cuda_conv.choose_kernel(n_out, cout, k)
    assert got == kind
    assert (got, S) == cuda_conv.choose_kernel(n_out, cout, k)  # no state
    # S: the FMA tile's tap segments, none of them empty
    assert 1 <= S <= k
    assert S == 1 or -(-k // -(-k // S)) == S


def _entries_numpy(nbr, n_in, tile_rows):
    """The per-tap entry lists by a loop over the map."""
    K, n_out = nbr.shape
    ent = np.full((K, n_out, 2), -1, np.int64)
    cnt = np.zeros(K, np.int64)
    pos = np.full((K, n_out), -1, np.int64)
    T = -(-n_out // tile_rows)
    tile_start = np.zeros((K, T + 1), np.int64)
    for k in range(K):
        for i in range(n_out):
            if i % tile_rows == 0:
                tile_start[k, i // tile_rows] = cnt[k]
            if 0 <= nbr[k, i] < n_in:
                ent[k, cnt[k]] = (i, nbr[k, i])
                pos[k, i] = k * n_out + cnt[k]
                cnt[k] += 1
        tile_start[k, T] = cnt[k]
    return ent, cnt, tile_start, pos


@pytest.mark.parametrize("tile_rows", [32, 64])
@pytest.mark.parametrize("idx", ["int32", "int64"])
@pytest.mark.parametrize("case", ["monotone_empty_taps", "past_n_in"])
def test_conv_entries_plain_matches_numpy(case, idx, tile_rows):
    rng = np.random.default_rng(17)
    n_out, K = 300, 27
    nbr = make_maps(rng, K, n_out).astype(np.int64)
    n_in = n_out
    if case == "monotone_empty_taps":
        nbr[[0, 5, 26]] = -1  # taps with no entry anywhere
        nbr[:, 64:128] = -1  # a tile with no entry ...
        nbr[13, 100] = 7  # ... but one
    else:  # indices at and past n_in are absent; more rows out than in
        n_in = 180
        nbr[nbr >= 0] = nbr[nbr >= 0] % 240
    want = _entries_numpy(nbr, n_in, tile_rows)
    got = cuda_conv.conv_entries(t(nbr.astype(idx)), n_in, tile_rows)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(n(g), w, err_msg=name)
    assert int(got.cnt.sum()) == int(((nbr >= 0) & (nbr < n_in)).sum())
    if case == "monotone_empty_taps":
        assert int(got.cnt[0]) == 0 and int(got.cnt[5]) == 0
        T = 64 // tile_rows  # the first tile of rows 64..
        assert int((got.tile_start[:, T + 64 // tile_rows]
                    - got.tile_start[:, T]).sum()) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ["1d", "2d"])
def test_gather_padded_matches_jax_exactly(shape, dtype):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((300, 24)).astype(np.float32)
    idx = rng.integers(-1, 300, size=(200,) if shape == "1d" else (40, 7)
                       ).astype(np.int32)
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    tt = t(table).to(getattr(torch, dtype))
    want = np.asarray(jax_gather(jt, jnp.asarray(idx)).astype(jnp.float32))
    got = gather_padded(tt, t(idx).long())
    assert got.dtype == tt.dtype and got.shape == idx.shape + (24,)
    np.testing.assert_array_equal(n(got.float()), want)
    np.testing.assert_array_equal(want[idx < 0], 0)
    # int32 indices and the kernel wrapper's CPU path give the same rows
    np.testing.assert_array_equal(
        n(cuda_gather.gather_rows(tt, t(idx).reshape(-1)).float()),
        want.reshape(-1, 24))
    # a non-zero fill stays available on the CPU
    np.testing.assert_array_equal(
        n(gather_padded(tt, t(idx).long(), fill=2.0).float())[idx < 0], 2.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_tap_conv_equals_grouped_conv_on_k3_maps(dtype):
    """Ungrouped k=3 maps of the generic path through sparse_conv equal
    their grouped form through sparse_conv_grouped: block maps, strided
    encoder maps (N_out <= N_in) and decoder maps whose "no candidate"
    centres point past a smaller input table (N_out > N_in)."""
    rng = np.random.default_rng(9)
    L = 6
    caps = (192, 160, 128, 96, 64, 32)
    c4, mask = _cloud(3)
    geom = build_unet_geometry(t(c4), t(mask), ARCHS["ResUNet4"], caps)
    cases = [("block0", geom["block_maps"][0], geom["block_g"][0], 192),
             ("enc1", geom["enc_maps"][1], geom["enc_g"][1], 192),
             ("enc2", geom["enc_maps"][2], geom["enc_g"][2], 160),
             ("dec_to_1", geom["dec_maps"][L - 3], geom["dec_g"][L - 3], 128),
             ("dec_to_0", geom["dec_maps"][L - 2], geom["dec_g"][L - 2], 160)]
    for name, nbr, gmap, n_in in cases:
        assert nbr.shape[0] == 27, name
        valid = int(nbr.max()) + 1
        f = torch.zeros(n_in, 6)
        f[:valid] = t(rng.standard_normal((valid, 6)).astype(np.float32))
        w = t(rng.standard_normal((27, 6, 10)).astype(np.float32))
        b = t(rng.standard_normal(10).astype(np.float32))
        a = sparse_conv(f, w, nbr, bias=b, compute_dtype=dtype)
        g = sparse_conv_grouped(f, w, gmap, bias=b, compute_dtype=dtype)
        torch.testing.assert_close(a, g, rtol=0,
                                   atol=1e-5 * float(a.abs().max()), msg=name)
        assert float(a.abs().max()) > 0.1, name
    # the decoder cases do have more output rows than input rows
    assert geom["dec_maps"][L - 2].shape[1] > 160 - 1
    np.testing.assert_array_equal(
        n(group_kernel_map(geom["dec_maps"][L - 2], z_reversed=True).center),
        n(geom["dec_g"][L - 2].center))


def test_grouped_map_sentinel_lands_on_the_zero_row():
    """group_kernel_map marks a group without candidates by centre
    N_out + 2; for a map with more output rows than the input table has
    rows that index lies past the table, and sparse_conv_grouped must
    read the all-zero last row there, also for features that are not
    finite elsewhere."""
    nbr = torch.full((27, 40), -1, dtype=torch.int64)
    nbr[13, :10] = torch.arange(10)  # rows 10.. have no candidate at all
    gmap = group_kernel_map(nbr)
    assert int(gmap.center.max()) == 40 + 2
    f = torch.zeros(12, 4)  # N_in = 12 < N_out = 40
    f[:10] = 1.0
    f[11] = float("inf")  # a row no map entry points at
    w = torch.ones(27, 4, 3)
    out = sparse_conv_grouped(f, w, gmap)
    torch.testing.assert_close(out, sparse_conv(f, w, nbr))
    assert torch.isfinite(out).all()
    assert float(out[:10].min()) == 4.0 and float(out[10:].abs().max()) == 0.0
