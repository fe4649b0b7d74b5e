"""The training losses and what they stand on, the port against the JAX
package on the CPU (plain kernel versions; Pallas in interpret mode):
the capped-moment and scorer kernels' plain versions at feature widths 8,
16 and 64 and the zero padding their CUDA paths use; moment_matrix; each
loss's value and its gradient against jax.grad, with the median of an
even count and batches of 0 and 1 valid keypoints; the training keypoint
selection; the inlier-ratio metric; BatchNorm in training mode; and the
backward plain versions (the row gather's scatter-add, the per-tap conv's
dX over the inverted map and dW at k = 3, 5, 7 on self, strided and
transposed maps). Values to 1e-5 relative, gradients to 1e-4 x max |grad|
unless stated. Test data keep every distance off the radii, so the two
packages' distance formulas cannot disagree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import umeregrobust_tpu.ops.pallas_corr as jpc
from _torch_parity import n, t, voxel_cloud
from umeregrobust_tpu.core.ume import moment_matrix as jax_moment_matrix
from umeregrobust_tpu.losses import (
    cube_registration_loss as jax_cube, pointwise_infonce as jax_infonce,
    ume_contrastive_loss as jax_ume_loss)
from umeregrobust_tpu.ops.neighbors import gather_padded as jax_gather
from umeregrobust_tpu.ops.pallas_ume import ume_moments_fused as jax_moments
from umeregrobust_tpu.ops.sparse import masked_batch_norm as jax_bn
from umeregrobust_tpu.ops.sparse import sparse_conv as jax_sparse_conv
from umeregrobust_tpu.pipeline.eval_metrics import (
    calc_inlier_ratio as jax_inlier_ratio)
from umeregrobust_tpu.pipeline.train_keypoints import (
    generate_training_umes as jax_gen)
from umeregrobust_tpu.pipeline.ume_gen import ume_from_ball_query as jax_ume
from umeregrobust_tpu_torch.core.ume import moment_matrix
from umeregrobust_tpu_torch.data.synthetic import (
    SceneConfig, make_collated_batch)
from umeregrobust_tpu_torch.losses import (
    cube_registration_loss, nanmedian_mean, pointwise_infonce,
    ume_contrastive_loss)
from umeregrobust_tpu_torch.models.resunet import ARCHS, build_unet_geometry
from umeregrobust_tpu_torch.ops import cuda_conv, cuda_corr, cuda_gather
from umeregrobust_tpu_torch.ops.cuda_ume import (
    padded_width, ume_moments_fused)
from umeregrobust_tpu_torch.ops.neighbors import gather_padded
from umeregrobust_tpu_torch.ops.sparse import (
    invert_map_batch, masked_batch_norm, sparse_conv)
from umeregrobust_tpu_torch.pipeline.eval_metrics import calc_inlier_ratio
from umeregrobust_tpu_torch.pipeline.train_keypoints import (
    generate_training_umes)
from umeregrobust_tpu_torch.pipeline.ume_gen import ume_from_ball_query

WIDTHS = [8, 16, 64]


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _grad_close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


# --- the two kernels at feature widths other than 32 -------------------

def _far_cloud(seed, n_pts, m, radius):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n_pts, 3)) * 5).astype(np.float32)
    kpts = pts[rng.choice(n_pts, m, replace=False)] + np.float32(0.1)
    d = np.sqrt(((kpts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1))
    return rng, pts[(np.abs(d - radius) >= 1e-4).all(0)], kpts


@pytest.mark.parametrize("C", WIDTHS)
def test_moments_at_width_match_pallas(C):
    rng, pts, kpts = _far_cloud(C, 1200, 40, 3.0)
    Z = rng.normal(size=(len(pts), 4 * C)).astype(np.float32)
    mask = rng.random(len(pts)) < 0.85
    Zm = Z * mask[:, None]
    got = n(ume_moments_fused(t(kpts), t(pts), t(Zm), t(mask), 3.0, 60))
    want = np.asarray(jax_moments(
        jnp.asarray(kpts), jnp.asarray(pts), jnp.asarray(Zm),
        jnp.asarray(mask), radius=3.0, max_nn=60, interpret=True))
    assert got.shape == (len(kpts), 4 * C)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("C", WIDTHS)
def test_moments_zero_padding_keeps_every_column(C):
    # the card pads Z to a multiple of 128 columns: columns are
    # independent, so the real ones keep their bits
    rng, pts, kpts = _far_cloud(10 + C, 900, 30, 3.0)
    Z = rng.normal(size=(len(pts), 4 * C)).astype(np.float32)
    mask = rng.random(len(pts)) < 0.9
    W = padded_width(4 * C)
    assert W % 128 == 0 and W >= 4 * C and W - 4 * C < 128
    Zp = np.zeros((len(pts), W), np.float32)
    Zp[:, :4 * C] = Z
    one = n(ume_moments_fused(t(kpts), t(pts), t(Z), t(mask), 3.0, 40))
    pad = n(ume_moments_fused(t(kpts), t(pts), t(Zp), t(mask), 3.0, 40))
    np.testing.assert_array_equal(pad[:, :4 * C], one)
    assert not pad[:, 4 * C:].any()


@pytest.mark.parametrize("C", WIDTHS)
def test_ume_from_ball_query_at_width_matches_jax(C):
    rng, pts, kpts = _far_cloud(20 + C, 1000, 24, 4.0)
    feats = rng.normal(size=(len(pts), C)).astype(np.float32)
    got = n(ume_from_ball_query(t(pts), t(feats), t(kpts), 4.0, 50))
    want = np.asarray(jax_ume(jnp.asarray(pts), jnp.asarray(feats),
                              jnp.asarray(kpts), 4.0, 50))
    assert got.shape == (len(kpts), C, 4)
    _close(got, want, rtol=1e-4)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jpc.pl, "pallas_call", patched)


def _corr_inputs(seed, H, S, T, C):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-6, 6, (H, S, 4)).astype(np.float32)
    pts[..., 3] = 0
    tp = rng.uniform(-6, 6, (T, 4)).astype(np.float32)
    tp[:, 3] = 0
    f = rng.normal(size=(S, C)).astype(np.float32)
    g = rng.normal(size=(T, C)).astype(np.float32)
    return pts, f, tp, g


@pytest.mark.parametrize("C", WIDTHS)
def test_scores_at_width_match_pallas(pallas_interpret, C):
    pts, f, tp, g = _corr_inputs(C, 9, 16, 256, C)
    got = n(cuda_corr.corr_scores_fused(t(pts), t(f), t(tp), t(g)))
    want = np.asarray(jpc.corr_scores_fused(
        jnp.asarray(pts), jnp.asarray(f), jnp.asarray(tp), jnp.asarray(g),
        sigma=1.5, radius_factor=2.0, ts=8, tt=128))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("C", WIDTHS)
def test_scores_zero_padding_adds_nothing(C):
    # the card pads the features to a multiple of 32 columns
    pts, f, tp, g = _corr_inputs(40 + C, 5, 70, 300, C)
    Cp = -(-C // 32) * 32
    fp = np.zeros((len(f), Cp), np.float32)
    gp = np.zeros((len(g), Cp), np.float32)
    fp[:, :C], gp[:, :C] = f, g
    one = n(cuda_corr.corr_scores_plain(t(pts), t(f), t(tp), t(g)))
    pad = n(cuda_corr.corr_scores_plain(t(pts), t(fp), t(tp), t(gp)))
    np.testing.assert_allclose(pad, one, rtol=1e-6, atol=1e-6)


# --- moment matrices and the losses ------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_moment_matrix_matches_jax(normalize, masked):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(5, 40, 3)).astype(np.float32) * 4
    feat = rng.uniform(0.1, 1, (5, 40, 8)).astype(np.float32)
    mask = rng.random((5, 40)) < 0.7 if masked else None
    got = n(moment_matrix(t(pts), t(feat), None if mask is None else t(mask),
                          normalize=normalize))
    want = np.asarray(jax_moment_matrix(
        jnp.asarray(pts), jnp.asarray(feat),
        None if mask is None else jnp.asarray(mask), normalize=normalize))
    _close(got, want)


def _rigid(rng, max_t=5.0):
    a = rng.uniform(-np.pi, np.pi)
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = rng.uniform(-max_t, max_t, 3)
    return T


def _umes(seed, K=12, n_pts=60, C=8, noise=0.8):
    """Matched source / target UMEs of random balls (the target's points
    moved by T and jittered, its features too: losses well above 0, where
    rounding does not rule the comparison)."""
    rng = np.random.default_rng(seed)
    T = _rigid(rng)
    pts = rng.normal(size=(K, n_pts, 3)).astype(np.float32) * 3
    feat = rng.uniform(0.1, 1.0, (K, n_pts, C)).astype(np.float32)
    p2 = (pts @ T[:3, :3].T + T[:3, 3]
          + rng.normal(size=pts.shape) * noise).astype(np.float32)
    src = np.asarray(jax_moment_matrix(jnp.asarray(pts), jnp.asarray(feat),
                                       normalize=True))
    f2 = np.abs(feat + rng.normal(size=feat.shape) * 0.3).astype(np.float32)
    tgt = np.asarray(jax_moment_matrix(jnp.asarray(p2), jnp.asarray(f2),
                                       normalize=True))
    return rng, src, tgt, T


def test_pointwise_infonce_value_and_grads_match_jax():
    rng = np.random.default_rng(0)
    N, C, M = 200, 16, 48
    pts = rng.uniform(-20, 20, (N, 3)).astype(np.float32)
    sf = rng.normal(size=(N, C)).astype(np.float32)
    tf = rng.normal(size=(N, C)).astype(np.float32)
    sf /= np.linalg.norm(sf, axis=1, keepdims=True)  # unit rows, as the
    tf /= np.linalg.norm(tf, axis=1, keepdims=True)  # network gives them
    sf[7] = 0.0  # an exactly-zero row: the rsqrt guard keeps it finite
    matches = np.stack([rng.permutation(N)[:M], rng.permutation(N)[:M]], 1)
    matches[0, 0] = 7
    mm = rng.random(M) < 0.8

    def jf(a, b):
        return jax_infonce(a, jnp.asarray(pts), b, jnp.asarray(matches),
                           jnp.asarray(mm), tau=0.1, neg_euclid_dist=5.0)

    want, (ga, gb) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(sf), jnp.asarray(tf))
    a, b = t(sf).requires_grad_(), t(tf).requires_grad_()
    got = pointwise_infonce(a, t(pts), b, t(matches), t(mm))
    got.backward()
    _close(n(got), want)
    _grad_close(n(a.grad), ga)
    _grad_close(n(b.grad), gb)


def test_losses_take_a_pair_axis():
    rng = np.random.default_rng(1)
    N, C, M = 80, 8, 20
    pts = rng.uniform(-10, 10, (2, N, 3)).astype(np.float32)
    sf = rng.normal(size=(2, N, C)).astype(np.float32) / 4
    tf = rng.normal(size=(2, N, C)).astype(np.float32) / 4
    mt = rng.integers(0, N, (2, M, 2))
    mm = rng.random((2, M)) < 0.9
    both = n(pointwise_infonce(t(sf), t(pts), t(tf), t(mt), t(mm)))
    for b in range(2):
        one = n(pointwise_infonce(t(sf[b]), t(pts[b]), t(tf[b]), t(mt[b]),
                                  t(mm[b])))
        np.testing.assert_allclose(both[b], one, rtol=1e-6)


def test_ume_contrastive_value_and_grads_match_jax():
    rng, src, tgt, _ = _umes(5)
    km = np.ones(len(src), bool)
    km[[2, 9]] = False
    want, valid_j = jax_ume_loss(jnp.asarray(src), jnp.asarray(tgt),
                                 jnp.asarray(km))
    ga, gb = jax.grad(lambda a, b: jax_ume_loss(a, b, jnp.asarray(km))[0],
                      argnums=(0, 1))(jnp.asarray(src), jnp.asarray(tgt))
    a, b = t(src).requires_grad_(), t(tgt).requires_grad_()
    got, valid = ume_contrastive_loss(a, b, t(km))
    got.backward()
    np.testing.assert_array_equal(n(valid), np.asarray(valid_j))
    _close(n(got), want)
    _grad_close(n(a.grad), ga)
    _grad_close(n(b.grad), gb)


def test_cube_registration_value_and_grads_match_jax():
    rng, src, tgt, T = _umes(6)
    km = np.ones(len(src), bool)
    km[4] = False
    ratio = rng.uniform(0.5, 1.0, len(src)).astype(np.float32)

    def jf(a, b):
        return jax_cube(a, b, jnp.asarray(km), jnp.asarray(T),
                        jnp.asarray(ratio))

    (want, rre_j, rte_j) = jf(jnp.asarray(src), jnp.asarray(tgt))
    ga, gb = jax.grad(lambda a, b: jf(a, b)[0], argnums=(0, 1))(
        jnp.asarray(src), jnp.asarray(tgt))
    a, b = t(src).requires_grad_(), t(tgt).requires_grad_()
    got, rre, rte = cube_registration_loss(a, b, t(km), t(T), t(ratio))
    got.backward()
    _close(n(got), want)
    np.testing.assert_allclose(n(rre), np.asarray(rre_j), atol=2e-3)
    np.testing.assert_allclose(n(rte), np.asarray(rte_j), rtol=1e-4,
                               atol=1e-4)
    _grad_close(n(a.grad), ga)
    _grad_close(n(b.grad), gb)


@pytest.mark.parametrize("values", [
    [0.1, 0.4, 0.2, 0.3],  # even count: the two middle values averaged
    [0.5, np.nan, 0.1, 0.3, np.nan, 0.9],
    [0.2, 0.7, 0.4],
    [np.nan, np.nan]], ids=["even", "even_nan", "odd", "all_nan"])
def test_nanmedian_averages_the_middle_pair(values):
    x = np.asarray(values, np.float32)
    got = n(nanmedian_mean(t(x)))
    want = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-7, equal_nan=True)
    if values[0] == 0.1:  # torch.nanmedian would give the lower one
        assert float(got) == pytest.approx(0.25)
        assert float(torch.nanmedian(t(x))) == pytest.approx(0.2)


def test_cube_median_fallback_with_an_even_count_matches_jax():
    # no keypoint reaches the threshold, so the loss averages those at or
    # above the median of an even count of valid ratios: the averaged
    # median keeps 2 of 4 where the lower one would keep 3
    _, src, tgt, T = _umes(7, K=6)
    km = np.array([1, 1, 0, 1, 1, 0], bool)
    ratio = np.array([0.1, 0.4, 0.9, 0.2, 0.3, 0.9], np.float32)
    want = jax_cube(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(km),
                    jnp.asarray(T), jnp.asarray(ratio))[0]
    got = cube_registration_loss(t(src), t(tgt), t(km), t(T), t(ratio))[0]
    _close(n(got), want)
    per = []
    for use in ([1, 3, 4], [1, 4]):  # lower median 0.2 / averaged 0.25
        w = np.zeros(6, np.float32)
        w[use] = 1
        per.append(n(cube_registration_loss(
            t(src), t(tgt), t(w > 0), t(T), t(np.ones(6, np.float32)))[0]))
    assert abs(float(n(got)) - float(per[1])) < 1e-5 * abs(float(per[1]))
    assert abs(float(per[0]) - float(per[1])) > 1e-3


@pytest.mark.parametrize("n_valid", [0, 1, 3])
def test_keypoint_chain_grads_match_jax_at_few_valid(n_valid):
    """Features -> padded gathers -> UMEs (masked keypoints: all -1) ->
    UME-contrastive + cube losses, as the trainer chains them. With no
    valid keypoint every logit column is -inf: JAX's logsumexp has zero
    gradients there, torch's would give NaN (the port guards it)."""
    rng = np.random.default_rng(40 + n_valid)
    N, C, K, nn_ = 150, 8, 5, 30
    pts = rng.uniform(-4, 4, (N, 3)).astype(np.float32)
    feat = rng.uniform(0.1, 1, (N, C)).astype(np.float32)
    T = _rigid(rng, 1.0)
    tpts = (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    km = np.arange(K) < n_valid
    idx = np.stack([rng.permutation(N)[:nn_] for _ in range(K)])
    idx = np.where(km[:, None], idx, -1)
    ratio = rng.uniform(0.5, 1, K).astype(np.float32)

    def jchain(f, g):
        s = jax_moment_matrix(jax_gather(jnp.asarray(pts), jnp.asarray(idx)),
                              jax_gather(f, jnp.asarray(idx)), normalize=True)
        d = jax_moment_matrix(jax_gather(jnp.asarray(tpts), jnp.asarray(idx)),
                              jax_gather(g, jnp.asarray(idx)), normalize=True)
        s = s * jnp.asarray(km)[:, None, None]
        d = d * jnp.asarray(km)[:, None, None]
        ul, valid = jax_ume_loss(s, d, jnp.asarray(km))
        rl = jax_cube(s, d, valid, jnp.asarray(T), jnp.asarray(ratio))[0]
        return 0.5 * ul + 0.25 * rl

    feat2 = np.abs(feat + rng.normal(size=feat.shape) * 0.5).astype(
        np.float32)
    want, (gf_j, gg_j) = jax.value_and_grad(jchain, argnums=(0, 1))(
        jnp.asarray(feat), jnp.asarray(feat2))
    f, g = t(feat).requires_grad_(), t(feat2).requires_grad_()
    kmt = t(km)[:, None, None].to(torch.float32)
    s = moment_matrix(gather_padded(t(pts), t(idx)), gather_padded(f, t(idx)),
                      normalize=True) * kmt
    d = moment_matrix(gather_padded(t(tpts), t(idx)),
                      gather_padded(g, t(idx)), normalize=True) * kmt
    ul, valid = ume_contrastive_loss(s, d, t(km))
    rl = cube_registration_loss(s, d, valid, t(T), t(ratio))[0]
    got = 0.5 * ul + 0.25 * rl
    got.backward()
    _close(n(got.detach()), want, rtol=1e-4)
    if n_valid == 0:  # nothing to learn from: loss 0, zero gradients
        assert float(got.detach()) == 0.0
        assert not n(f.grad).any() and not n(g.grad).any()
    _grad_close(n(f.grad), gf_j)
    _grad_close(n(g.grad), gg_j)


# --- training keypoints and the inlier ratio ---------------------------

SCENE = SceneConfig(extent=10.0, ground_points=1500, structure_points=2500,
                    n_boxes=6, n_walls=2, n_poles=3, dropout=0.2)


@pytest.fixture(scope="module")
def batch2():
    return make_collated_batch(SCENE, n_pairs=2, max_pc_size=1024,
                               num_matches=64, seed=4)


def _features(batch, C=8, seed=0):
    rng = np.random.default_rng(seed)
    B, N = batch["src_mask"].shape
    f = rng.uniform(0.05, 1, (2, B, N, C)).astype(np.float32)
    return (f[0] * batch["src_mask"][..., None],
            f[1] * batch["tgt_mask"][..., None])


@pytest.mark.parametrize("kw", [
    dict(num_samples=16, max_nn=64, min_nn=8, nn_r=4.0),
    dict(num_samples=32, max_nn=48, min_nn=40, nn_r=3.0),  # density binds
    dict(num_samples=8, max_nn=64, min_nn=8, nn_r=4.0, flat_labels=(),
         normalize=False)], ids=["tiny", "dense", "eval"])
def test_generate_training_umes_matches_jax(batch2, kw):
    sf, tf = _features(batch2)
    b = batch2
    got = generate_training_umes(
        t(b["src_pts"]), t(b["src_seg"]), t(sf), t(b["src_mask"]),
        t(b["tgt_pts"]), t(tf), t(b["tgt_mask"]), t(b["gt_tform"]), **kw)
    for i in range(2):
        want = jax_gen(*(jnp.asarray(x[i]) for x in (
            b["src_pts"], b["src_seg"], sf, b["src_mask"], b["tgt_pts"], tf,
            b["tgt_mask"], b["gt_tform"])), **kw)
        # the selection: same keypoints in the same (descending) order
        np.testing.assert_array_equal(n(got.kp_mask[i]),
                                      np.asarray(want.kp_mask))
        np.testing.assert_array_equal(n(got.src_kpts[i]),
                                      np.asarray(want.src_kpts))
        assert bool(got.approx_truncated[i]) == bool(want.approx_truncated)
        _close(n(got.tgt_kpts[i]), want.tgt_kpts)
        _close(n(got.src_ume[i]), want.src_ume, rtol=1e-4)
        _close(n(got.tgt_ume[i]), want.tgt_ume, rtol=1e-4)
        np.testing.assert_allclose(n(got.nn_intersection_ratio[i]),
                                   np.asarray(want.nn_intersection_ratio),
                                   atol=1e-6)
    assert n(got.kp_mask).any()


def test_generate_training_umes_flags_a_truncated_working_set(batch2):
    # a density filter nearly nothing passes leaves fewer than
    # num_samples survivors of a full working set
    sf, tf = _features(batch2)
    b = batch2
    kw = dict(num_samples=16, max_nn=64, min_nn=60, nn_r=1.5)
    got = generate_training_umes(
        t(b["src_pts"]), t(b["src_seg"]), t(sf), t(b["src_mask"]),
        t(b["tgt_pts"]), t(tf), t(b["tgt_mask"]), t(b["gt_tform"]), **kw)
    want = [bool(jax_gen(*(jnp.asarray(x[i]) for x in (
        b["src_pts"], b["src_seg"], sf, b["src_mask"], b["tgt_pts"], tf,
        b["tgt_mask"], b["gt_tform"])), **kw).approx_truncated)
        for i in range(2)]
    assert n(got.approx_truncated).tolist() == want
    assert any(want)


@pytest.mark.parametrize("shuffle", [False, True])
def test_calc_inlier_ratio_matches_jax(shuffle):
    # exact correspondences and features of height (the JAX package's own
    # test): matched UMEs agree and the assignment is not a near tie;
    # shuffled target features make a low ratio
    from umeregrobust_tpu_torch.data.synthetic import make_pair

    pair = make_pair(SceneConfig(extent=10.0, ground_points=2000,
                                 structure_points=4000, n_boxes=8,
                                 n_walls=3, n_poles=4, dropout=0.0,
                                 noise_std=0.0),
                     max_rotation_deg=30, max_translation=2.0, seed=13)
    rng = np.random.default_rng(0)
    si = rng.choice(len(pair["src_pts"]), 1500, replace=False)
    src = pair["src_pts"][si].astype(np.float32)
    seg = pair["src_seg"][si]
    gt = pair["gt_tform"].astype(np.float32)
    tgt = (src @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)
    z = src[:, 2:3]
    feat = np.concatenate([np.ones_like(z), z, z * z, np.sin(z), np.cos(z),
                           np.exp(-np.abs(z)), np.minimum(z, 1.0), z ** 3],
                          axis=1).astype(np.float32)
    tfeat = feat[rng.permutation(len(feat))] if shuffle else feat
    mask = np.ones(len(src), bool)
    kw = dict(ume_r_nn=4.0, ume_max_nn=128, ume_min_nn=20, eval_num_kpts=24)
    got = calc_inlier_ratio(t(src), t(seg), t(feat), t(mask), t(tgt),
                            t(tfeat), t(mask), t(gt), **kw)
    want = jax_inlier_ratio(*(jnp.asarray(x) for x in (
        src, seg, feat, mask, tgt, tfeat, mask, gt)), **kw)
    assert got == pytest.approx(want, abs=1e-6)
    assert (got < 0.5) if shuffle else (got > 0.5)


# --- BatchNorm in training mode ----------------------------------------

@pytest.mark.parametrize("counts", [(150, 90), (1, 40), (0, 25)],
                         ids=["two", "one_row", "empty"])
def test_batch_norm_train_takes_per_cloud_statistics(counts):
    rng = np.random.default_rng(sum(counts))
    C, N = 16, 256
    feats = rng.normal(size=(N, C)).astype(np.float32) * 3 + 1
    cloud = np.zeros(N, np.int64)
    mask = np.zeros(N, bool)
    mask[: counts[0]] = True
    cloud[128:] = 1
    mask[128: 128 + counts[1]] = True
    feats = feats * mask[:, None]
    scale = rng.uniform(0.5, 2, C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    rm = rng.normal(size=C).astype(np.float32)
    rv = rng.uniform(0.5, 2, C).astype(np.float32)
    out, nm, nv = masked_batch_norm(t(feats), t(mask), t(scale), t(bias),
                                    t(rm), t(rv), train=True, cloud=t(cloud),
                                    n_clouds=2)
    want, means, vars_ = np.zeros_like(feats), [], []
    for c in range(2):
        sel = cloud == c
        o, m_, v_ = jax_bn(jnp.asarray(feats[sel]), jnp.asarray(mask[sel]),
                           jnp.asarray(scale), jnp.asarray(bias),
                           jnp.asarray(rm), jnp.asarray(rv), train=True)
        want[sel] = np.asarray(o)
        means.append(np.asarray(m_))
        vars_.append(np.asarray(v_))
    _close(n(out), want)
    _close(n(nm), np.mean(means, 0))
    _close(n(nv), np.mean(vars_, 0))


def test_batch_norm_eval_returns_the_running_state():
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(20, 4)).astype(np.float32)
    mask = rng.random(20) < 0.7
    p = [t(rng.uniform(0.5, 2, 4).astype(np.float32)) for _ in range(4)]
    out, nm, nv = masked_batch_norm(t(feats), t(mask), *p)
    want = jax_bn(jnp.asarray(feats), jnp.asarray(mask),
                  *(jnp.asarray(n(x)) for x in p), train=False)[0]
    np.testing.assert_array_equal(n(nm), n(p[2]))
    np.testing.assert_array_equal(n(nv), n(p[3]))
    _close(n(out), want)


# --- backward plain versions -------------------------------------------

@pytest.mark.parametrize("shape", [(50, 8, (6, 20)), (300, 32, (4000,)),
                                   (7, 3, (2, 2, 9))])
def test_gather_backward_matches_jax_grad(shape):
    N, C, ishape = shape
    rng = np.random.default_rng(N)
    x = rng.normal(size=(N, C)).astype(np.float32)
    idx = rng.integers(-1, N, ishape)
    g = rng.normal(size=ishape + (C,)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jax_gather(a, jnp.asarray(idx))
                                      * jnp.asarray(g)))(jnp.asarray(x))
    a = t(x).requires_grad_()
    torch.sum(gather_padded(a, t(idx)) * t(g)).backward()
    _grad_close(n(a.grad), want, 1e-5)
    plain = cuda_gather.gather_rows_backward_plain(
        t(g).reshape(-1, C), t(idx).reshape(-1), N)
    np.testing.assert_array_equal(n(plain), n(a.grad))


def test_gather_backward_over_a_pair_axis():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 30, 4)).astype(np.float32)
    idx = rng.integers(-1, 30, (2, 5, 7))
    g = rng.normal(size=(2, 5, 7, 4)).astype(np.float32)
    a = t(x).requires_grad_()
    torch.sum(gather_padded(a, t(idx)) * t(g)).backward()
    for b in range(2):
        want = jax.grad(lambda v: jnp.sum(
            jax_gather(v, jnp.asarray(idx[b])) * jnp.asarray(g[b])))(
            jnp.asarray(x[b]))
        _grad_close(n(a.grad[b]), want, 1e-5)


@pytest.fixture(scope="module")
def resunet_maps():
    """The per-tap maps of a ResUNet pyramid (k7 stem, k5 strided encoder
    and transposed decoder maps, k3 self maps) on a small voxel cloud."""
    coords, mask = voxel_cloud(5, n_vox=300, cap=384, lim=20)
    caps = (384, 256, 256, 128, 128, 128)
    geom = build_unet_geometry(t(coords), t(mask), ARCHS["ResUNet"], caps)
    lv = [int(l.coords.shape[0]) for l in geom["levels"]]
    return {"stem_k7": (geom["enc_maps"][0], lv[0]),
            "self_k3": (geom["block_maps"][1], lv[1]),
            "strided_k5": (geom["enc_maps"][1], lv[0]),
            "transpose_k5": (geom["dec_maps"][-1], lv[1])}


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["stem_k7", "self_k3", "strided_k5",
                                   "transpose_k5"])
def test_per_tap_conv_backward_matches_jax_grad(resunet_maps, which, cd):
    nbr, n_in = resunet_maps[which]
    K, n_out = nbr.shape
    assert int((nbr >= 0).sum()) > 0
    rng = np.random.default_rng(K)
    cin, cout = (1, 16) if which == "stem_k7" else (12, 20)
    x = rng.normal(size=(n_in, cin)).astype(np.float32)
    w = (rng.normal(size=(K, cin, cout)) * 0.2).astype(np.float32)
    g = rng.normal(size=(n_out, cout)).astype(np.float32)
    dt = getattr(torch, cd)
    a, b = t(x).requires_grad_(), t(w).requires_grad_()
    torch.sum(sparse_conv(a, b, nbr, compute_dtype=dt) * t(g)).backward()
    # the plain versions alone: dX = the conv of dY over the inverted map
    # with the weights transposed, dW per tap
    inv = invert_map_batch(nbr, n_in)
    dx = n(cuda_conv.sparse_conv_plain(t(g), t(w).transpose(1, 2), inv, dt))
    dw = n(cuda_conv.sparse_conv_wgrad_plain(t(x), t(g), nbr, dt))
    np.testing.assert_array_equal(n(a.grad), dx)
    np.testing.assert_array_equal(n(b.grad), dw)
    if cd == "float32":  # the reference's gradient, at fp32
        jx, jw = jax.grad(lambda p, q: jnp.sum(jax_sparse_conv(
            p, q, jnp.asarray(n(nbr), jnp.int32)) * jnp.asarray(g)),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        _grad_close(dx, jx, 1e-5)
        _grad_close(dw, jw, 1e-5)


@pytest.fixture(scope="module")
def small2_maps():
    """The grouped k3 maps of a ResUNetSmall2 pyramid on a small voxel
    cloud: a self map, a strided encoder map (N_out < N_in) and a
    transposed decoder map (N_out > N_in)."""
    coords, mask = voxel_cloud(6, n_vox=300, cap=384, lim=20)
    geom = build_unet_geometry(t(coords), t(mask), ARCHS["ResUNetSmall2"],
                               (384, 384, 256, 128, 128))
    lv = [int(l.coords.shape[0]) for l in geom["levels"]]
    return {"self": (geom["block_g"][1], lv[1]),
            "strided": (geom["enc_g"][1], lv[0]),
            "transposed": (geom["dec_g"][-1], lv[1])}


@pytest.mark.parametrize("which", ["self", "strided", "transposed"])
def test_grouped_conv_backward_matches_jax_grad(small2_maps, which):
    # the default path's k3 convs train through autograd (the window
    # gathers' backward is gather_rows_backward's plain version on the CPU)
    from umeregrobust_tpu.ops.sparse import GroupedMap as JGroupedMap
    from umeregrobust_tpu.ops.sparse import (
        sparse_conv_grouped as jax_grouped)
    from umeregrobust_tpu_torch.ops.sparse import sparse_conv_grouped

    gmap, n_in = small2_maps[which]
    rng = np.random.default_rng(len(which))
    x = rng.normal(size=(n_in, 12)).astype(np.float32)
    w = (rng.normal(size=(27, 12, 20)) * 0.2).astype(np.float32)
    g = rng.normal(size=(gmap.center.shape[1], 20)).astype(np.float32)
    jmap = JGroupedMap(*(jnp.asarray(n(f).astype(np.int32))
                         if f.dtype == torch.int64 else jnp.asarray(n(f))
                         for f in gmap[:4]))
    want = jax.grad(lambda p, q: jnp.sum(jax_grouped(p, q, jmap)
                                         * jnp.asarray(g)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    a, b = t(x).requires_grad_(), t(w).requires_grad_()
    torch.sum(sparse_conv_grouped(a, b, gmap) * t(g)).backward()
    _grad_close(n(a.grad), want[0], 1e-5)
    _grad_close(n(b.grad), want[1], 1e-5)
