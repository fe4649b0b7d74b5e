"""Kernel corr_scores_fused (plain version on CPU tensors) against an f64
oracle and the JAX Pallas kernel in interpret mode; the weighted-feature
preparation and select_best_transform's triage -> coarse -> exact cascade
against the JAX package with the JAX subset draws injected."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

import umeregrobust_tpu.ops.pallas_corr as jpc
import umeregrobust_tpu.pipeline.correlator as jcorr
import torch

from _torch_parity import n, t
from umeregrobust_tpu_torch.ops import _build, cuda_corr
from umeregrobust_tpu_torch.ops.cuda_corr import (
    corr_scores_fused, corr_scores_plain, launch_plan)
from umeregrobust_tpu_torch.pipeline import correlator


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's Pallas calls in interpret mode, and its radius scorer through
    the fused Pallas path (the path the TPU runs) instead of the bf16 XLA
    fallback of the CPU."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jpc.pl, "pallas_call", patched)

    def score(mode, *a, knn_k=20, sigma=1.5, chunk=1024):
        return jcorr.correlator_scores_radius_fused(*a, sigma=sigma)

    monkeypatch.setattr(jcorr, "_score", score)


def _oracle(pts_t, f, tp, g, sigma, rf):
    out = []
    for h in range(pts_t.shape[0]):
        d2 = ((pts_t[h, :, None, :3].astype(np.float64)
               - tp[None, :, :3].astype(np.float64)) ** 2).sum(-1)
        w = np.where(d2 <= (rf * sigma) ** 2, 1 / (1 + d2 / sigma ** 2), 0)
        out.append((w * (f.astype(np.float64) @ g.T.astype(np.float64))).sum())
    return np.asarray(out)


def _inputs(seed, H, S, T, C=32, spread=6.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-spread, spread, (H, S, 4)).astype(np.float32)
    pts[..., 3] = 0
    tp = rng.uniform(-spread, spread, (T, 4)).astype(np.float32)
    tp[:, 3] = 0
    f = rng.normal(size=(S, C)).astype(np.float32)
    g = rng.normal(size=(T, C)).astype(np.float32)
    return pts, f, tp, g


@pytest.mark.parametrize("H,S,T", [
    (5, 16, 256), (9, 40, 128),
    # ragged: H of 1, 7, 9; S off the warp; T off the kernel's tile of 128
    (1, 33, 1000), (7, 50, 300), (9, 300, 77), (3, 5, 1), (17, 257, 129),
    (2, 64, 128)])
def test_plain_scores_match_f64_oracle(H, S, T):
    pts, f, tp, g = _inputs(H, H, S, T)
    got = n(corr_scores_fused(t(pts), t(f), t(tp), t(g), sigma=1.5,
                              radius_factor=2.0))
    np.testing.assert_allclose(got, _oracle(pts, f, tp, g, 1.5, 2.0),
                               rtol=1e-5, atol=1e-5)


def test_plain_scores_match_pallas_interpret(pallas_interpret):
    pts, f, tp, g = _inputs(0, 10, 16, 256)
    got = n(corr_scores_fused(t(pts), t(f), t(tp), t(g), sigma=1.5))
    want = np.asarray(jpc.corr_scores_fused(
        jnp.asarray(pts), jnp.asarray(f), jnp.asarray(tp), jnp.asarray(g),
        sigma=1.5, radius_factor=2.0, ts=8, tt=128))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("H,S,T", [(5, 16, 256), (9, 40, 300), (1, 70, 33)])
def test_plain_scores_do_not_depend_on_the_source_rows_order(H, S, T):
    """The kernel sweeps the source rows in the caller's order and leaves
    their layout to the caller. Tolerance 1e-5 x max |score|: the same fp32
    products added in another order."""
    pts, f, tp, g = _inputs(20 + H, H, S, T)
    perm = np.random.default_rng(H).permutation(S)
    want = corr_scores_plain(t(pts), t(f), t(tp), t(g), sigma=1.5)
    got = corr_scores_plain(t(pts[:, perm]), t(f[perm]), t(tp), t(g),
                            sigma=1.5)
    scale = float(want.abs().max())
    assert scale > 1.0
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-5 * scale)


def test_reordered_source_rows_match_pallas_interpret(pallas_interpret):
    """Tolerance as test_plain_scores_match_pallas_interpret: the Pallas
    kernel tiles the sums and takes its feature tile from the MXU path."""
    pts, f, tp, g = _inputs(0, 10, 16, 256)
    perm = np.random.default_rng(1).permutation(16)
    got = n(corr_scores_fused(t(pts[:, perm]), t(f[perm]), t(tp), t(g),
                              sigma=1.5))
    want = np.asarray(jpc.corr_scores_fused(
        jnp.asarray(pts), jnp.asarray(f), jnp.asarray(tp), jnp.asarray(g),
        sigma=1.5, radius_factor=2.0, ts=8, tt=128))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_no_triple_in_radius_scores_exact_zeros(pallas_interpret):
    """Exact: every weight is the literal 0 of the radius test, in the
    plain version and in the Pallas kernel alike."""
    pts, f, tp, g = _inputs(3, 9, 24, 256)
    tp[:, :3] += 1e3
    got = n(corr_scores_fused(t(pts), t(f), t(tp), t(g), sigma=1.5))
    want = np.asarray(jpc.corr_scores_fused(
        jnp.asarray(pts), jnp.asarray(f), jnp.asarray(tp), jnp.asarray(g),
        sigma=1.5, radius_factor=2.0, ts=8, tt=128))
    assert got.shape == (9,) and not got.any() and not want.any()


def test_rows_without_features_add_nothing_wherever_they_lie():
    """Masked rows carry zero features; parked far away or left inside the
    scene they add an exact 0 (weights are finite), so the scores are the
    ones of the rows that remain. Tolerance 1e-5 x max |score|: the
    remaining products are added in another grouping."""
    pts, f, tp, g = _inputs(4, 6, 32, 200)
    keep = np.arange(200) % 3 != 0
    g[~keep] = 0
    inside = n(corr_scores_plain(t(pts), t(f), t(tp), t(g), sigma=1.5))
    parked = tp.copy()
    parked[~keep, :3] = 1e6
    far = n(corr_scores_plain(t(pts), t(f), t(parked), t(g), sigma=1.5))
    dropped = n(corr_scores_plain(t(pts), t(f), t(tp[keep]), t(g[keep]),
                                  sigma=1.5))
    scale = np.abs(dropped).max()
    np.testing.assert_allclose(inside, dropped, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(far, dropped, rtol=0, atol=1e-5 * scale)


def test_cpu_tensors_never_reach_the_kernel_library(monkeypatch):
    def boom():
        raise AssertionError("the CPU branch asked for the CUDA library")

    monkeypatch.setattr(_build, "load_library", boom)
    before = cuda_corr.LAUNCHES
    pts, f, tp, g = _inputs(5, 3, 8, 40)
    got = corr_scores_fused(t(pts), t(f), t(tp), t(g), sigma=1.5)
    np.testing.assert_allclose(n(got), _oracle(pts, f, tp, g, 1.5, 2.0),
                               rtol=1e-5, atol=1e-5)
    assert cuda_corr.LAUNCHES == before  # counts kernel launches only


@pytest.mark.parametrize("H,S,T,want", [
    # the four stages of the reduced operating point
    (2048, 256, 512, (1, 4)), (512, 512, 1024, (2, 8)),
    (4, 4096, 4096, (16, 32)), (17, 2048, 2048, (8, 16)),
    # ragged: T not a multiple of the tile
    (1, 33, 1000, (1, 8)), (9, 300, 777, (2, 7)),
    # a grid that fills the card sweeps all targets in one block
    (2100, 257, 700, (2, 1)), (3, 5, 1, (1, 1))])
def test_launch_plan_covers_every_target_once(H, S, T, want):
    n_src, n_seg = launch_plan(H, S, T)
    assert (n_src, n_seg) == want
    assert n_src * 256 >= S > (n_src - 1) * 256
    # one block for all the targets, or one for each tile of 128
    assert n_seg in (1, -(-T // 128))
    # the sweep is split only where the grid would not fill the card
    assert (n_seg > 1) <= (n_src * -(-H // 8) < 264)


@pytest.mark.parametrize("fn", ["correlator_scores_radius",
                                "correlator_scores_radius_fused"])
def test_radius_scorers_match_jax_fused_path(pallas_interpret, fn):
    """Transforming, masking and normalising by N around the kernel."""
    sp, sf, sm, tp, tf, tm, gt = _scene(4, S=300, T=200)
    rng = np.random.default_rng(5)
    Ts = np.tile(gt, (6, 1, 1))
    Ts[1:, :2, 3] += rng.normal(scale=0.5, size=(5, 2)).astype(np.float32)
    got = n(getattr(correlator, fn)(t(sp), t(sf), t(sm), t(tp), t(tf), t(tm),
                                    t(Ts), sigma=1.5))
    want = np.asarray(jcorr.correlator_scores_radius_fused(
        *(jnp.asarray(a) for a in (sp, sf, sm, tp, tf, tm, Ts)), sigma=1.5))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def _scene(seed, S=512, T=512):
    rng = np.random.default_rng(seed)
    sp = rng.uniform(-15, 15, (S, 3)).astype(np.float32)
    sp[:, 2] *= 0.2
    ang = 0.4
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1]], np.float32)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3], gt[:3, 3] = R, [1.5, -2.0, 0.1]
    tgt = (sp[:T] @ R.T + gt[:3, 3] + rng.normal(scale=0.02, size=(T, 3))
           ).astype(np.float32)
    feat = np.tanh(sp[:, :1] * 0.3 + np.sin(sp[:, 1:2] * 0.5) * np.arange(
        1, 33)[None] * 0.1).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=1, keepdims=True)
    sm = rng.random(S) > 0.05
    tm = rng.random(T) > 0.05
    return sp, feat * sm[:, None], sm, tgt, feat[:T] * tm[:, None], tm, gt


@pytest.mark.parametrize("anchors", [None, 128])
def test_prepare_weighted_features_matches_jax(anchors):
    sp, sf, sm, tp, tf, tm, _ = _scene(1)
    got = correlator.prepare_weighted_features(
        t(sp), t(sf), t(sm), t(tp), t(tf), t(tm), var_knn=20,
        var_anchors=anchors)
    want = jcorr.prepare_weighted_features(
        *(jnp.asarray(a) for a in (sp, sf, sm, tp, tf, tm)), var_knn=20,
        approx_var=False, var_anchors=anchors)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5)


def test_select_best_transform_cascade_matches_jax(pallas_interpret):
    sp, sf, sm, tp, tf, tm, gt = _scene(2)
    rng = np.random.default_rng(3)
    H = 48
    Ts = np.tile(np.eye(4, dtype=np.float32), (H, 1, 1))
    ang = rng.uniform(-np.pi, np.pi, H)
    Ts[:, 0, 0], Ts[:, 0, 1] = np.cos(ang), -np.sin(ang)
    Ts[:, 1, 0], Ts[:, 1, 1] = np.sin(ang), np.cos(ang)
    Ts[:, :2, 3] = rng.uniform(-4, 4, (H, 2))
    Ts[7] = gt
    Ts[30] = gt
    Ts[30, :2, 3] += 0.3  # a near-GT runner-up
    kw = dict(sigma=1.5, var_knn=20, coarse_src=256, coarse_tgt=256,
              rescore_top=4, triage_src=128, triage_tgt=256, triage_top=16,
              var_anchors=128)
    key = jax.random.PRNGKey(5)
    # the subsets select_best_transform draws from `key`
    k2, k_ts, k_tt = jax.random.split(key, 3)
    k_src, k_tgt = jax.random.split(k2)
    draws = {
        "triage_src": jax.random.choice(k_ts, 512, (128,), replace=False),
        "triage_tgt": jax.random.choice(k_tt, 512, (256,), replace=False),
        "coarse_src": jax.random.choice(k_src, 512, (256,), replace=False),
        "coarse_tgt": jax.random.choice(k_tgt, 512, (256,), replace=False)}
    bj, sj = jcorr.select_best_transform(
        *(jnp.asarray(a) for a in (sp, sf, sm, tp, tf, tm, Ts)), key=key,
        mode="radius", **kw)
    bt, st = correlator.select_best_transform(
        t(sp), t(sf), t(sm), t(tp), t(tf), t(tm), t(Ts), mode="radius",
        draws={k: np.asarray(v) for k, v in draws.items()}, **kw)
    sj, st = np.asarray(sj), n(st)
    # same winner, same finalist (top-k) set, same exact scores
    np.testing.assert_allclose(n(bt), np.asarray(bj), atol=1e-6)
    np.testing.assert_array_equal(np.isfinite(st), np.isfinite(sj))
    fin = np.isfinite(sj)
    np.testing.assert_allclose(st[fin], sj[fin], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(n(bt), gt, atol=1e-6)
