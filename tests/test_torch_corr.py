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
from _torch_parity import n, t
from umeregrobust_tpu_torch.ops.cuda_corr import corr_scores_fused
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


@pytest.mark.parametrize("H,S,T", [(5, 16, 256), (9, 40, 128)])
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
