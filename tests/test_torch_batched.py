"""Pair batching in the port: the three kernels' plain versions over a
leading pair axis (each with a ragged mask per pair and one pair that is
all padding) against a loop over pairs and against the JAX Pallas kernels
in interpret mode; the flattened row gather; ICP stopping per pair;
register_pairs_batched against register_pair_e2e pair by pair and against
the JAX package's register_pairs_batched; and the level capacities when
a level overflows (each pair keeps the rows its own pyramid keeps, the
rows of the JAX package's build_unet_geometry)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import umeregrobust_tpu.ops.pallas_corr as jpc
from _torch_parity import CAPS, SMALL_CFG, WEIGHTS, n, rot_deg, t
from umeregrobust_tpu.models.resunet import (
    ARCHS as JARCHS, build_unet_geometry as jax_geometry)
from umeregrobust_tpu.ops.pallas_nn import nn1_argmin as jax_nn1
from umeregrobust_tpu.ops.pallas_ume import ume_moments_fused as jax_ume
from umeregrobust_tpu.pipeline.e2e import register_pairs_batched as jax_batched
from umeregrobust_tpu.pipeline.registration import (
    RegistrationConfig as JaxConfig)
from umeregrobust_tpu.train.checkpoint import load_checkpoint as jax_load
from umeregrobust_tpu_torch.data.suite import small_pair
from umeregrobust_tpu_torch.models.resunet import ARCHS, build_unet_geometry
from umeregrobust_tpu_torch.models.weights import load_model
from umeregrobust_tpu_torch.ops.cuda_corr import (
    corr_scores_fused, corr_scores_plain)
from umeregrobust_tpu_torch.ops.cuda_nn import nn1_argmin, nn1_argmin_plain
from umeregrobust_tpu_torch.ops.cuda_ume import (
    ume_moments_fused, ume_moments_plain)
from umeregrobust_tpu_torch.ops.densegrid import build_dense_grid
from umeregrobust_tpu_torch.ops.neighbors import gather_padded, take_rows
from umeregrobust_tpu_torch.pipeline.e2e import (
    pair_features_batched, pair_features_e2e, register_pair_e2e,
    register_pairs_batched)
from umeregrobust_tpu_torch.pipeline.icp import icp_loop
from umeregrobust_tpu_torch.pipeline.registration import (
    RegistrationConfig, refine_with_icp)

B = 3  # pairs in a kernel test; the last is all padding


def _masks(rng, N):
    """(B, N) masks: a valid prefix of its own length per pair with holes,
    and a last pair that is all padding."""
    m = np.zeros((B, N), bool)
    for b in range(B - 1):
        k = int(rng.integers(N // 3, N))
        m[b, :k] = rng.random(k) < 0.9
    return m


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's Pallas scorer in interpret mode."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jpc.pl, "pallas_call", patched)


def test_nn1_argmin_pair_axis_matches_pairs_and_pallas():
    rng = np.random.default_rng(0)
    N, M = 400, 70
    p = (rng.normal(size=(B, N, 3)) * 8).astype(np.float32)
    q = (rng.normal(size=(B, M, 3)) * 8).astype(np.float32)
    pm = _masks(rng, N)
    got = n(nn1_argmin(t(q), t(p), t(pm)))
    assert got.shape == (B, M) and got.dtype == np.int64
    for b in range(B):
        np.testing.assert_array_equal(
            got[b], n(nn1_argmin_plain(t(q[b]), t(p[b]), t(pm[b]))))
        np.testing.assert_array_equal(got[b], np.asarray(jax_nn1(
            jnp.asarray(q[b]), jnp.asarray(p[b]), jnp.asarray(pm[b]), ts=32,
            sl=128, interpret=True)))
    assert all(pm[b][got[b]].all() for b in range(B - 1))
    assert (got[-1] == 0).all()  # all padding: parked rows, first index


def test_ume_moments_pair_axis_matches_pairs_and_pallas():
    rng = np.random.default_rng(1)
    N, M, r, cap = 600, 24, 3.0, 12
    pts = (rng.normal(size=(B, N, 3)) * 5).astype(np.float32)
    # keep every point >= 1e-4 off every keypoint's radius (the two
    # distance formulas cannot disagree there)
    kpts = np.stack([pts[b, rng.choice(N, M, replace=False)] for b in
                     range(B)]) + np.float32(0.1)
    d = np.sqrt(((kpts[:, :, None].astype(np.float64)
                  - pts[:, None]) ** 2).sum(-1))
    pts[np.abs(d - r).min(1) < 1e-4] = 1e3
    mask = _masks(rng, N)
    Z = rng.normal(size=(B, N, 128)).astype(np.float32) * mask[..., None]
    Z[..., 5] = mask  # counts contributors
    got = n(ume_moments_fused(t(kpts), t(pts), t(Z), t(mask), r, cap))
    assert got.shape == (B, M, 128)
    for b in range(B):
        one = n(ume_moments_plain(t(kpts[b]), t(pts[b]), t(Z[b]), t(mask[b]),
                                  r, cap))
        np.testing.assert_allclose(got[b], one, rtol=1e-6, atol=1e-5)
        want = np.asarray(jax_ume(jnp.asarray(kpts[b]), jnp.asarray(pts[b]),
                                  jnp.asarray(Z[b]), jnp.asarray(mask[b]),
                                  radius=r, max_nn=cap, interpret=True))
        np.testing.assert_array_equal(got[b][:, 5], want[:, 5])  # counts
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-4)
    assert got[0][:, 5].max() == cap  # the cap binds somewhere
    assert (got[-1] == 0).all()


def test_corr_scores_pair_axis_matches_pairs_and_pallas(pallas_interpret):
    rng = np.random.default_rng(2)
    H, S, T = 6, 40, 256
    pts = rng.uniform(-6, 6, (B, H, S, 4)).astype(np.float32)
    tp = rng.uniform(-6, 6, (B, T, 4)).astype(np.float32)
    pts[..., 3], tp[..., 3] = 0, 0
    sm, tm = _masks(rng, S), _masks(rng, T)
    f = rng.normal(size=(B, S, 32)).astype(np.float32) * sm[..., None]
    g = rng.normal(size=(B, T, 32)).astype(np.float32) * tm[..., None]
    got = n(corr_scores_fused(t(pts), t(f), t(tp), t(g), sigma=1.5))
    assert got.shape == (B, H)
    for b in range(B):
        one = n(corr_scores_plain(t(pts[b]), t(f[b]), t(tp[b]), t(g[b]),
                                  sigma=1.5))
        np.testing.assert_allclose(got[b], one, rtol=1e-6, atol=1e-6)
        want = np.asarray(jpc.corr_scores_fused(
            jnp.asarray(pts[b]), jnp.asarray(f[b]), jnp.asarray(tp[b]),
            jnp.asarray(g[b]), sigma=1.5, radius_factor=2.0, ts=8, tt=128))
        np.testing.assert_allclose(got[b], want, rtol=1e-4, atol=1e-4)
    assert np.abs(got[0]).max() > 0 and (got[-1] == 0).all()


def test_gather_padded_pair_axis_is_one_flattened_gather():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 50, 8)).astype(np.float32)
    idx = rng.integers(-1, 50, (B, 30, 4))
    got = n(gather_padded(t(x), t(idx)))
    assert got.shape == (B, 30, 4, 8)
    for b in range(B):
        np.testing.assert_array_equal(got[b], n(gather_padded(t(x[b]),
                                                              t(idx[b]))))
    assert (got[idx < 0] == 0).all()


@pytest.mark.parametrize("pairs", [1, 3])
def test_gather_padded_pair_axis_keeps_indices_past_n_in_their_pair(pairs):
    # idx == N names no row: a zero row, never a row of the next pair (and
    # one pair takes its own table with no offset)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(pairs, 20, 5)).astype(np.float32)
    idx = rng.integers(-1, 21, (pairs, 40))
    got = n(gather_padded(t(x), t(idx)))
    for b in range(pairs):
        ok = (idx[b] >= 0) & (idx[b] < 20)
        np.testing.assert_array_equal(got[b][ok], x[b][idx[b][ok]])
        assert (got[b][~ok] == 0).all()


@pytest.mark.parametrize("rest", [(), (3,), (4, 4)])
def test_take_rows_takes_each_pairs_rows(rest):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 11) + rest).astype(np.float32)
    idx = rng.integers(0, 11, (B, 7))
    got = n(take_rows(t(x), t(idx)))
    assert got.shape == (B, 7) + rest
    for b in range(B):
        np.testing.assert_array_equal(got[b], x[b][idx[b]])
    # no leading axis: plain indexing
    np.testing.assert_array_equal(n(take_rows(t(x[0]), t(idx[0]))),
                                  x[0][idx[0]])


def _rot_z(a, tr):
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = tr
    return T


def _surface_pair(seed, S=600, T=700):
    """A wavy surface, its rigidly moved noisy copy and the ground truth
    (the cloud model of tests/test_torch_icp.py)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, 10, (T, 2))
    z = 0.6 * np.sin(xy[:, 0] * 0.7) + 0.4 * np.cos(xy[:, 1] * 0.9)
    tgt = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    gt = _rot_z(0.3, [0.8, -0.5, 0.05])
    inv = np.linalg.inv(gt)
    src = (tgt[:S] @ inv[:3, :3].T + inv[:3, 3]
           + rng.normal(scale=0.01, size=(S, 3))).astype(np.float32)
    return src, rng.random(S) > 0.05, tgt, rng.random(T) > 0.05, gt


def test_icp_stops_per_pair():
    """Two pairs whose own runs stop after different block counts: in one
    batch each stops where it stops alone (frozen after), with its own
    transform, rmse, fitness and sub-iterations."""
    (s0, sm0, t0, tm0, gt0), (s1, sm1, t1, tm1, gt1) = (_surface_pair(5),
                                                         _surface_pair(6))
    inits = [gt0 @ _rot_z(0.004, [0.02, 0.0, 0.0]),
             gt1 @ _rot_z(0.05, [0.3, -0.2, 0.0])]
    cell, dims = 0.4, (64, 64, 16)
    alone = []
    for s, sm, tg, tm, init in ((s0, sm0, t0, tm0, inits[0]),
                                (s1, sm1, t1, tm1, inits[1])):
        grid = build_dense_grid(t(tg), t(tm), cell, dims)
        alone.append(icp_loop(t(s), t(sm), grid, t(init), 0.4, 60, 16,
                              inner=4, disp_exit=1e-4))
    assert alone[0][3] != alone[1][3]  # the pairs stop at different blocks
    grid = build_dense_grid(t(np.stack([t0, t1])), t(np.stack([tm0, tm1])),
                            cell, dims)
    T, rmse, fit, it = icp_loop(t(np.stack([s0, s1])),
                                t(np.stack([sm0, sm1])), grid,
                                t(np.stack(inits)), 0.4, 60, 16, inner=4,
                                disp_exit=1e-4)
    for b, (Ta, ra, fa, ia) in enumerate(alone):
        assert int(it[b]) == ia
        np.testing.assert_allclose(n(T[b]), n(Ta), atol=1e-6)
        np.testing.assert_allclose(float(rmse[b]), float(ra), rtol=1e-6)
        np.testing.assert_allclose(float(fit[b]), float(fa), rtol=1e-6)

    # the refine schedule reports per-pair iterations per stage
    cfg = RegistrationConfig(icp_max_corr=0.4, icp_max_iter=60,
                             icp_multires=256, icp_multires_iter=20,
                             icp_dims=(64, 64, 16), icp_budget=16,
                             icp_inner=4, icp_disp_exit=1e-4)
    Tb, _, _, iters = refine_with_icp(
        cfg, t(np.stack(inits)), t(np.stack([s0, s1])),
        t(np.stack([sm0, sm1])), t(np.stack([t0, t1])),
        t(np.stack([tm0, tm1])), return_iters=True)
    for b, (s, sm, tg, tm) in enumerate(((s0, sm0, t0, tm0),
                                         (s1, sm1, t1, tm1))):
        Ta, _, _, ia = refine_with_icp(cfg, t(inits[b]), t(s), t(sm), t(tg),
                                       t(tm), return_iters=True)
        assert [int(i[b]) for i in iters] == ia
        np.testing.assert_allclose(n(Tb[b]), n(Ta), atol=1e-6)


def _stack(pairs):
    keys = (("src", "coords"), ("src", "grid"), ("src", "mask"),
            ("tgt", "coords"), ("tgt", "grid"), ("tgt", "mask"),
            ("src", "corr_pts"), ("src", "corr_mask"),
            ("tgt", "corr_pts"), ("tgt", "corr_mask"))
    return [np.stack([p[a][b] for p in pairs]) for a, b in keys]


def test_register_pairs_batched_matches_register_pair_e2e():
    """Three small pairs as one batch against each alone with the same
    generator (consensus gate on: the batch reads it once)."""
    cfg = RegistrationConfig(**dict(SMALL_CFG, consensus_gate_inliers=0.3))
    pairs = [small_pair(s) for s in (42, 7, 8)]
    model = load_model(WEIGHTS, ARCHS["ResUNetSmall2"], device="cpu")

    def gen(i):
        return torch.Generator().manual_seed(100 + i)

    Tib, Trb = register_pairs_batched(
        model, CAPS, cfg, *_stack(pairs), compute_dtype=torch.float32,
        generators=[gen(i) for i in range(3)], device="cpu")
    assert Tib.shape == Trb.shape == (3, 4, 4)
    for i, p in enumerate(pairs):
        Ti, Tr = register_pair_e2e(
            model, CAPS, cfg, *(a[0] for a in _stack([p])),
            compute_dtype=torch.float32, generator=gen(i), device="cpu")
        # the same selected hypothesis, and ICP from it to the same end
        np.testing.assert_allclose(n(Tib[i]), n(Ti), atol=1e-5)
        np.testing.assert_allclose(n(Trb[i]), n(Tr), atol=1e-5)
        assert rot_deg(n(Trb[i])[:3, :3], p["gt"][:3, :3]) < 1.0


def test_register_pairs_batched_matches_jax():
    """Two small pairs through both packages' register_pairs_batched (the
    config of tests/test_torch_e2e.py, fp32 backbone), the JAX keypoint
    draws of keys[i] injected into pair i."""
    from test_torch_e2e import _jax_keypoint_draws

    cfg_kw = dict(SMALL_CFG, filter_mode="topk")
    pairs = [small_pair(s) for s in (42, 7)]
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    blob = jax_load(WEIGHTS)
    jTi, jTr = jax_batched(
        blob["params"], blob["bn_state"], JARCHS["ResUNetSmall2"], CAPS,
        JaxConfig(**cfg_kw), keys, *(jnp.asarray(a) for a in _stack(pairs)),
        compute_dtype=jnp.float32)
    model = load_model(WEIGHTS, ARCHS["ResUNetSmall2"], device="cpu")
    Ti, Tr = register_pairs_batched(
        model, CAPS, RegistrationConfig(**cfg_kw), *_stack(pairs),
        compute_dtype=torch.float32,
        draws=[_jax_keypoint_draws(keys[i], p, cfg_kw["num_init_keypoints"])
               for i, p in enumerate(pairs)], device="cpu")
    for i, p in enumerate(pairs):
        a, b, c, d = (np.asarray(n(x)[i], np.float64)
                      for x in (Ti, jTi, Tr, jTr))
        np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_allclose(c, d, atol=1e-3)
        assert rot_deg(c[:3, :3], d[:3, :3]) < 0.05
        assert rot_deg(c[:3, :3], p["gt"][:3, :3]) < 1.0


def _fused(pair, cloud0):
    """A pair's two clouds in one coordinate set, batch indices cloud0
    (source) and cloud0 + 1 (target) on valid rows."""
    c = [pair[k]["coords"].copy() for k in ("src", "tgt")]
    m = [pair[k]["mask"] for k in ("src", "tgt")]
    for j in range(2):
        c[j][:, 0] = np.where(m[j], cloud0 + j, c[j][:, 0])
    return np.concatenate(c), np.concatenate(m)


@pytest.mark.parametrize("arch", ["ResUNetSmall2", "ResUNet4"])
def test_overflowing_level_keeps_the_rows_of_the_reference(arch):
    """Capacities so tight that level 1 (and more) fill: the port's
    pyramid of one pair, and each pair's rows in a batch of three, are the
    rows of the JAX package's build_unet_geometry at 2 x caps."""
    caps = (2048, 256, 128, 64, 32, 32)[:len(ARCHS[arch].channels)]
    caps2 = tuple(2 * c for c in caps)
    pairs = [small_pair(s) for s in (42, 7, 8)]
    want = []
    for p in pairs:
        c, m = _fused(p, 0)
        jg = jax_geometry(jnp.asarray(c), jnp.asarray(m), JARCHS[arch], caps2)
        want.append([(np.asarray(lv.coords)[np.asarray(lv.mask)])
                     for lv in jg["levels"]])
        tg = build_unet_geometry(t(c), t(m), ARCHS[arch], caps2)
        for lv, w in zip(tg["levels"], want[-1]):
            np.testing.assert_array_equal(n(lv.coords)[n(lv.mask)], w)
    assert all(len(w[1]) == caps2[1] for w in want)  # level 1 is full
    cm = [_fused(p, 2 * i) for i, p in enumerate(pairs)]
    bg = build_unet_geometry(t(np.concatenate([c for c, _ in cm])),
                             t(np.concatenate([m for _, m in cm])),
                             ARCHS[arch], caps2, pairs=len(pairs))
    for lvl, lv in enumerate(bg["levels"]):
        assert lv.coords.shape[0] == len(pairs) * (caps2[lvl] if lvl else
                                                   2 * 2048)
        rows = n(lv.coords)[n(lv.mask)]
        for i, w in enumerate(want):
            mine = rows[rows[:, 0] // 2 == i].copy()
            mine[:, 0] -= 2 * i
            np.testing.assert_array_equal(mine, w[lvl])


def test_pair_features_batched_matches_pair_features_e2e():
    pairs = [small_pair(s) for s in (42, 7)]
    model = load_model(WEIGHTS, ARCHS["ResUNetSmall2"], device="cpu")
    got = pair_features_batched(model, CAPS, *_stack(pairs),
                                compute_dtype=torch.float32, device="cpu")
    for i, p in enumerate(pairs):
        one = pair_features_e2e(model, CAPS, *(a[0] for a in _stack([p])),
                                compute_dtype=torch.float32, device="cpu")
        for g, w in zip(got, one):
            np.testing.assert_allclose(n(g[i]), n(w), atol=1e-6)
