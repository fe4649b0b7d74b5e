"""The RegistrationConfig paths of the port against the JAX package's, on
the same numpy inputs: dense_nn_query and the grid feature copy
(feat_copy_radius), ICP at icp_inner=1, the kNN correlator
(corr_mode="knn"), the argmin path without the UME-distance filter, the
second round's overlap weights and the round itself (sr_kpts), and the
reference-parity profile of the CLI. The JAX draws go into the port
through `draws`; the JAX radius scorer runs its Pallas kernel in
interpret mode (the path the TPU runs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import umeregrobust_tpu.ops.pallas_corr as jpc
import umeregrobust_tpu.pipeline.correlator as jcorr
import umeregrobust_tpu.pipeline.registration as jreg
from _torch_parity import CAPS, SMALL_CFG, WEIGHTS, n, rot_deg, t
from umeregrobust_tpu.ops import densegrid as jdg
from umeregrobust_tpu.pipeline.icp import _icp_loop as jax_icp_loop
from umeregrobust_tpu.pipeline.matching import (
    argmin_match as jax_argmin_match,
    probabilistic_match_filter as jax_filter)
from umeregrobust_tpu.pipeline.ume_gen import ume_from_ball_query as jax_ume
from umeregrobust_tpu_torch.cli.evaluate import PARITY_PROFILE
from umeregrobust_tpu_torch.data.suite import small_pair
from umeregrobust_tpu_torch.models.resunet import ARCHS
from umeregrobust_tpu_torch.models.weights import load_model
from umeregrobust_tpu_torch.ops import densegrid
from umeregrobust_tpu_torch.pipeline import correlator, e2e, registration
from umeregrobust_tpu_torch.pipeline.e2e import (
    pair_features_e2e, register_pair_e2e)
from umeregrobust_tpu_torch.pipeline.icp import icp_loop
from umeregrobust_tpu_torch.pipeline.registration import (
    RegistrationConfig, register_pair_features,
    register_pair_features_batched)


def _rot_z(a, tr):
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = tr
    return T


def _surface_pair(seed, S=700, T=800):
    """A wavy surface, its rigidly moved noisy copy, masks and the ground
    truth (the cloud model of tests/test_torch_icp.py)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, 10, (T, 2))
    z = 0.6 * np.sin(xy[:, 0] * 0.7) + 0.4 * np.cos(xy[:, 1] * 0.9)
    tgt = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    gt = _rot_z(0.3, [0.8, -0.5, 0.05])
    inv = np.linalg.inv(gt)
    src = (tgt[:S] @ inv[:3, :3].T + inv[:3, 3]
           + rng.normal(scale=0.01, size=(S, 3))).astype(np.float32)
    return src, rng.random(S) > 0.05, tgt, rng.random(T) > 0.05, gt


# --- dense_nn_query and the grid feature copy --------------------------


def _nn_case(seed, cell):
    """Clustered points (windows of several points), queries near them,
    far from them (misses) and masked."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, (60, 3)).astype(np.float32)
    pts = (centers[rng.integers(0, 60, 900)]
           + rng.normal(scale=0.4 * cell, size=(900, 3))).astype(np.float32)
    pm = rng.random(900) > 0.1
    q = np.concatenate([
        pts[rng.integers(0, 900, 500)] + rng.normal(scale=0.5 * cell,
                                                     size=(500, 3)),
        rng.uniform(-12, 12, (200, 3))]).astype(np.float32)
    qm = rng.random(700) > 0.15
    return pts, pm, q, qm


@pytest.mark.parametrize("cell,radius,budget", [(0.5, 0.5, 16),
                                                (0.8, 0.6, 24),
                                                (0.4, 0.4, 8)])
def test_dense_nn_query_matches_jax(cell, radius, budget):
    dims = (48, 48, 48)
    pts, pm, q, qm = _nn_case(int(cell * 10), cell)
    g = densegrid.build_dense_grid(t(pts), t(pm), cell, dims)
    assert int(n(densegrid.max_window_count(g))) > 1  # multi-point windows
    dist, idx = densegrid.dense_nn_query(g, t(q), radius, q_mask=t(qm),
                                        budget=budget)
    jg = jdg.build_dense_grid(jnp.asarray(pts), jnp.asarray(pm), cell=cell,
                              dims=dims)
    jd, ji = jdg.dense_nn_query(jg, jnp.asarray(q), radius=radius,
                                q_mask=jnp.asarray(qm), budget=budget)
    np.testing.assert_array_equal(n(idx), np.asarray(ji))
    np.testing.assert_allclose(n(dist), np.asarray(jd), atol=1e-6)
    ji = np.asarray(ji)
    assert (ji >= 0).sum() > 300 and (ji[qm] < 0).sum() > 50
    assert np.all(ji[~qm] == -1)
    # with a leading pair axis each pair queries its own grid
    pts2, pm2, q2, qm2 = _nn_case(int(cell * 10) + 1, cell)
    gb = densegrid.build_dense_grid(t(np.stack([pts, pts2])),
                                    t(np.stack([pm, pm2])), cell, dims)
    db, ib = densegrid.dense_nn_query(gb, t(np.stack([q, q2])), radius,
                                      q_mask=t(np.stack([qm, qm2])),
                                      budget=budget)
    np.testing.assert_array_equal(n(ib[0]), n(idx))
    _, i2 = densegrid.dense_nn_query(densegrid.build_dense_grid(
        t(pts2), t(pm2), cell, dims), t(q2), radius, q_mask=t(qm2),
        budget=budget)
    np.testing.assert_array_equal(n(ib[1]), n(i2))


def test_copy_features_to_raw_grid_matches_jax():
    pts, pm, q, qm = _nn_case(3, 0.6)
    feat = (np.random.default_rng(3).normal(size=(900, 32))
            * pm[:, None]).astype(np.float32)
    kw = dict(radius=0.6, budget=16, dims=(40, 40, 40))
    got = registration.copy_features_to_raw_grid(t(q), t(qm), t(pts),
                                                 t(feat), t(pm), **kw)
    want = jreg.copy_features_to_raw_grid(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(pts),
        jnp.asarray(feat), jnp.asarray(pm), **kw)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert (np.abs(n(got)).sum(1) == 0).sum() > 100  # misses and masks
    got2 = registration.copy_features_to_raw_grid(
        t(np.stack([q, q[::-1].copy()])), t(np.stack([qm, qm[::-1].copy()])),
        t(np.stack([pts, pts])), t(np.stack([feat, feat])),
        t(np.stack([pm, pm])), **kw)
    np.testing.assert_array_equal(n(got2[0]), n(got))
    np.testing.assert_array_equal(n(got2[1]), n(got)[::-1])


def test_feature_stage_takes_the_grid_copy(monkeypatch):
    """register_pair_e2e routes the transfer through the grid copy when
    feat_copy_radius is set (both clouds), and still registers the
    pair."""
    calls = []
    real = e2e.copy_features_to_raw_grid

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    monkeypatch.setattr(e2e, "copy_features_to_raw_grid", spy)
    cfg = RegistrationConfig(**dict(SMALL_CFG, feat_copy_radius=0.9,
                                    feat_copy_dims=(96, 96, 32)))
    pair = small_pair(42)
    s, tg = pair["src"], pair["tgt"]
    model = load_model(WEIGHTS, ARCHS["ResUNetSmall2"], device="cpu")
    Ti, Tr = register_pair_e2e(
        model, CAPS, cfg, s["coords"], s["grid"], s["mask"], tg["coords"],
        tg["grid"], tg["mask"], s["corr_pts"], s["corr_mask"],
        tg["corr_pts"], tg["corr_mask"], compute_dtype=torch.float32,
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert [c["radius"] for c in calls] == [0.9, 0.9]
    assert calls[0]["budget"] == 16 and calls[0]["dims"] == (96, 96, 32)
    assert rot_deg(n(Tr)[:3, :3], pair["gt"][:3, :3]) < 1.0


# --- ICP at icp_inner=1 -----------------------------------------------


def _jax_icp(src, sm, tgt, tm, init, cell, dims, **kw):
    jg = jdg.build_dense_grid(jnp.asarray(tgt), jnp.asarray(tm), cell=cell,
                              dims=dims)
    arrays = (jg.points, jg.points_sorted, jg.order, jg.runs, jg.origin,
              jg.overflow, jg.wstart)
    return jax_icp_loop(jnp.asarray(src), jnp.asarray(sm), arrays,
                        jnp.asarray(init), 0.4, kw["max_iter"],
                        kw["budget"], dims, inner=1, cell=cell,
                        disp_exit=kw["disp_exit"])


@pytest.mark.parametrize("B", [1, 2])
def test_icp_loop_inner1_matches_jax(B):
    cell, dims = 0.4, (64, 64, 16)
    kw = dict(max_iter=25, budget=16, disp_exit=1e-4)
    pairs = [_surface_pair(11 + b) for b in range(B)]
    inits = [gt @ _rot_z(0.02 + 0.02 * b, [0.1, -0.05 * b, 0.0])
             for b, (*_, gt) in enumerate(pairs)]
    if B == 1:
        src, sm, tgt, tm, _ = pairs[0]
        T, rmse, fit, it = icp_loop(
            t(src), t(sm), densegrid.build_dense_grid(t(tgt), t(tm), cell,
                                                      dims),
            t(inits[0]), 0.4, kw["max_iter"], kw["budget"], inner=1,
            disp_exit=kw["disp_exit"])
        T, rmse, fit, it = T[None], rmse[None], fit[None], [it]
    else:
        stack = [np.stack(x) for x in zip(*[p[:4] for p in pairs])]
        T, rmse, fit, it = icp_loop(
            t(stack[0]), t(stack[1]),
            densegrid.build_dense_grid(t(stack[2]), t(stack[3]), cell, dims),
            t(np.stack(inits)), 0.4, kw["max_iter"], kw["budget"], inner=1,
            disp_exit=kw["disp_exit"])
    for b, (src, sm, tgt, tm, _) in enumerate(pairs):
        Tj, rj, fj, itj = _jax_icp(src, sm, tgt, tm, inits[b], cell, dims,
                                   **kw)
        np.testing.assert_allclose(n(T[b]), np.asarray(Tj), atol=1e-5)
        np.testing.assert_allclose(float(rmse[b]), float(rj), rtol=1e-3)
        np.testing.assert_allclose(float(fit[b]), float(fj), rtol=1e-5)
        assert int(it[b]) == int(itj) > 1


# --- the kNN correlator -------------------------------------------------


def _score_case(seed, B=1, S=300, T=350, H=11, lattice=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        if lattice:  # integer coordinates: many exactly tied distances
            tp = rng.integers(-4, 5, (T, 3)).astype(np.float32)
            sp = rng.integers(-4, 5, (S, 3)).astype(np.float32)
        else:
            tp = rng.uniform(-5, 5, (T, 3)).astype(np.float32)
            sp = (tp[:S] + rng.normal(scale=0.3, size=(S, 3))).astype(
                np.float32)
        sf = rng.normal(size=(S, 32)).astype(np.float32)
        tf = rng.normal(size=(T, 32)).astype(np.float32)
        sm, tm = rng.random(S) > 0.1, rng.random(T) > 0.1
        Ts = np.stack([np.eye(4, dtype=np.float32) if lattice and h % 2 == 0
                       else _rot_z(rng.normal(scale=0.1),
                                   rng.normal(scale=0.3, size=3))
                       for h in range(H)])
        out.append((sp, sf * sm[:, None], sm, tp, tf * tm[:, None], tm, Ts))
    return out


@pytest.mark.parametrize("B,lattice", [(1, False), (2, False), (1, True)],
                         ids=["B1", "B2", "ties"])
def test_correlator_scores_knn_matches_jax(B, lattice):
    cases = _score_case(B + 10 * lattice, B=B, lattice=lattice)
    got = n(correlator.correlator_scores(
        *(t(np.stack(x)) for x in zip(*cases)), knn_k=20, sigma=1.5,
        chunk=128))
    assert got.shape == (B, 11)
    for b, case in enumerate(cases):
        want = np.asarray(jcorr.correlator_scores(
            *(jnp.asarray(x) for x in case), knn_k=20, sigma=1.5, chunk=128))
        np.testing.assert_allclose(got[b], want,
                                   atol=1e-5 * np.abs(want).max())
    # the one-pair view is the same call
    one = n(correlator.correlator_scores(*(t(x) for x in cases[0]),
                                         knn_k=20, sigma=1.5, chunk=128))
    np.testing.assert_array_equal(one, got[0])


def test_smallest_k_breaks_ties_toward_the_lower_index():
    rng = np.random.default_rng(0)
    d2 = rng.integers(0, 4, (300, 50)).astype(np.float32)
    vals, idx = correlator.smallest_k(t(d2), 7)
    order = np.argsort(d2, axis=1, kind="stable")[:, :7]
    np.testing.assert_array_equal(n(idx), order)
    np.testing.assert_array_equal(n(vals), np.take_along_axis(d2, order, 1))
    want = jax.lax.top_k(-jnp.asarray(d2), 7)[1]
    np.testing.assert_array_equal(n(idx), np.asarray(want))


def test_select_best_transform_knn_matches_jax():
    """The cascade in kNN mode, subsets injected (the JAX draws of `key`),
    exact per-point variance weights on both sides."""
    (sp, sf, sm, tp, tf, tm, _), = _score_case(4, S=400, T=420)
    rng = np.random.default_rng(5)
    Ts = np.stack([_rot_z(rng.normal(scale=0.2), rng.normal(scale=0.5,
                                                            size=3))
                   for _ in range(40)])
    kw = dict(sigma=1.5, knn_k=20, var_knn=10, coarse_src=128,
              coarse_tgt=200, rescore_top=6, triage_src=96, triage_tgt=128,
              triage_top=16, var_anchors=64)
    key = jax.random.PRNGKey(7)
    key, k_ts, k_tt = jax.random.split(key, 3)
    k_cs, k_ct = jax.random.split(key)
    draws = {"triage_src": jax.random.choice(k_ts, 400, (96,), replace=False),
             "triage_tgt": jax.random.choice(k_tt, 420, (128,),
                                             replace=False),
             "coarse_src": jax.random.choice(k_cs, 400, (128,), replace=False),
             "coarse_tgt": jax.random.choice(k_ct, 420, (200,),
                                             replace=False)}
    best, scores = correlator.select_best_transform(
        *(t(x) for x in (sp, sf, sm, tp, tf, tm, Ts)), mode="knn",
        draws={k: np.asarray(v) for k, v in draws.items()}, **kw)
    jbest, jscores = jcorr.select_best_transform(
        *(jnp.asarray(x) for x in (sp, sf, sm, tp, tf, tm, Ts)), mode="knn",
        key=jax.random.PRNGKey(7), **kw)
    jscores = np.asarray(jscores)
    assert int(np.argmax(n(scores))) == int(np.argmax(jscores))
    np.testing.assert_array_equal(np.isfinite(n(scores)),
                                  np.isfinite(jscores))
    fin = np.isfinite(jscores)
    np.testing.assert_allclose(n(scores)[fin], jscores[fin],
                               atol=1e-5 * np.abs(jscores[fin]).max())
    np.testing.assert_allclose(n(best), np.asarray(jbest), atol=1e-6)


# --- the second round's overlap weights -------------------------------


@pytest.mark.parametrize("B", [1, 2])
def test_overlap_weight_matches_jax(B):
    dims = (14, 14, 8)
    pairs = [_surface_pair(20 + b) for b in range(B)]
    got = registration._overlap_weight(
        *(t(np.stack(x)) for x in zip(*[(p[0] * 1.5, p[1], p[2], p[3])
                                        for p in pairs])), 2.0, dims)
    for b, (src, sm, tgt, tm, _) in enumerate(pairs):
        want = jreg._overlap_weight(jnp.asarray(src * 1.5), jnp.asarray(sm),
                                    jnp.asarray(tgt), jnp.asarray(tm), 2.0,
                                    dims)
        np.testing.assert_array_equal(n(got[b]), np.asarray(want))
        assert 0 < np.asarray(want).sum() < sm.sum()  # some rows fall out


# --- pipeline paths on a small pair -------------------------------------


@pytest.fixture(scope="module")
def features():
    """Two small pairs and the port's fp32 features of each (CPU)."""
    model = load_model(WEIGHTS, ARCHS["ResUNetSmall2"], device="cpu")
    out = []
    for seed in (42, 7):
        pair = small_pair(seed)
        s, tg = pair["src"], pair["tgt"]
        f = pair_features_e2e(model, CAPS, s["coords"], s["grid"], s["mask"],
                              tg["coords"], tg["grid"], tg["mask"],
                              s["corr_pts"], s["corr_mask"], tg["corr_pts"],
                              tg["corr_mask"], compute_dtype=torch.float32,
                              device="cpu")
        sf, tf, csf, ctf = (n(x) for x in f)
        out.append(dict(gt=pair["gt"], arrays=[
            s["grid"], sf, s["mask"], tg["grid"], tf, tg["mask"],
            s["corr_pts"], csf, s["corr_mask"], tg["corr_pts"], ctf,
            tg["corr_mask"]]))
    return out


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX radius scorer through its Pallas kernel in interpret mode;
    kNN scores through correlator_scores, as on any backend."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jpc.pl, "pallas_call", patched)

    def score(mode, *a, knn_k=20, sigma=1.5, chunk=1024):
        if mode == "radius":
            return jcorr.correlator_scores_radius_fused(*a, sigma=sigma)
        return jcorr.correlator_scores(*a, knn_k=knn_k, sigma=sigma,
                                       chunk=chunk)

    monkeypatch.setattr(jcorr, "_score", score)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _choice(key, mask, n_kp):
    p = jnp.asarray(mask).astype(jnp.float32)
    return np.asarray(jax.random.choice(key, p.shape[0], (n_kp,),
                                        replace=False,
                                        p=p / jnp.maximum(jnp.sum(p), 1.0)))


def _round_one_draws(key, arrays, n_kp):
    """The keypoints registration.py:478-486 draws from `key`."""
    k_src, k_tgt, _, _ = jax.random.split(key, 4)
    return {"src_kp": _choice(k_src, arrays[2], n_kp),
            "tgt_kp": _choice(k_tgt, arrays[5], n_kp)}


def _jax_register(kw, key, arrays, run_icp=False):
    return jreg.register_pair_features(
        jreg.RegistrationConfig(**kw), key,
        *(jnp.asarray(a) for a in arrays), run_icp=run_icp)


def test_argmin_path_without_the_ume_filter_matches_jax(features,
                                                        pallas_interpret):
    """filter_by_ume_dist=False on clouds with fewer valid rows than
    ume_n_samples: every slot is a hypothesis, the surplus slots repeat
    the best valid match."""
    arrays = list(features[0]["arrays"])
    for i in (2, 5):  # keep 96 valid SEM rows a side
        m = arrays[i].copy()
        m[np.flatnonzero(m)[96:]] = False
        arrays[i] = m
        arrays[i - 1] = arrays[i - 1] * m[:, None]
    kw = dict(SMALL_CFG, filter_by_ume_dist=False, ume_n_samples=128,
              consensus_cands=4)
    key = jax.random.PRNGKey(11)
    want = _jax_register(kw, key, arrays)
    got = register_pair_features(RegistrationConfig(**kw),
                                 *(t(a) for a in arrays),
                                 draws=_round_one_draws(key, arrays, 128))
    np.testing.assert_allclose(n(got.T_init), np.asarray(want.T_init),
                               atol=1e-4)


def _second_round_draws(kw, key, arrays):
    """The JAX draws of the whole path with a second round: the round-one
    keypoints, then (from the round-one winner T0 of the same key) the
    second round's keypoints inside the T0-predicted overlap
    (registration.py:613-634)."""
    draws = _round_one_draws(key, arrays, kw["num_init_keypoints"])
    T0 = np.asarray(_jax_register(dict(kw, sr_kpts=0), key, arrays).T_init)
    sp, _, sm, tp, _, tm = (jnp.asarray(a) for a in arrays[:6])
    R0, t0 = T0[:3, :3], T0[:3, 3]
    box = tuple(d * kw.get("icp_max_corr", 0.2) for d in
                kw.get("icp_dims", (384, 384, 96)))
    r_ov = kw.get("sr_overlap_radius", 2.0)
    dims = tuple(int(np.ceil(b / r_ov - 1e-6)) + 2 for b in box)
    w_src = jreg._overlap_weight(sp @ R0.T + t0, sm, tp, tm, r_ov, dims)
    w_tgt = jreg._overlap_weight((tp - t0) @ R0, tm, sp, sm, r_ov, dims)
    w_src = jnp.where(jnp.sum(w_src) >= 64, w_src, sm)
    w_tgt = jnp.where(jnp.sum(w_tgt) >= 64, w_tgt, tm)
    k_s, k_t, _ = jax.random.split(jax.random.fold_in(key, 1729), 3)
    draws["sr_src_kp"] = _choice(k_s, w_src, kw["sr_kpts"])
    draws["sr_tgt_kp"] = _choice(k_t, w_tgt, kw["sr_kpts"])
    return draws


SR_CFG = dict(SMALL_CFG, filter_mode="topk", consensus_cands=4, sr_kpts=128,
              sr_hyps=48, sr_cands=4)


def test_second_round_matches_jax(features, pallas_interpret):
    kw = dict(SR_CFG, sr_gate_inliers=2.0)  # the gate always fires
    arrays = features[0]["arrays"]
    key = jax.random.PRNGKey(5)
    want = _jax_register(kw, key, arrays)
    got = register_pair_features(RegistrationConfig(**kw),
                                 *(t(a) for a in arrays),
                                 draws=_second_round_draws(kw, key, arrays))
    np.testing.assert_allclose(n(got.T_init), np.asarray(want.T_init),
                               atol=1e-4)


def test_second_round_gate_is_per_pair_in_a_batch(features, monkeypatch):
    """Two pairs, only one of whose second-round gates fires: in one batch
    each pair gets its one-pair result with the same generator (its
    second-round uniforms are drawn whether or not a gate fires)."""
    ratios = []
    real = registration._inlier_ratio

    def spy(*a):
        r = real(*a)
        ratios.append(n(r).copy())
        return r

    monkeypatch.setattr(registration, "_inlier_ratio", spy)

    def gen(i):
        return torch.Generator().manual_seed(100 + i)

    def one(i, cfg):
        return register_pair_features(
            cfg, *(t(a) for a in features[i]["arrays"]), generator=gen(i))

    probe = RegistrationConfig(**dict(SR_CFG, sr_gate_inliers=2.0))
    inl = []
    for i in range(2):
        one(i, probe)
        inl.append(float(ratios[-1][0]))
    assert abs(inl[0] - inl[1]) > 1e-3, inl
    cfg = RegistrationConfig(**dict(SR_CFG,
                                    sr_gate_inliers=float(np.mean(inl))))
    alone = [one(i, cfg) for i in range(2)]
    ratios.clear()
    batched = register_pair_features_batched(
        cfg, *(t(np.stack(x)) for x in zip(features[0]["arrays"],
                                           features[1]["arrays"])),
        generators=[gen(0), gen(1)])
    fired = ratios[-1] < cfg.sr_gate_inliers
    assert fired.sum() == 1  # one gate fires, the other does not
    for i in range(2):
        np.testing.assert_allclose(n(batched.T_init[i]),
                                   n(alone[i].T_init), atol=1e-5)
        np.testing.assert_allclose(n(batched.T_refined[i]),
                                   n(alone[i].T_refined), atol=1e-5)


def test_parity_profile_matches_jax(features):
    """The CLI's reference-parity profile (kNN scores, no cascade, no
    consensus, per-point weights, the probabilistic filter, single-stage
    ICP at icp_inner=1) on one small pair, every JAX draw injected."""
    kw = dict(SMALL_CFG, **PARITY_PROFILE)
    arrays = features[0]["arrays"]
    key = jax.random.PRNGKey(9)
    draws = _round_one_draws(key, arrays, kw["num_init_keypoints"])
    # the filter's draw needs the JAX match distances (matching.py:80-94)
    cfg = jreg.RegistrationConfig(**kw)
    ume = [jax_ume(jnp.asarray(arrays[i]), jnp.asarray(arrays[i + 1]),
                   jnp.asarray(arrays[i])[draws[kp]], radius=cfg.ume_r_nn,
                   max_nn=cfg.ume_max_nn, p_mask=jnp.asarray(arrays[i + 2]),
                   k_mask=jnp.asarray(arrays[i + 2])[draws[kp]])
           for i, kp in ((0, "src_kp"), (3, "tgt_kp"))]
    _, d = jax_argmin_match(ume[0], ume[1],
                            src_mask=jnp.asarray(arrays[2])[draws["src_kp"]],
                            tgt_mask=jnp.asarray(arrays[5])[draws["tgt_kp"]])
    draws["filter"] = np.asarray(jax_filter(jax.random.split(key, 4)[2], d,
                                            cfg.ume_n_samples, cfg.tau))
    want = _jax_register(kw, key, arrays, run_icp=True)
    got = register_pair_features(RegistrationConfig(**kw),
                                 *(t(a) for a in arrays), draws=draws)
    Ti, Tr = (np.asarray(n(x), np.float64) for x in (got.T_init,
                                                     got.T_refined))
    jTi, jTr = (np.asarray(x, np.float64) for x in (want.T_init,
                                                    want.T_refined))
    np.testing.assert_allclose(Ti, jTi, atol=1e-4)
    np.testing.assert_allclose(Tr, jTr, atol=1e-3)
    assert rot_deg(Tr[:3, :3], features[0]["gt"][:3, :3]) < 1.0
