"""Dense grid, ICP and the consensus stage of the port against the JAX
package: grid tables and window candidates identical; ICP, the refine
schedule and the candidate polish from the same start within 1e-3 deg /
1e-4 m; consensus_refit and compact_structure identical."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import n, rot_deg, t
from umeregrobust_tpu.ops import densegrid as jdg
from umeregrobust_tpu.pipeline import consensus as jcons
from umeregrobust_tpu.pipeline.icp import _icp_loop as jax_icp_loop
from umeregrobust_tpu.pipeline.registration import (
    RegistrationConfig as JaxConfig, refine_with_icp as jax_refine)
from umeregrobust_tpu_torch.ops import densegrid
from umeregrobust_tpu_torch.pipeline import consensus
from umeregrobust_tpu_torch.pipeline.icp import icp_loop
from umeregrobust_tpu_torch.pipeline.registration import (
    RegistrationConfig, refine_with_icp)


def _rot_z(a, tr):
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = tr
    return T


def _cloud_pair(seed, S=1024, T=1200):
    """A structured surface cloud and its rigidly moved, noisy copy."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-12, 12, (T, 2))
    z = 0.6 * np.sin(xy[:, 0] * 0.7) + 0.4 * np.cos(xy[:, 1] * 0.9)
    tgt = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    gt = _rot_z(0.3, [0.8, -0.5, 0.05])
    inv = np.linalg.inv(gt)
    src = (tgt[:S] @ inv[:3, :3].T + inv[:3, 3]
           + rng.normal(scale=0.01, size=(S, 3))).astype(np.float32)
    sm = rng.random(S) > 0.05
    tm = rng.random(T) > 0.05
    return src, sm, tgt, tm, gt


def _jgrid(pts, mask, cell, dims):
    return jdg.build_dense_grid(jnp.asarray(pts), jnp.asarray(mask),
                                cell=cell, dims=dims)


@pytest.mark.parametrize("cell,dims", [(0.5, (64, 64, 16)),
                                       (1.0, (20, 20, 8))])
def test_dense_grid_tables_and_candidates_identical(cell, dims):
    src, _, tgt, tm, _ = _cloud_pair(0)
    g = densegrid.build_dense_grid(t(tgt), t(tm), cell=cell, dims=dims)
    jg = _jgrid(tgt, tm, cell, dims)
    for name in ("points_sorted", "order", "runs", "origin", "overflow",
                 "wstart"):
        np.testing.assert_array_equal(n(getattr(g, name)),
                                      np.asarray(getattr(jg, name)), name)
    assert int(n(densegrid.max_window_count(g))) == int(
        jdg.max_window_count(jg))
    q = src + np.float32(0.1)
    np.testing.assert_array_equal(
        n(densegrid.dense_candidates(g, t(q), budget=8)),
        np.asarray(jdg.dense_candidates(jg, jnp.asarray(q), budget=8)))


def _close(T, Tj, deg=1e-3, m=1e-4):
    T, Tj = np.asarray(T, np.float64), np.asarray(Tj, np.float64)
    assert rot_deg(T[:3, :3], Tj[:3, :3]) < deg
    assert np.abs(T[:3, 3] - Tj[:3, 3]).max() < m


def test_icp_loop_matches_jax():
    src, sm, tgt, tm, gt = _cloud_pair(1)
    init = gt @ _rot_z(0.02, [0.1, -0.05, 0.0])
    cell, dims = 0.4, (72, 72, 16)
    T, rmse, fit, it = icp_loop(t(src), t(sm), densegrid.build_dense_grid(
        t(tgt), t(tm), cell, dims), t(init), 0.4, 30, 16, inner=6,
        disp_exit=1e-4)
    jg = _jgrid(tgt, tm, cell, dims)
    arrays = (jg.points, jg.points_sorted, jg.order, jg.runs, jg.origin,
              jg.overflow, jg.wstart)
    Tj, rj, fj, itj = jax_icp_loop(jnp.asarray(src), jnp.asarray(sm), arrays,
                                   jnp.asarray(init), 0.4, 30, 16, dims,
                                   inner=6, cell=cell, disp_exit=1e-4)
    _close(n(T), Tj)
    assert it == int(itj)
    np.testing.assert_allclose(float(rmse), float(rj), rtol=1e-3)
    np.testing.assert_allclose(float(fit), float(fj), rtol=1e-5)


def test_refine_with_icp_all_stages_match_jax():
    src, sm, tgt, tm, gt = _cloud_pair(2)
    init = gt @ _rot_z(0.03, [0.15, 0.1, 0.0])
    kw = dict(icp_max_corr=0.4, icp_max_iter=30, icp_coarse_corr=1.0,
              icp_coarse_iter=12, icp_multires=512, icp_multires_iter=12,
              icp_exact_rows=800, icp_dims=(72, 72, 16), icp_budget=16,
              icp_raw_iter=6, icp_raw_budget=24)
    raw = (src[::-1].copy(), sm[::-1].copy(), tgt[::-1].copy(),
           tm[::-1].copy())
    T, _, _, iters = refine_with_icp(
        RegistrationConfig(**kw), t(init), t(src), t(sm), t(tgt), t(tm),
        *(t(a) for a in raw), return_iters=True)
    Tj, _, _, itj = jax_refine(
        JaxConfig(**kw), jnp.asarray(init), jnp.asarray(src), jnp.asarray(sm),
        jnp.asarray(tgt), jnp.asarray(tm), *(jnp.asarray(a) for a in raw),
        return_iters=True)
    assert len(iters) == 4  # coarse, multires, exact, raw
    assert iters == [int(i) for i in np.asarray(itj)]
    _close(n(T), Tj)


def test_polish_candidates_matches_jax():
    src, sm, tgt, tm, gt = _cloud_pair(3)
    cand = np.stack([gt @ _rot_z(a, [dx, -dx, 0.0]) for a, dx in
                     [(0.0, 0.0), (0.05, 0.3), (-0.08, 0.5), (0.02, -0.6),
                      (1.5, 3.0)]]).astype(np.float32)
    kw = dict(radii=(1.0, 0.45), inner=4)
    got = n(consensus.polish_candidates(t(cand), t(src[:256]), t(sm[:256]),
                                        t(tgt), t(tm), **kw))
    want = np.asarray(jcons.polish_candidates(
        jnp.asarray(cand), jnp.asarray(src[:256]), jnp.asarray(sm[:256]),
        jnp.asarray(tgt), jnp.asarray(tm), **kw))
    for a, b in zip(got, want):
        _close(a, b)


def test_consensus_refit_and_compact_structure_identical():
    # three SE(3) modes, each supported by many matches (a mode with one
    # or two voters has a rank-deficient refit covariance: an ill-posed
    # rotation in either implementation)
    rng = np.random.default_rng(4)
    modes = [_rot_z(0.7, [3.0, -1.0, 0.2]), _rot_z(-1.2, [-4.0, 2.0, 0.0]),
             _rot_z(2.5, [0.5, 6.0, -0.1])]
    sizes = [120, 100, 80]
    s_kp = rng.uniform(-20, 20, (sum(sizes), 3)).astype(np.float32)
    t_kp, Ts = [], []
    for T, k, s in zip(modes, sizes, np.split(s_kp, np.cumsum(sizes)[:-1])):
        t_kp.append(s @ T[:3, :3].T + T[:3, 3]
                    + rng.normal(scale=0.2, size=s.shape))
        Ts += [T @ _rot_z(a, [dx, dy, 0.0]) for a, dx, dy in zip(
            rng.normal(scale=0.03, size=k), rng.normal(scale=0.4, size=k),
            rng.normal(scale=0.4, size=k))]
    t_kp = np.concatenate(t_kp).astype(np.float32)
    Ts = np.stack(Ts).astype(np.float32)
    ok = rng.random(len(Ts)) > 0.1
    got = n(consensus.consensus_refit(t(Ts), t(s_kp), t(t_kp), t(ok),
                                      n_cand=3))
    want = np.asarray(jcons.consensus_refit(
        jnp.asarray(Ts), jnp.asarray(s_kp), jnp.asarray(t_kp),
        jnp.asarray(ok), n_cand=3))
    # the same modes in the same order; the IRLS sums over 300 matches run
    # in another fp32 order, so the refit agrees to the ICP tolerance
    for a, b in zip(got, want):
        _close(a, b)
    for a, T in zip(got, modes):  # each refit lands on its mode
        _close(a, T, deg=0.5, m=0.2)

    src, sm, _, _, _ = _cloud_pair(5)
    feat = rng.normal(size=(len(src), 32)).astype(np.float32)
    got = consensus.compact_structure(t(src), t(feat), t(sm), 300)
    want = jcons.compact_structure(jnp.asarray(src), jnp.asarray(feat),
                                   jnp.asarray(sm), 300, cell=2.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), np.asarray(b))
