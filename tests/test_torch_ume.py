"""Kernel ume_moments_fused (plain version on CPU tensors) against the JAX
Pallas kernel in interpret mode and against ume_from_ball_query's XLA
path: moments to rtol 1e-5, neighbour counts identical, the cap binding
across tile boundaries with masked rows. Test clouds keep every point
>= 1e-4 away from the radius so the two distance formulas (direct
differences here, |a|^2+|b|^2-2ab in the XLA path) cannot disagree. Edge
cases (one keypoint, caps of 1 / 32 / 33 / above N, all points masked,
nothing in radius, no keypoint) run at small sizes; where the data are
integers or nothing is selected the comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from umeregrobust_tpu_torch.ops import _build, cuda_ume
from umeregrobust_tpu.ops.pallas_ume import ume_moments_fused as jax_fused
from umeregrobust_tpu.pipeline.ume_gen import ume_from_ball_query as jax_ume
from umeregrobust_tpu_torch.ops.cuda_ume import ume_moments_fused
from umeregrobust_tpu_torch.pipeline.ume_gen import ume_from_ball_query


def _clouds(seed, n_pts, m, radius):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n_pts, 3)) * 5).astype(np.float32)
    kpts = pts[rng.choice(n_pts, m, replace=False)] + np.float32(0.1)
    d = np.sqrt(((kpts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1))
    far = (np.abs(d - radius) >= 1e-4).all(0)
    return rng, pts[far], kpts


@pytest.mark.parametrize("seed,n_pts,m,max_nn", [(0, 1024, 64, 50),
                                                 (1, 1536, 300, 7),
                                                 (2, 2300, 40, 1000),
                                                 (3, 700, 1, 50),  # M = 1
                                                 (4, 900, 24, 1),
                                                 (5, 900, 24, 32),
                                                 (6, 900, 24, 33),
                                                 (7, 600, 24, 5000)])  # > N
def test_moments_and_counts_match_pallas(seed, n_pts, m, max_nn):
    rng, pts, kpts = _clouds(seed, n_pts, m, 3.0)
    N = len(pts)
    Z = rng.normal(size=(N, 128)).astype(np.float32)
    Z[:, 5] = 1.0  # counts contributors
    mask = rng.random(N) < 0.85
    Zm = Z * mask[:, None]
    got = n(ume_moments_fused(t(kpts), t(pts), t(Zm), t(mask), 3.0, max_nn))
    want = np.asarray(jax_fused(jnp.asarray(kpts), jnp.asarray(pts),
                                jnp.asarray(Zm), jnp.asarray(mask),
                                radius=3.0, max_nn=max_nn, interpret=True))
    np.testing.assert_array_equal(got[:, 5], want[:, 5])  # counts
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert got[:, 5].max() <= max_nn


def test_cap_binds_exactly_across_tiles_with_masked_rows():
    n_pts, m = 4500, 8  # spans several 2048-point kernel tiles
    pts = np.zeros((n_pts, 3), np.float32)
    kpts = np.zeros((m, 3), np.float32)
    Z = np.zeros((n_pts, 128), np.float32)
    Z[:, 0] = np.arange(n_pts)
    Z[:, 1] = 1.0
    mask = np.ones(n_pts, bool)
    mask[10:20] = False
    mask[2040:2060] = False
    Zm = Z * mask[:, None]
    got = n(ume_moments_fused(t(kpts), t(pts), t(Zm), t(mask), 1.0, 2100))
    valid_idx = np.flatnonzero(mask)[:2100]
    np.testing.assert_array_equal(got[:, 1], 2100)
    np.testing.assert_array_equal(got[:, 0], valid_idx.sum())
    want = np.asarray(jax_fused(jnp.asarray(kpts), jnp.asarray(pts),
                                jnp.asarray(Zm), jnp.asarray(mask),
                                radius=1.0, max_nn=2100, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_nn", [1, 32, 33, 129, 5000])
def test_cap_picks_first_valid_indices_with_masked_runs(max_nn):
    n_pts, m = 2300, 3  # every point in radius; masked runs across steps
    pts = np.zeros((n_pts, 3), np.float32)
    kpts = np.zeros((m, 3), np.float32)
    Z = np.zeros((n_pts, 128), np.float32)
    Z[:, 0] = np.arange(n_pts)
    Z[:, 1] = 1.0
    mask = np.ones(n_pts, bool)
    for a, b in [(0, 3), (25, 40), (60, 70), (2040, 2060)]:
        mask[a:b] = False
    got = n(ume_moments_fused(t(kpts), t(pts), t(Z), t(mask), 1.0, max_nn))
    first = np.flatnonzero(mask)[:max_nn]
    np.testing.assert_array_equal(got[:, 1], len(first))
    np.testing.assert_array_equal(got[:, 0], first.sum())
    np.testing.assert_array_equal(got[:, 2:], 0)
    want = np.asarray(jax_fused(jnp.asarray(kpts), jnp.asarray(pts),
                                jnp.asarray(Z), jnp.asarray(mask),
                                radius=1.0, max_nn=max_nn, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["all_masked", "nothing_in_radius"])
def test_nothing_selected_gives_exact_zeros(case):
    rng, pts, kpts = _clouds(8, 700, 20, 3.0)
    N = len(pts)
    Z = rng.normal(size=(N, 128)).astype(np.float32)
    mask = np.zeros(N, bool) if case == "all_masked" else rng.random(N) < 0.85
    if case == "nothing_in_radius":
        kpts = kpts + np.float32(1e3)
    got = n(ume_moments_fused(t(kpts), t(pts), t(Z), t(mask), 3.0, 50))
    want = np.asarray(jax_fused(jnp.asarray(kpts), jnp.asarray(pts),
                                jnp.asarray(Z), jnp.asarray(mask),
                                radius=3.0, max_nn=50, interpret=True))
    np.testing.assert_array_equal(got, np.zeros((len(kpts), 128), np.float32))
    np.testing.assert_array_equal(got, want)


def test_no_keypoint_gives_an_empty_result():
    rng, pts, _ = _clouds(9, 300, 4, 3.0)
    Z = rng.normal(size=(len(pts), 128)).astype(np.float32)
    got = ume_moments_fused(torch.zeros((0, 3)), t(pts), t(Z),
                            t(np.ones(len(pts), bool)), 3.0, 50)
    assert tuple(got.shape) == (0, 128) and got.dtype == torch.float32


def test_cpu_tensors_never_reach_the_kernel_library(monkeypatch):
    def boom():
        raise AssertionError("the CPU branch asked for the CUDA library")

    monkeypatch.setattr(_build, "load_library", boom)
    before = cuda_ume.LAUNCHES
    rng, pts, kpts = _clouds(10, 500, 16, 3.0)
    Z = rng.normal(size=(len(pts), 128)).astype(np.float32)
    mask = rng.random(len(pts)) < 0.85
    got = n(ume_moments_fused(t(kpts), t(pts), t(Z), t(mask), 3.0, 20))
    d2 = ((kpts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    ok = (d2 <= 9.0) & mask[None]
    w = ok & (np.cumsum(ok, 1) <= 20)
    np.testing.assert_allclose(got, w.astype(np.float64) @ Z, rtol=1e-5,
                               atol=1e-4)
    assert cuda_ume.LAUNCHES == before  # counts kernel launches only


def test_ume_from_ball_query_matches_jax_xla_path():
    rng, pts, kpts = _clouds(3, 2048, 96, 5.0)
    pts = pts[:1536]
    N = len(pts)
    feats = rng.normal(size=(N, 32)).astype(np.float32)
    p_mask = rng.random(N) < 0.9
    feats = feats * p_mask[:, None]
    k_mask = rng.random(len(kpts)) < 0.95
    got = n(ume_from_ball_query(t(pts), t(feats), t(kpts), 5.0, 40,
                                p_mask=t(p_mask), k_mask=t(k_mask)))
    want = np.asarray(jax_ume(jnp.asarray(pts), jnp.asarray(feats),
                              jnp.asarray(kpts), radius=5.0, max_nn=40,
                              p_mask=jnp.asarray(p_mask),
                              k_mask=jnp.asarray(k_mask)))
    assert got.shape == want.shape == (len(kpts), 32, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
