"""The port's ball_query, keypoint samplers and RT-UME layer against the
JAX package's: ball_query indices exactly equal (masks, a chunk that does
not divide M); both samplers' keypoints and masks equal; rtume_estimate
in its diagonal, random-triplet (JAX's jax.random.randint draws injected)
and full-grid modes within 1e-4 x max |value| (fp32) for T, D, G and H;
the diagonal mode recovers the transform of exact-correspondence clouds,
as tests/test_rtume_samplers.py checks for the JAX layer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (single-threaded torch)
from _torch_parity import n, rot_deg, t
from umeregrobust_tpu.ops.neighbors import ball_query as jball
from umeregrobust_tpu.pipeline.keypoint_samplers import (
    sample_grid_keypoints as jgrid, sample_smart_keypoints as jsmart)
from umeregrobust_tpu.pipeline.rtume import rtume_estimate as jrtume
from umeregrobust_tpu_torch.data.synthetic import SceneConfig, make_pair
from umeregrobust_tpu_torch.ops.neighbors import ball_query
from umeregrobust_tpu_torch.pipeline.keypoint_samplers import (
    sample_grid_keypoints, sample_smart_keypoints)
from umeregrobust_tpu_torch.pipeline.rtume import rtume_estimate


def _scene(n_pts=3000, seed=0):
    pair = make_pair(SceneConfig(extent=12.0, ground_points=1500,
                                 structure_points=3000, n_boxes=8, n_walls=3,
                                 n_poles=4, dropout=0.1),
                     max_rotation_deg=40, max_translation=3.0, seed=21)
    si = np.random.default_rng(seed).choice(len(pair["src_pts"]), n_pts,
                                            replace=False)
    return pair, si


@pytest.mark.parametrize("masks", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("M,K,chunk", [(300, 16, 128), (77, 1, 32),
                                       (129, 64, 256)])
def test_ball_query_equals_jax(M, K, chunk, masks):
    rng = np.random.default_rng(M + K)
    pts = rng.uniform(-4, 4, (900, 3)).astype(np.float32)
    q = rng.uniform(-4, 4, (M, 3)).astype(np.float32)
    qm = rng.random(M) > 0.3 if masks else None
    pm = rng.random(900) > 0.4 if masks else None
    got = ball_query(t(q), t(pts), 0.9, K, None if qm is None else t(qm),
                     None if pm is None else t(pm), chunk=chunk)
    want = jball(jnp.asarray(q), jnp.asarray(pts), 0.9, K,
                 None if qm is None else jnp.asarray(qm),
                 None if pm is None else jnp.asarray(pm), chunk=chunk)
    assert got.dtype == torch.int64 and got.shape == (M, K)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    hits = n(got) >= 0
    assert hits.any() and not hits.all()
    if qm is not None:
        assert not hits[~qm].any()


def _sampler_inputs(masked):
    pair, si = _scene()
    pts = pair["src_pts"][si].astype(np.float32)
    seg = pair["src_seg"][si].astype(np.int32)
    mask = np.ones(len(si), bool)
    if masked:
        mask[np.random.default_rng(1).random(len(si)) < 0.2] = False
    return pts, seg, mask


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("kw", [
    dict(num_samples=64, nn_r=3.0, max_nn=128, min_nn=10),
    dict(num_samples=400, nn_r=1.0, max_nn=64, min_nn=20)],
    ids=["spaced", "budget_exceeds_cells"])
def test_smart_keypoints_equal_jax(kw, masked):
    pts, seg, mask = _sampler_inputs(masked)
    got = sample_smart_keypoints(pts, seg, mask, device="cpu", **kw)
    want = jsmart(jnp.asarray(pts), jnp.asarray(seg), jnp.asarray(mask), **kw)
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
    km = n(got[1])
    assert 0 < km.sum() < len(km) or kw["num_samples"] == 64
    assert not n(got[0])[~km].any()  # masked rows are zero
    cells = np.floor(n(got[0])[km] / kw["nn_r"]).astype(int)
    assert len(np.unique(cells, axis=0)) == len(cells)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_grid_keypoints_equal_jax(masked):
    pts, seg, mask = _sampler_inputs(masked)
    kw = dict(num_samples=64, nn_r=3.0, max_nn=128, min_nn=10,
              grid_extent=14.0)
    got = sample_grid_keypoints(pts, seg, mask, device="cpu", **kw)
    want = jgrid(jnp.asarray(pts), jnp.asarray(seg), jnp.asarray(mask), **kw)
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
    assert n(got[1]).sum() > 0
    assert not n(got[0])[~n(got[1])].any()


def _close(got, want, what):
    got, want = n(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * scale, (what, err, scale)


def _rtume_inputs(C, masked):
    """Clouds dense enough that every keypoint's ball holds 20+ points: a
    ball of a few points leaves the rotation ill-posed, and then any two
    fp32 solvers may pick different ones."""
    rng = np.random.default_rng(C)
    src = (rng.normal(size=(600, 3)) * 2).astype(np.float32)
    tgt = (src @ np.array([[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]]).T
           + [1.0, -0.5, 0.2] + rng.normal(0, 0.02, src.shape)
           ).astype(np.float32)
    sf = rng.uniform(0.1, 1, (600, C)).astype(np.float32)
    tf = (sf + rng.normal(0, 0.01, sf.shape)).astype(np.float32)
    sm = rng.random(600) > 0.1 if masked else None
    tm = rng.random(600) > 0.1 if masked else None
    if masked:
        sf, tf = sf * sm[:, None], tf * tm[:, None]
    return src, sf, src[:9], tgt, tf, tgt[:9], sm, tm


@pytest.mark.parametrize("C,masked", [(8, False), (32, True)],
                         ids=["C8", "C32_masked"])
@pytest.mark.parametrize("mode", ["diag", "n_rand", "grid"])
def test_rtume_equals_jax(mode, C, masked):
    src, sf, skp, tgt, tf, tkp, sm, tm = _rtume_inputs(C, masked)
    kw = dict(ume_knn=64, ume_desc_rad=3.0, diag_only=mode != "grid")
    jkw = dict(kw, src_mask=None if sm is None else jnp.asarray(sm),
               tgt_mask=None if tm is None else jnp.asarray(tm))
    draws = None
    if mode == "n_rand":
        key = jax.random.PRNGKey(C)
        jkw.update(n_rand=12, key=key)
        draws = np.asarray(jax.random.randint(key, (12, 3), 0, 9))
        kw.update(n_rand=12, draws=draws)
    got = rtume_estimate(src, sf, skp, tgt, tf, tkp, src_mask=sm,
                         tgt_mask=tm, device="cpu", **kw)
    want = jrtume(*(jnp.asarray(a) for a in (src, sf, skp, tgt, tf, tkp)),
                  **jkw)
    for name, g, w in zip("TDGH", got, want):
        _close(g, w, name)
    lead = {"diag": (9,), "n_rand": (12,), "grid": (9, 9)}[mode]
    assert got[0].shape == lead + (4, 4) and got[1].shape == lead


def test_rtume_draws_from_a_generator():
    src, sf, skp, tgt, tf, tkp, _, _ = _rtume_inputs(8, False)

    def run(seed):
        return rtume_estimate(src, sf, skp, tgt, tf, tkp, ume_knn=64,
                              ume_desc_rad=3.0, n_rand=5, device="cpu",
                              generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert a[0].shape == (5, 4, 4)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])


def test_rtume_diag_recovers_the_transform():
    pair, si = _scene()
    src = pair["src_pts"][si].astype(np.float32)
    T_gt = pair["gt_tform"].astype(np.float32)
    tgt = (src @ T_gt[:3, :3].T + T_gt[:3, 3]).astype(np.float32)
    z = src[:, 2:3]
    feat = np.concatenate([np.ones_like(z), z, z * z, np.sin(z), np.cos(z),
                           np.exp(-np.abs(z)), np.minimum(z, 1.0), z ** 3],
                          axis=1).astype(np.float32)
    kp = np.random.default_rng(0).choice(len(si), 16, replace=False)
    T, D, _, _ = rtume_estimate(src, feat, src[kp], tgt, feat, tgt[kp],
                                ume_knn=256, ume_desc_rad=4.0, device="cpu")
    rre = [rot_deg(n(T)[i, :3, :3], T_gt[:3, :3]) for i in range(16)]
    assert np.median(rre) < 1.0, rre
    assert np.median(n(D)) < 0.05


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    src, sf, skp, tgt, tf, tkp, _, _ = _rtume_inputs(8, False)
    seg = np.zeros(600, np.int32)
    mask = np.ones(600, bool)
    for call in (lambda: rtume_estimate(src, sf, skp, tgt, tf, tkp),
                 lambda: sample_smart_keypoints(src, seg, mask),
                 lambda: sample_grid_keypoints(src, seg, mask)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
