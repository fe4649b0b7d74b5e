"""The port's host modules against the JAX package's on the same seeded
numpy inputs: its own g++-built copy of the native host ops (quantize,
radius and unbounded 1-NN, Hungarian, with tied costs too) and the data
functions routed through them (ground-truth matches, SEM label copy,
dataset quantization, hungarian_match); the precision policy
(hp_matmul, hp_transform_pts at +-50 m); wall-clock profiling and the
kernel build cache."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from umeregrobust_tpu import native as jax_native
from umeregrobust_tpu.data import matching_host as jax_matching
from umeregrobust_tpu.data import sem as jax_sem
from umeregrobust_tpu.ops import precision as jax_precision
from umeregrobust_tpu.pipeline.matching import (
    hungarian_match as jax_hungarian)
from umeregrobust_tpu.utils import profiling as jax_profiling
from umeregrobust_tpu_torch import native
from umeregrobust_tpu_torch.data import matching_host, sem
from umeregrobust_tpu_torch.data.synthetic import SceneConfig, make_pair
from umeregrobust_tpu_torch.ops import _build, precision
from umeregrobust_tpu_torch.ops.voxel import quantize_np
from umeregrobust_tpu_torch.pipeline.matching import hungarian_match
from umeregrobust_tpu_torch.utils import cache, profiling


def test_both_packages_have_their_native_library():
    # here both build with g++; the port's library lives under build/host
    assert native.have_native() and jax_native.have_native()
    so = native._library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.parent.parent.name == "build"


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("voxel", [0.3, 0.05])
def test_quantize_equals_jax_native(voxel):
    pts = np.random.default_rng(0).uniform(-30, 30, (5000, 3)).astype(
        np.float32)
    got = native.quantize(pts, voxel)
    _same(got, jax_native.quantize(pts, voxel))
    _same(got, quantize_np(pts, voxel))  # first-occurrence order, as numpy


@pytest.mark.parametrize("radius", [0.7, 0.2])
def test_nn_radius_and_nn_1_equal_jax_native(radius):
    rng = np.random.default_rng(1)
    q = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    p = rng.uniform(-10, 10, (2000, 3)).astype(np.float32)
    _same(native.nn_radius(q, p, radius), jax_native.nn_radius(q, p, radius))
    _same(native.nn_1(q * 2, p), jax_native.nn_1(q * 2, p))


@pytest.mark.parametrize("shape", [(8, 8), (6, 10), (10, 6), (60, 60)])
@pytest.mark.parametrize("ties", [False, True])
def test_hungarian_equals_jax_native(shape, ties):
    rng = np.random.default_rng(sum(shape))
    cost = (rng.integers(0, 3, shape).astype(np.float64) if ties
            else rng.uniform(0, 10, shape))
    got = native.hungarian(cost)
    _same(got, jax_native.hungarian(cost))
    # hungarian_match routes through it: the same pairs, tied or not
    np.testing.assert_array_equal(hungarian_match(cost), jax_hungarian(cost))


def test_fallbacks_are_numpy_and_scipy(monkeypatch):
    from scipy.optimize import linear_sum_assignment

    monkeypatch.setattr(native, "_load", lambda: None)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-5, 5, (800, 3)).astype(np.float32)
    _same(native.quantize(pts, 0.3), quantize_np(pts, 0.3))
    idx, dist = native.nn_radius(pts[:50] + 0.01, pts, 0.5)
    np.testing.assert_array_equal(idx, np.arange(50))
    cost = rng.uniform(0, 1, (7, 9))
    r, c = native.hungarian(cost)
    np.testing.assert_array_equal(np.stack([r, c]),
                                  np.stack(linear_sum_assignment(cost)))


@pytest.mark.parametrize("fn", ["one_side_matches", "mutual_matches"])
def test_matches_route_through_native_as_in_jax(fn):
    # tests/test_torch_data.py's inputs; now bit for bit, ties included
    rng = np.random.default_rng(0)
    src = rng.uniform(-6, 6, (3000, 3)).astype(np.float32)
    a = np.radians(rng.uniform(-40, 40))
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                 [0, 0, 1]]
    T[:3, 3] = rng.uniform(-2, 2, 3)
    tgt = (src @ T[:3, :3].T + T[:3, 3]
           + rng.normal(0, 0.08, src.shape)).astype(np.float32)
    tgt = tgt[rng.permutation(len(tgt))[:2500]]
    got = getattr(matching_host, fn)(src, tgt, T, 0.15)
    np.testing.assert_array_equal(got, getattr(jax_matching, fn)(
        src, tgt, T, 0.15))
    _same(matching_host.nn_radius(src, tgt, 0.15),
          jax_native.nn_radius(src, tgt, 0.15))


@pytest.mark.parametrize("mode", ["voxel", "oracle"])
def test_sem_label_copy_routes_through_native_as_in_jax(mode):
    pair = make_pair(SceneConfig(extent=10.0, ground_points=3000,
                                 structure_points=4000, n_boxes=6, n_walls=2,
                                 n_poles=3, observe_mode="lidar",
                                 baseline=4.0, azimuth_bins=600,
                                 elevation_bins=32),
                     max_rotation_deg=30, max_translation=2.0, seed=3)
    kw = dict(num_points=6000, mode=mode, seed=5)
    extra = ({} if mode == "voxel" else
             dict(scene_pts=pair["scene_pts"], scene_seg=pair["scene_seg"]))
    got = sem.equalize_sampling(pair["src_pts"], pair["src_seg"],
                                sem.SEMConfig(**kw), **extra)
    want = jax_sem.equalize_sampling(pair["src_pts"], pair["src_seg"],
                                     jax_sem.SEMConfig(**kw), **extra)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])


def test_datasets_quantize_with_native():
    from umeregrobust_tpu_torch.data import datasets

    assert datasets.quantize_np is native.quantize


def test_hp_matmul_and_transform_equal_jax_at_50_m():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-50, 50, (3, 1000, 3)).astype(np.float32)
    a = rng.uniform(-np.pi, np.pi, 3)
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for i, ang in enumerate(a):
        c, s = np.cos(ang), np.sin(ang)
        T[i, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[i, :3, 3] = rng.uniform(-20, 20, 3)
    got = n(precision.hp_transform_pts(t(T), t(pts)))
    want = np.asarray(jax_precision.hp_transform_pts(jnp.asarray(T),
                                                     jnp.asarray(pts)))
    f64 = pts.astype(np.float64) @ np.swapaxes(T[:, :3, :3], -1, -2) \
        + T[:, None, :3, 3]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, f64, rtol=0, atol=2e-5)
    A = rng.uniform(-50, 50, (64, 32)).astype(np.float32)
    B = rng.uniform(-50, 50, (32, 48)).astype(np.float32)
    got = n(precision.hp_matmul(t(A), t(B)))
    want = np.asarray(jax_precision.hp_matmul(jnp.asarray(A), jnp.asarray(B)))
    # fp32 sums of 32 products of up to 2500: within 32 x 2500 x 2^-24 x 2
    bound = 32 * 2500 * 2.0 ** -24 * 2
    f64 = A.astype(np.float64) @ B
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    np.testing.assert_allclose(got, f64, rtol=0, atol=bound)
    assert got.dtype == np.float32


def test_tf32_off_restores_the_callers_flags():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with precision.tf32_off():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def test_phase_and_report_have_the_jax_format(capsys):
    for mod in (profiling, jax_profiling):
        mod.reset()
        for _ in range(2):
            with mod.phase("stage_a"):
                pass
        with mod.phase("stage_b", sync=False):
            pass
    out = profiling.report()
    want = jax_profiling.report()
    lines, wlines = out.splitlines(), want.splitlines()
    assert lines[0] == wlines[0]
    assert [ln.split()[0] for ln in lines[1:]] == \
        [ln.split()[0] for ln in wlines[1:]]
    assert [ln.split()[2] for ln in lines[1:]] == \
        [ln.split()[2] for ln in wlines[1:]]
    assert {ln.split()[0]: ln.split()[2] for ln in lines[1:]} == {
        "stage_a": "2", "stage_b": "1"}
    assert all(len(a) == len(b) for a, b in zip(lines, wlines))
    profiling.reset()
    assert profiling.report().splitlines()[1:] == []
    from umeregrobust_tpu_torch import utils

    assert utils.phase is profiling.phase and utils.report is profiling.report


def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))


def test_ensure_compile_cache_makes_and_returns_the_build_dir(tmp_path,
                                                              monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "default")
    got = cache.ensure_compile_cache()
    assert got == str(tmp_path / "default") and os.path.isdir(got)
    got = cache.ensure_compile_cache(str(tmp_path / "mine"))
    assert got == str(tmp_path / "mine") and os.path.isdir(got)
    assert _build.BUILD_DIR == tmp_path / "mine"  # the library builds there
