"""The JAX package's public functions that had no counterpart in the port
until the synthetic pretraining slice, against the JAX package on the
CPU: `icp_point_to_point` (T within 1e-4, rmse and fitness), `rotation_z`,
`orthonormalize`, `max_cell_count`, `make_level`, the tensor quantize
(`quantize_torch`, the counterpart of `quantize_jax`) and
`coords_to_grid_pts`, identical or to fp32 rounding; the random
transforms by their properties (orthonormal, det 1, the angle and
translation ranges, reproducible from a torch.Generator)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from test_torch_icp import _cloud_pair, _rot_z
from umeregrobust_tpu.core import transforms as jtf
from umeregrobust_tpu.core import ume as jume
from umeregrobust_tpu.ops import densegrid as jdg
from umeregrobust_tpu.ops import sparse as jsparse
from umeregrobust_tpu.ops import voxel as jvoxel
from umeregrobust_tpu.pipeline.icp import icp_point_to_point as jax_icp
from umeregrobust_tpu_torch.core import transforms, ume
from umeregrobust_tpu_torch.ops import densegrid, sparse, voxel
from umeregrobust_tpu_torch.pipeline.icp import icp_point_to_point

DIMS = (64, 64, 32)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_icp_point_to_point_matches_jax(masked):
    src, sm, tgt, tm, gt = _cloud_pair(3)
    init = _rot_z(0.27, [0.7, -0.45, 0.0]) if masked else \
        _rot_z(0.31, [0.85, -0.55, 0.1])
    kw = dict(max_corr=0.5, max_iter=40, budget=16, dims=DIMS)
    masks = (dict(src_mask=sm, tgt_mask=tm) if masked else {})
    Tj, rj, fj = jax_icp(jnp.asarray(src), jnp.asarray(tgt),
                         jnp.asarray(init),
                         **{k: jnp.asarray(v) for k, v in masks.items()},
                         **kw)
    T, r, f = icp_point_to_point(t(src), t(tgt), t(init),
                                 **{k: t(v) for k, v in masks.items()}, **kw)
    np.testing.assert_allclose(n(T), n(Tj), rtol=0, atol=1e-4)
    assert float(r) == pytest.approx(float(rj), rel=1e-3, abs=1e-5)
    assert float(f) == pytest.approx(float(fj), abs=1e-3)
    # it converged onto the truth (the noise is 1 cm)
    assert np.abs(n(T) - gt).max() < 0.05 and float(f) > 0.9


def test_rotation_z_matches_jax():
    a = np.random.default_rng(0).uniform(-4, 4, (3, 5)).astype(np.float32)
    got = transforms.rotation_z(t(a))
    assert got.shape == (3, 5, 3, 3)
    np.testing.assert_allclose(n(got), np.asarray(jtf.rotation_z(
        jnp.asarray(a))), rtol=0, atol=1e-7)


def test_orthonormalize_matches_jax():
    rng = np.random.default_rng(1)
    F = rng.normal(size=(6, 32, 4)).astype(np.float32)
    F[1, :, 3] = 2.0 * F[1, :, 0]  # a rank-deficient matrix
    F[2] = 0.0  # an empty one
    got = n(ume.orthonormalize(t(F)))
    want = np.asarray(jume.orthonormalize(jnp.asarray(F)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert np.all(got[1, :, 3] == 0) and np.all(got[2] == 0)
    gram = np.einsum("bdi,bdj->bij", got[3:], got[3:])
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(4), gram.shape),
                               atol=1e-5)


def test_max_cell_count_matches_jax():
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.uniform(-5, 5, (900, 3)),
                          0.25 + rng.normal(scale=0.03, size=(100, 3))]
                         ).astype(np.float32)  # one crowded cell
    mask = rng.random(1000) > 0.1
    want = jdg.max_cell_count(jdg.build_dense_grid(
        jnp.asarray(pts), jnp.asarray(mask), cell=0.5, dims=DIMS))
    got = densegrid.max_cell_count(densegrid.build_dense_grid(
        t(pts), t(mask), cell=0.5, dims=DIMS))
    assert int(got) == int(want) > 20
    both = densegrid.build_dense_grid(t(np.stack([pts, pts[::-1].copy()])),
                                      t(np.stack([mask, mask])), cell=0.5,
                                      dims=DIMS)
    assert n(densegrid.max_cell_count(both)).tolist() == [int(want)] * 2


def test_make_level_matches_jax():
    c = np.arange(12, dtype=np.int32).reshape(3, 4)
    m = np.array([True, False, True])
    got = sparse.make_level(t(c), t(m))
    want = jsparse.make_level(jnp.asarray(c), jnp.asarray(m))
    assert isinstance(got, sparse.Level) and got._fields == want._fields
    assert np.array_equal(n(got.coords), np.asarray(want.coords))
    assert np.array_equal(n(got.mask), np.asarray(want.mask))


@pytest.mark.parametrize("max_voxels", [64, 700, 2000])
def test_quantize_matches_jax(max_voxels):
    rng = np.random.default_rng(max_voxels)
    pts = rng.uniform(-4, 6, (1500, 3)).astype(np.float32)
    pts[1000:] = pts[:500] + 0.01  # repeated voxels
    mask = rng.random(1500) > 0.2
    want = jvoxel.quantize_jax(jnp.asarray(pts), 0.3, jnp.asarray(mask),
                               max_voxels)
    got = voxel.quantize_torch(t(pts), 0.3, t(mask), max_voxels)
    for g, w, name in zip(got, want, ("coords", "rep", "mask")):
        assert n(g).dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(n(g), np.asarray(w), err_msg=name)
    # the voxels are quantize_np's, where all fit
    c_np, _ = voxel.quantize_np(pts[mask], 0.3)
    if max_voxels >= len(c_np):
        assert int(got[2].sum()) == len(c_np)
        assert sorted(map(tuple, n(got[0])[n(got[2])])) == \
            sorted(map(tuple, c_np))


def test_coords_to_grid_pts_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-8, 8, (400, 3)).astype(np.float32)
    coords = np.floor(pts / 0.3).astype(np.int32)
    pm, cm = rng.random(400) > 0.1, rng.random(400) > 0.1
    for kw in ({}, dict(pts_mask=pm, coords_mask=cm)):
        want = jvoxel.coords_to_grid_pts(
            jnp.asarray(pts), jnp.asarray(coords), 0.3,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = voxel.coords_to_grid_pts(t(pts), t(coords), 0.3,
                                       **{k: t(v) for k, v in kw.items()})
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=0,
                                   atol=2e-6)
    np.testing.assert_allclose(
        n(voxel.coords_to_grid_pts(t(pts), t(coords), 0.3)),
        voxel.coords_to_grid_pts_np(pts, coords, 0.3), rtol=0, atol=2e-6)


def _rotation_checks(R):
    R = R.double()
    eye = torch.eye(3, dtype=torch.float64).expand(R.shape)
    assert torch.allclose(R @ R.transpose(-1, -2), eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(R), torch.ones(R.shape[:-2],
                                                          dtype=R.dtype),
                          atol=1e-5)


def test_random_rotation_properties():
    R = transforms.random_rotation(torch.Generator().manual_seed(0),
                                   (500,))
    assert R.shape == (500, 3, 3) and R.dtype == torch.float32
    _rotation_checks(R)
    again = transforms.random_rotation(torch.Generator().manual_seed(0),
                                       (500,))
    assert torch.equal(R, again)
    one = transforms.random_rotation(torch.Generator().manual_seed(1))
    assert one.shape == (3, 3)
    _rotation_checks(one)
    # spread over SO(3): the mean of uniform rotations is near zero
    assert float(R.double().mean(0).abs().max()) < 0.1
    # the JAX package's function has the same properties
    Rj = np.array(jtf.random_rotation(jax.random.PRNGKey(0), (50,)))
    _rotation_checks(torch.from_numpy(Rj))


@pytest.mark.parametrize("max_t,max_a", [(10.0, np.pi), (2.0, 0.3)])
def test_random_rigid_transform_properties(max_t, max_a):
    T = transforms.random_rigid_transform(torch.Generator().manual_seed(3),
                                          (400,), max_translation=max_t,
                                          max_angle_rad=max_a)
    assert T.shape == (400, 4, 4)
    _rotation_checks(T[:, :3, :3])
    assert torch.equal(T[:, 3], torch.tensor([0.0, 0, 0, 1]).expand(400, 4))
    tr = T[:, :3, 3]
    assert float(tr.abs().max()) <= max_t
    assert float(tr.abs().max()) > 0.8 * max_t  # the range is used
    ang = transforms.relative_rotation_error(torch.eye(3), T[:, :3, :3])
    assert float(ang.max()) <= np.degrees(max_a) + 1e-2
    assert float(ang.max()) > 0.8 * np.degrees(max_a)
    again = transforms.random_rigid_transform(
        torch.Generator().manual_seed(3), (400,), max_translation=max_t,
        max_angle_rad=max_a)
    assert torch.equal(T, again)
    Tj = np.array(jtf.random_rigid_transform(
        jax.random.PRNGKey(3), (50,), max_translation=max_t,
        max_angle_rad=max_a))
    assert np.abs(Tj[:, :3, 3]).max() <= max_t
    _rotation_checks(torch.from_numpy(Tj[:, :3, :3]))
