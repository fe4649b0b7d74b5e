"""core/ of the port against the JAX package: quaternion-Jacobi Kabsch,
Gram-Schmidt, packed projections, the closed-form UME estimator, the
validity mask and the transform metrics (fp32, max abs 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import n, t
from umeregrobust_tpu.core import so3 as jso3
from umeregrobust_tpu.core import transforms as jtr
from umeregrobust_tpu.core import ume as jume
from umeregrobust_tpu_torch.core import so3, transforms, ume


def _rigid(rng, B):
    ang = rng.uniform(-np.pi, np.pi, B)
    ax = rng.normal(size=(B, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    K = np.zeros((B, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -ax[:, 2], ax[:, 1], -ax[:, 0]
    K = K - K.transpose(0, 2, 1)
    R = (np.eye(3) + np.sin(ang)[:, None, None] * K
         + (1 - np.cos(ang))[:, None, None] * K @ K)
    T = np.tile(np.eye(4), (B, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.uniform(-10, 10, (B, 3))
    return T.astype(np.float32)


@pytest.mark.parametrize("sweeps", [3, 6])
def test_kabsch_rotation_matches_jax(sweeps):
    rng = np.random.default_rng(0)
    H = rng.normal(size=(64, 3, 3)).astype(np.float32)
    got = n(so3.kabsch_rotation(t(H), sweeps=sweeps))
    want = np.asarray(jso3.kabsch_rotation(jnp.asarray(H), sweeps=sweeps))
    np.testing.assert_allclose(got, want, atol=1e-5)
    # proper rotations
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


def test_gram_schmidt_and_projection_match_jax():
    rng = np.random.default_rng(1)
    F = rng.normal(size=(32, 32, 4)).astype(np.float32)
    F[0, :, 3] = F[0, :, 1]  # rank-deficient column -> zero vector
    np.testing.assert_allclose(n(so3.gram_schmidt(t(F))),
                               np.asarray(jso3.gram_schmidt(jnp.asarray(F))),
                               atol=1e-5)
    np.testing.assert_allclose(
        n(ume.projection_packed(t(F))),
        np.asarray(jume.projection_packed(jnp.asarray(F))), atol=1e-5)


def _ume_pairs(rng, B=48, K=60, C=32):
    """UME matrices of B neighbourhoods and of their rigidly moved copies."""
    T = _rigid(rng, B)
    p = rng.normal(scale=3.0, size=(B, K, 3))
    f = rng.uniform(0, 1, size=(B, K, C))
    q = p @ T[:, :3, :3].transpose(0, 2, 1) + T[:, None, :3, 3]
    q = q + rng.normal(scale=0.01, size=q.shape)

    def mom(x):
        F = np.concatenate([f.sum(1)[..., None],
                            np.einsum("bkc,bki->bci", f, x)], -1)
        return (F / F[..., 0].sum(-1)[:, None, None]).astype(np.float32)

    return mom(p), mom(q), T


@pytest.mark.parametrize("sweeps", [3, 6])
def test_estimate_rigid_from_ume_matches_jax(sweeps):
    G, H, T_true = _ume_pairs(np.random.default_rng(2))
    Tg, Dg = ume.estimate_rigid_from_ume(t(G), t(H), sweeps=sweeps)
    Tj, Dj = jume.estimate_rigid_from_ume(jnp.asarray(G), jnp.asarray(H),
                                          sweeps=sweeps)
    np.testing.assert_allclose(n(Tg), np.asarray(Tj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(Dg), np.asarray(Dj), atol=1e-5)
    # and it recovers the motion (a sanity check on the oracle data)
    assert np.abs(n(Tg)[:, :3, :3] - T_true[:, :3, :3]).max() < 0.05


def test_ume_validity_mask_matches_jax():
    rng = np.random.default_rng(3)
    F = rng.normal(size=(8, 32, 4)).astype(np.float32)
    F[2, :, 2] = 0.0
    F[5] = 0.0
    got = n(ume.ume_validity_mask(t(F)))
    want = np.asarray(jume.ume_validity_mask(jnp.asarray(F)))
    np.testing.assert_array_equal(got, want)
    assert not got[2] and not got[5] and got[0]


def test_transforms_and_metrics_match_jax():
    rng = np.random.default_rng(4)
    A, B = _rigid(rng, 16), _rigid(rng, 16)
    pts = rng.normal(size=(16, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(transforms.apply_transform(t(A), t(pts))),
        np.asarray(jtr.apply_transform(jnp.asarray(A), jnp.asarray(pts))),
        atol=1e-5)
    np.testing.assert_allclose(
        n(transforms.invert_rigid(t(A))),
        np.asarray(jtr.invert_rigid(jnp.asarray(A))), atol=1e-5)
    np.testing.assert_allclose(
        n(transforms.make_transform(t(A[:, :3, :3]), t(A[:, :3, 3]))), A)
    np.testing.assert_allclose(
        n(transforms.relative_rotation_error(t(A[:, :3, :3]),
                                             t(B[:, :3, :3]))),
        np.asarray(jtr.relative_rotation_error(jnp.asarray(A[:, :3, :3]),
                                               jnp.asarray(B[:, :3, :3]))),
        atol=1e-3)
    np.testing.assert_allclose(
        n(transforms.relative_translation_error(t(A[:, :3, 3]),
                                                t(B[:, :3, 3]))),
        np.asarray(jtr.relative_translation_error(jnp.asarray(A[:, :3, 3]),
                                                  jnp.asarray(B[:, :3, 3]))),
        atol=1e-5)
