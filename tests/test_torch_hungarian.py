"""The Hungarian parity path of the port against the JAX package's:
hungarian_match (the same assignment on tie-free matrices, the same total
cost where ties leave a choice), ume_pairwise_distance, and
register_pair_hungarian on one small pair with the JAX keypoint draws
injected and the same numpy rng, with and without the probabilistic
filter. The port's fp32 features of the pair feed both packages; the JAX
scorer runs its Pallas kernel in interpret mode (the path the TPU runs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import umeregrobust_tpu.ops.pallas_corr as jpc
import umeregrobust_tpu.pipeline.correlator as jcorr
from _torch_parity import CAPS, SMALL_CFG, WEIGHTS, n, rot_deg, t
from umeregrobust_tpu.core.ume import ume_pairwise_distance as jax_dist
from umeregrobust_tpu.pipeline.matching import hungarian_match as jax_hungarian
from umeregrobust_tpu.pipeline.registration import (
    RegistrationConfig as JaxConfig,
    register_pair_hungarian as jax_register_hungarian)
from umeregrobust_tpu_torch.core.ume import ume_pairwise_distance
from umeregrobust_tpu_torch.data.suite import small_pair
from umeregrobust_tpu_torch.models.resunet import ARCHS
from umeregrobust_tpu_torch.models.weights import load_model
from umeregrobust_tpu_torch.pipeline.e2e import pair_features_e2e
from umeregrobust_tpu_torch.pipeline.matching import hungarian_match
from umeregrobust_tpu_torch.pipeline.registration import (
    RegistrationConfig, register_pair_hungarian)


def _by_row(m):
    return m[np.argsort(m[:, 0], kind="stable")]


@pytest.mark.parametrize("shape", [(40, 40), (25, 37), (37, 25)])
def test_hungarian_match_equals_jax_without_ties(shape):
    D = np.random.default_rng(sum(shape)).random(shape)
    got, want = hungarian_match(D), jax_hungarian(D)
    assert got.dtype == np.int64 and got.shape == (min(shape), 2)
    np.testing.assert_array_equal(_by_row(got), _by_row(want))


def test_hungarian_match_with_ties_has_the_optimal_cost():
    D = np.random.default_rng(0).integers(0, 3, (30, 30)).astype(np.float64)
    got, want = hungarian_match(D), jax_hungarian(D)
    assert len(set(got[:, 0])) == len(set(got[:, 1])) == 30
    assert D[got[:, 0], got[:, 1]].sum() == D[want[:, 0], want[:, 1]].sum()


def test_ume_pairwise_distance_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(20, 32, 4)).astype(np.float32)
    b = rng.normal(size=(30, 32, 4)).astype(np.float32)
    got = n(ume_pairwise_distance(t(a), t(b)))
    want = np.asarray(jax_dist(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (20, 30)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def features():
    """small_pair(42) and the port's fp32 features of it (CPU)."""
    pair = small_pair(42)
    s, tg = pair["src"], pair["tgt"]
    model = load_model(WEIGHTS, ARCHS["ResUNetSmall2"], device="cpu")
    f = pair_features_e2e(model, CAPS, s["coords"], s["grid"], s["mask"],
                          tg["coords"], tg["grid"], tg["mask"], s["corr_pts"],
                          s["corr_mask"], tg["corr_pts"], tg["corr_mask"],
                          compute_dtype=torch.float32, device="cpu")
    return pair, [n(x) for x in f]


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jpc.pl, "pallas_call", patched)

    def score(mode, *a, knn_k=20, sigma=1.5, chunk=1024):
        return jcorr.correlator_scores_radius_fused(*a, sigma=sigma)

    monkeypatch.setattr(jcorr, "_score", score)


@pytest.mark.parametrize("filter_by_ume_dist", [False, True])
def test_register_pair_hungarian_matches_jax(features, pallas_interpret,
                                             filter_by_ume_dist):
    pair, (sf, tf, csf, ctf) = features
    s, tg = pair["src"], pair["tgt"]
    kw = dict(SMALL_CFG, filter_by_ume_dist=filter_by_ume_dist)
    n_kp = kw["num_init_keypoints"] if filter_by_ume_dist \
        else kw["ume_n_samples"]
    key = jax.random.PRNGKey(3)
    # the keypoints registration._ume_and_distance draws from `key`
    k_ume, _ = jax.random.split(key)
    draws = {}
    for name, k, m in zip(("src_kp", "tgt_kp"), jax.random.split(k_ume),
                          (s["mask"], tg["mask"])):
        p = jnp.asarray(m).astype(jnp.float32)
        draws[name] = np.asarray(jax.random.choice(
            k, p.shape[0], (n_kp,), replace=False,
            p=p / jnp.maximum(jnp.sum(p), 1.0)))
    arrays = (s["grid"], sf, s["mask"], tg["grid"], tf, tg["mask"],
              s["corr_pts"], csf, s["corr_mask"], tg["corr_pts"], ctf,
              tg["corr_mask"])
    want = jax_register_hungarian(JaxConfig(**kw), key,
                                  *(jnp.asarray(a) for a in arrays),
                                  rng=np.random.default_rng(0))
    got = register_pair_hungarian(RegistrationConfig(**kw), *arrays,
                                  rng=np.random.default_rng(0), draws=draws,
                                  device="cpu")
    Ti, Tr = n(got.T_init), n(got.T_refined)
    jTi, jTr = np.asarray(want.T_init), np.asarray(want.T_refined)
    assert np.isfinite(Ti).all() and np.isfinite(Tr).all()
    if not filter_by_ume_dist:  # every valid match: the same hypotheses
        np.testing.assert_allclose(Ti, jTi, atol=1e-4)
    # the same basin after ICP
    assert rot_deg(Tr[:3, :3], jTr[:3, :3]) < 0.05
    assert np.abs(Tr[:3, 3] - jTr[:3, 3]).max() < 1e-2
    if filter_by_ume_dist:  # the parity mode registers the pair (64
        # keypoints without the filter leave both packages ~1.3 m off)
        assert rot_deg(Tr[:3, :3], pair["gt"][:3, :3]) < 1.0
        assert np.linalg.norm(Tr[:3, 3] - pair["gt"][:3, 3]) < 0.2

