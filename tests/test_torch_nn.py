"""Kernel nn1_argmin (plain version on CPU tensors) against the JAX Pallas
kernel in interpret mode and brute force, index for index; and the
feature transfer copy_features_to_raw against the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import n, t
from umeregrobust_tpu.ops.pallas_nn import nn1_argmin as jax_nn1
from umeregrobust_tpu.pipeline.registration import (
    copy_features_to_raw as jax_copy)
from umeregrobust_tpu_torch.ops.cuda_nn import nn1_argmin, nn1_argmin_plain
from umeregrobust_tpu_torch.pipeline.registration import copy_features_to_raw


def _brute(q, p, pm):
    d2 = ((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1)
    d2[:, ~pm] = np.inf
    return d2.argmin(-1)


@pytest.mark.parametrize("N,M,masked", [(512, 96, 0.1), (300, 45, 0.0),
                                        (1000, 130, 0.5)])
def test_nn1_argmin_matches_pallas_and_brute_force(N, M, masked):
    rng = np.random.default_rng(N)
    p = (rng.normal(size=(N, 3)) * 8).astype(np.float32)
    q = (rng.normal(size=(M, 3)) * 8).astype(np.float32)
    pm = rng.random(N) >= masked
    got = n(nn1_argmin(t(q), t(p), t(pm)))
    assert got.dtype == np.int64
    pallas = np.asarray(jax_nn1(jnp.asarray(q), jnp.asarray(p),
                                jnp.asarray(pm), ts=32, sl=128,
                                interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _brute(q, p, pm))
    assert pm[got].all()  # masked rows never win


def test_nn1_argmin_ties_go_to_the_first_index():
    p = np.zeros((64, 3), np.float32)
    p[10:] = 5.0
    q = np.zeros((3, 3), np.float32)
    pm = np.ones(64, bool)
    pm[:4] = False  # first VALID duplicate wins
    np.testing.assert_array_equal(n(nn1_argmin_plain(t(q), t(p), t(pm))),
                                  [4, 4, 4])


def test_copy_features_to_raw_matches_jax():
    rng = np.random.default_rng(7)
    sem = (rng.normal(size=(700, 3)) * 6).astype(np.float32)
    sm = rng.random(700) > 0.2
    feat = rng.normal(size=(700, 32)).astype(np.float32) * sm[:, None]
    raw = (rng.normal(size=(300, 3)) * 6).astype(np.float32)
    rm = rng.random(300) > 0.1
    got = n(copy_features_to_raw(t(raw), t(rm), t(sem), t(feat), t(sm)))
    want = np.asarray(jax_copy(jnp.asarray(raw), jnp.asarray(rm),
                               jnp.asarray(sem), jnp.asarray(feat),
                               jnp.asarray(sm)))
    np.testing.assert_array_equal(got, want)
