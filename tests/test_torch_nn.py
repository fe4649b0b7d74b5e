"""Kernel nn1_argmin (plain version on CPU tensors) against the JAX Pallas
kernel in interpret mode and brute force, index for index, also at the
forced cases that chip_smoke.py runs on the kernel; and the feature
transfer copy_features_to_raw against the JAX package's."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import n, t
from umeregrobust_tpu.ops.pallas_nn import nn1_argmin as jax_nn1
from umeregrobust_tpu.pipeline.registration import (
    copy_features_to_raw as jax_copy)
from umeregrobust_tpu_torch.ops import cuda_nn
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


def _brute_chunked(q, p, pm, chunk=4096):
    return np.concatenate([_brute(q[s:s + chunk], p, pm)
                           for s in range(0, len(q), chunk)])


_FORCED = cuda_nn.forced_cases()


@pytest.mark.parametrize("case", sorted(_FORCED))
def test_nn1_argmin_forced_cases_match_pallas_and_brute_force(case):
    """The cases chip_smoke.py runs on the kernel (sizes from the kernel's
    constants in ops/cuda_nn.py): the plain version, the Pallas kernel in
    interpret mode and float64 brute force agree index for index."""
    q, p, pm = _FORCED[case]
    got = n(nn1_argmin(t(q), t(p), t(pm)))
    want = _brute_chunked(q, p, pm) if pm.any() else np.zeros(len(q))
    np.testing.assert_array_equal(got, want)
    ts = 1024 if len(q) > 100_000 else 8
    pallas = np.asarray(jax_nn1(jnp.asarray(q), jnp.asarray(p),
                                jnp.asarray(pm), ts=ts, sl=128,
                                interpret=True))
    np.testing.assert_array_equal(got, pallas)
    if case == "all_masked_but_last":
        assert (got == len(p) - 1).all()
    if case == "all_masked":
        assert (got == 0).all()


def test_forced_ties_sit_on_the_kernel_boundaries():
    """The tie cases put their pairs on the boundaries the kernel's plan
    makes for 132 SMs: the first of each pair wins, or the second where the
    first is masked."""
    for case, cut in (("ties_at_segment_boundaries", 5000),
                      ("ties_at_tile_boundaries", 300_000)):
        _, S, seg = cuda_nn.launch_plan(8, cut, 132)
        assert seg % cuda_nn.STEP == 0 and (S - 1) * seg < cut <= S * seg
        for masked in (False, True):
            q, p, pm = _FORCED[case + ("_first_masked" if masked else "")]
            got = n(nn1_argmin(t(q), t(p), t(pm)))
            pairs = np.flatnonzero((p[1:] == p[:-1]).all(1) & (p[1:, 0] == 60))
            bounds = pairs + 1
            assert (bounds % seg == 0).all() or (
                (bounds % seg) % cuda_nn.TILE == 0).all()
            np.testing.assert_array_equal(got[:len(bounds)],
                                          bounds - (0 if masked else 1))
    assert cuda_nn.launch_plan(8, 300_000, 132)[2] > cuda_nn.TILE


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
