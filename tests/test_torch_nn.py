"""Kernel nn1_argmin (plain version on CPU tensors) against the JAX Pallas
kernel in interpret mode and brute force, index for index, also at the
forced cases that chip_smoke.py runs on the kernel; and the feature
transfer copy_features_to_raw (nn1_copy_rows: the search and the row copy
in one call) against the JAX package's and against the three-step form it
replaces."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _transfer_inputs(seed, B=None, M=300, N=700, C=32):
    """Seeded SEM points, features and masks and correlator points and
    masks, with a leading pair axis B where given."""
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    sem = (rng.normal(size=lead + (N, 3)) * 6).astype(np.float32)
    sm = rng.random(lead + (N,)) > 0.2
    feat = rng.normal(size=lead + (N, C)).astype(np.float32) * sm[..., None]
    raw = (rng.normal(size=lead + (M, 3)) * 6).astype(np.float32)
    rm = rng.random(lead + (M,)) > 0.3
    return raw, rm, sem, feat, sm


@pytest.mark.parametrize("B", [None, 1, 3])
def test_nn1_copy_rows_plain_matches_jax_feature_transfer(B):
    # the fused form's plain version against the JAX package's
    # copy_features_to_raw, pair by pair, masked queries included
    raw, rm, sem, feat, sm = _transfer_inputs(11, B)
    got = n(cuda_nn.nn1_copy_rows_plain(t(raw), t(rm), t(sem), t(sm),
                                        t(feat)))
    assert got.shape == raw.shape[:-1] + (feat.shape[-1],)
    for b in ([None] if B is None else range(B)):
        sl = () if b is None else (b,)
        want = np.asarray(jax_copy(jnp.asarray(raw[sl]), jnp.asarray(rm[sl]),
                                   jnp.asarray(sem[sl]),
                                   jnp.asarray(feat[sl]),
                                   jnp.asarray(sm[sl])))
        np.testing.assert_array_equal(got[sl], want)
        assert not got[sl][~rm[sl]].any()  # masked queries: zero rows


@pytest.mark.parametrize("B", [None, 4])
def test_nn1_copy_rows_is_the_three_step_form_bit_for_bit(B):
    # nn1_argmin, the mask's where and gather_padded (the form the merge's
    # copy replaces), on a strided table view as the feature stage passes
    # it (one side of a (B, 2, N, C) block)
    from umeregrobust_tpu_torch.ops.neighbors import gather_padded

    raw, rm, sem, feat, sm = _transfer_inputs(12, B, C=20)
    both = t(np.stack([feat, -feat], axis=-3))  # ([B,] 2, N, C)
    table = both[:, 0] if B is not None else both[0]
    assert B is None or not table.is_contiguous()
    idx = nn1_argmin(t(raw), t(sem), t(sm))
    want = gather_padded(table, torch.where(t(rm), idx,
                                            torch.full_like(idx, -1)))
    got = cuda_nn.nn1_copy_rows(t(raw), t(rm), t(sem), t(sm), table)
    assert torch.equal(got, want)
    assert torch.equal(copy_features_to_raw(t(raw), t(rm), t(sem), table,
                                            t(sm)), want)
    assert cuda_nn.LAUNCHES_COPY == 0  # CPU tensors: the plain version


def test_nn1_copy_rows_refuses_a_table_that_takes_a_gradient():
    # the feature transfer is serving only; a gradient through the table
    # would be dropped, so the call raises instead
    raw, rm, sem, feat, sm = _transfer_inputs(13)
    table = t(feat).requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        cuda_nn.nn1_copy_rows(t(raw), t(rm), t(sem), t(sm), table)
    with torch.no_grad():  # as the feature stage calls it
        got = cuda_nn.nn1_copy_rows(t(raw), t(rm), t(sem), t(sm), table)
    assert torch.equal(got, cuda_nn.nn1_copy_rows_plain(
        t(raw), t(rm), t(sem), t(sm), table.detach()))

