"""ResUNet on the serving path, seeded weights, small clouds, two pairs a
batch, the 6-level pyramid at default_level_capacities:

- against the JAX package: a reduced-width arch of ResUNet's structure
  (k7 stem, stride 4, k5 strided layers, 'BN' blocks), its parameters
  carried over by params_to_jax, at fp32 and at bf16; the features of
  pair_features_batched, then T_init and T_refined of
  register_pairs_batched with the JAX keypoint draws;
- against the benchmark's plain reference (bench_port/portref: the
  port's plain paths frozen, no kernels, no JAX), reached by path:
  ResUNet at its published widths (372M parameters) and the reduced arch.
  On the CPU the port runs its plain versions, the very code portref
  froze: every tolerance is 0 (bit for bit), so these cases hold the
  served path to what the benchmark judges it by, and a sum-order change
  on it shows here as ~1e-7 of the features.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMALL_CFG, n, rot_deg
from test_torch_e2e import _jax_keypoint_draws
from umeregrobust_tpu.models.resunet import ArchSpec as JaxArchSpec
from umeregrobust_tpu.pipeline.e2e import (
    pair_features_e2e as jax_features, register_pairs_batched as jax_batched)
from umeregrobust_tpu.pipeline.registration import (
    RegistrationConfig as JaxConfig)
from umeregrobust_tpu_torch.data.suite import small_pair
from umeregrobust_tpu_torch.models.resunet import (
    ARCHS, ArchSpec, default_level_capacities, init_resunet)
from umeregrobust_tpu_torch.models.weights import params_to_jax
from umeregrobust_tpu_torch.pipeline.e2e import (
    pair_features_batched, register_pairs_batched)
from umeregrobust_tpu_torch.pipeline.registration import RegistrationConfig

BENCH = str(Path(__file__).resolve().parents[1] / "bench_port")
if BENCH not in sys.path:
    sys.path.append(BENCH)  # after the repo: portref shadows nothing

from portref.models import resunet as ref_resunet  # noqa: E402
from portref.pipeline import e2e as ref_e2e  # noqa: E402
from portref.pipeline.registration import (  # noqa: E402
    RegistrationConfig as RefConfig)

# ResUNet's structure at a quarter of its widths: k7 stem, stride-4 first
# down-sampling, k5 strided layers and transposed convs, 'BN' blocks
RESUNET_NARROW = ArchSpec((8, 16, 32, 64, 128, 256), (32, 32, 64, 64, 128, 128),
                          (7, 5, 5, 5, 5, 5), (1, 4, 2, 2, 2, 3), "BN")
SEEDS = (42, 7)  # small_pair seeds: ~1-2k voxels a cloud


def _models(arch: ArchSpec):
    """The port's ResUNet with seeded He-normal weights and portref's with
    the same tensors (assigned, not copied: the published widths hold
    1.5 GB)."""
    prog = init_resunet(arch, 1, 32, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    with torch.device("meta"):
        ref = ref_resunet.ResUNet(ref_resunet.ArchSpec(*arch), 1, 32)
    ref.load_state_dict(prog.state_dict(), assign=True)
    return prog, ref.eval()


def _stack(pairs, raw=False):
    keys = (("src", "coords"), ("src", "grid"), ("src", "mask"),
            ("tgt", "coords"), ("tgt", "grid"), ("tgt", "mask"),
            ("src", "corr_pts"), ("src", "corr_mask"),
            ("tgt", "corr_pts"), ("tgt", "corr_mask"))
    if raw:  # the correlator clouds again as ICP's raw clouds
        keys += (("src", "corr_pts"), ("src", "corr_mask"),
                 ("tgt", "corr_pts"), ("tgt", "corr_mask"))
    return [np.stack([p[a][b] for p in pairs]) for a, b in keys]


def _gens():
    return [torch.Generator().manual_seed(100 + i) for i in range(len(SEEDS))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resunet_narrow_serving_matches_jax(dtype):
    """The reduced arch through both packages: features of each pair, then
    register_pairs_batched at B = 2 with the JAX draws injected.

    Tolerances: fp32 features 1e-5 (the convs' sum orders differ: ~5e-7
    measured on unit rows); bf16 features 5e-3 of the rows' norm (a layer
    input rounded to bf16 on the other side of a tie moves an element by
    2^-8 of itself: 5.8e-4 measured); T_init 1e-4 (the same hypothesis
    picked, closed-form from features that agree: 1.4e-6 measured);
    T_refined 1e-3 and 0.05 deg (ICP's sums in another order: 9e-7)."""
    jarch = JaxArchSpec(*RESUNET_NARROW)
    pairs = [small_pair(s) for s in SEEDS]
    caps = default_level_capacities(2048, RESUNET_NARROW)
    assert len(caps) == 6
    model = init_resunet(RESUNET_NARROW, 1, 32, device="cpu",
                         generator=torch.Generator().manual_seed(3)).eval()
    params, state = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    arrays = _stack(pairs)
    got = pair_features_batched(model, caps, *arrays, compute_dtype=tdt,
                                device="cpu")
    for i in range(len(pairs)):
        want = jax_features(params, state, jarch, caps,
                            *(jnp.asarray(a[i]) for a in arrays),
                            compute_dtype=jdt)
        for g, w in zip(got, want):
            g, w = n(g[i]).astype(np.float64), np.asarray(w, np.float64)
            if dtype == "float32":
                np.testing.assert_allclose(g, w, atol=1e-5)
            else:
                assert np.linalg.norm(g - w) <= 5e-3 * np.linalg.norm(w)
    kw = dict(SMALL_CFG, filter_mode="topk")
    keys = jax.random.split(jax.random.PRNGKey(0), len(pairs))
    jTi, jTr = jax_batched(params, state, jarch, caps, JaxConfig(**kw), keys,
                           *(jnp.asarray(a) for a in arrays),
                           compute_dtype=jdt)
    Ti, Tr = register_pairs_batched(
        model, caps, RegistrationConfig(**kw), *arrays, compute_dtype=tdt,
        draws=[_jax_keypoint_draws(keys[i], p, kw["num_init_keypoints"])
               for i, p in enumerate(pairs)], device="cpu")
    for i in range(len(pairs)):
        a, b, c, d = (np.asarray(n(x)[i], np.float64)
                      for x in (Ti, jTi, Tr, jTr))
        np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_allclose(c, d, atol=1e-3)
        assert rot_deg(c[:3, :3], d[:3, :3]) < 0.05


@pytest.mark.parametrize("arch_name", ["ResUNet", "narrow"])
def test_resunet_features_batched_match_portref(arch_name):
    """pair_features_batched at B = 2, bf16 backbone as served: the
    features and their transfer to the correlator clouds, bit for bit."""
    arch = ARCHS["ResUNet"] if arch_name == "ResUNet" else RESUNET_NARROW
    pairs = [small_pair(s) for s in SEEDS]
    caps = default_level_capacities(2048, arch)
    prog, ref = _models(arch)
    got = pair_features_batched(prog, caps, *_stack(pairs),
                                compute_dtype=torch.bfloat16, device="cpu")
    want = ref_e2e.pair_features_batched(ref, caps, *_stack(pairs),
                                         compute_dtype=torch.bfloat16,
                                         device="cpu")
    mask = np.stack([p["src"]["mask"] for p in pairs])
    assert n(got[0])[mask].any() and np.isfinite(n(got[0])).all()
    # unit rows where valid (a row whose head reads all zero stays zero)
    norms = np.linalg.norm(n(got[0])[mask], axis=-1)
    unit = np.abs(norms - 1.0) < 1e-5
    assert (unit | (norms == 0)).all() and unit.mean() > 0.99
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), n(b))


def test_resunet_narrow_register_pairs_batched_matches_portref():
    """register_pairs_batched at B = 2 with ResUNet's structure at reduced
    widths, the ICP raw stage on: T_init and T_refined bit for bit with
    the same generators (random features still run every stage)."""
    pairs = [small_pair(s) for s in SEEDS]
    caps = default_level_capacities(2048, RESUNET_NARROW)
    prog, ref = _models(RESUNET_NARROW)
    kw = dict(SMALL_CFG, icp_raw_iter=3)
    Ti, Tr = register_pairs_batched(
        prog, caps, RegistrationConfig(**kw), *_stack(pairs, raw=True),
        compute_dtype=torch.bfloat16, generators=_gens(), device="cpu")
    rTi, rTr = ref_e2e.register_pairs_batched(
        ref, caps, RefConfig(**kw), *_stack(pairs, raw=True),
        compute_dtype=torch.bfloat16, generators=_gens(), device="cpu")
    assert Ti.shape == Tr.shape == (2, 4, 4)
    assert np.isfinite(n(Tr)).all()
    np.testing.assert_array_equal(n(Ti), n(rTi))
    np.testing.assert_array_equal(n(Tr), n(rTr))
