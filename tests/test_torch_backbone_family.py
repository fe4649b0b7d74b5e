"""The rest of the backbone family against the JAX package: forwards of
ResUNet (k7 stem, stride 4, 'BN' blocks) and ResUNet5 (k3 and k5 layers,
'BN2') with the JAX package's freshly initialised parameters carried over
by params_from_jax, fp32 on both sides (max abs 1e-4 on the unit-norm
features); ResUNetSmall2 with the in-repo weights through the per-tap conv
on every layer (conv_impl="scan") against the JAX package's scan forward
and against the port's grouped forward; and init_resunet's shapes and
standard deviations."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CAPS, WEIGHTS, n, t, voxel_cloud
from umeregrobust_tpu.models.resunet import (
    ARCHS as JARCHS, build_unet_geometry as jax_geometry,
    init_resunet as jax_init, resunet_apply)
from umeregrobust_tpu.train.checkpoint import load_checkpoint as jax_load
from umeregrobust_tpu_torch.data.suite import small_pair
from umeregrobust_tpu_torch.models.resunet import (
    ARCHS, ResUNet, build_unet_geometry, init_resunet)
from umeregrobust_tpu_torch.models.weights import load_model, params_from_jax

# ~500 voxels of two clouds in [-12, 12)^3; capacities that hold every
# level of both 6-level pyramids (strides 4-2-2-2-3 and 2-2-2-2-3)
CLOUD = dict(n_vox=500, cap=512, lim=12)
CAPS6 = (512, 512, 448, 128, 32, 32)


@pytest.mark.parametrize("arch_name", ["ResUNet", "ResUNet5"])
def test_six_level_forward_matches_jax_fp32(arch_name):
    c4, mask = voxel_cloud(21, **CLOUD)
    jarch, arch = JARCHS[arch_name], ARCHS[arch_name]
    params, state = jax_init(jax.random.PRNGKey(1), jarch, 1, 16)
    # running statistics away from (0, 1) and a head bias, so the norm
    # layers and the bias are exercised
    rng = np.random.default_rng(4)
    state = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(
            rng.uniform(0.5, 1.5, x.shape) if path[-1].key == "var"
            else rng.uniform(-0.2, 0.2, x.shape), jnp.float32), state)
    params["final"]["b"] = jnp.asarray(rng.uniform(-0.1, 0.1, 16), jnp.float32)
    jg = jax_geometry(jnp.asarray(c4), jnp.asarray(mask), jarch, CAPS6)
    fin = mask[:, None].astype(np.float32)
    want, _ = resunet_apply(params, state, jg, jnp.asarray(fin), jarch,
                            train=False, compute_dtype=jnp.float32)
    want = np.asarray(want)

    model = ResUNet(arch, 1, 16)
    model.load_state_dict(params_from_jax(params, state), strict=True)
    del params, state
    tg = build_unet_geometry(t(c4), t(mask), arch, CAPS6)
    for lv, level in enumerate(tg["levels"]):  # no level overflowed
        assert 0 < int(level.mask.sum()) < CAPS6[lv] or lv == 0, lv
    got = n(model.eval()(tg, t(fin)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    norms = np.linalg.norm(got, axis=1)
    np.testing.assert_allclose(norms[mask], 1.0, atol=1e-5)
    assert np.all(norms[~mask] == 0)
    # which layers run the per-tap conv on the default path
    per_tap = [not hasattr(m, "masks") for m in tg["enc_g"]]
    assert per_tap == [k != 3 for k in arch.kernel_sizes]


@pytest.fixture(scope="module")
def small2():
    p = small_pair(42)
    tgt = p["tgt"]["coords"].copy()
    tgt[:, 0] += p["tgt"]["mask"]
    coords = np.concatenate([p["src"]["coords"], tgt])
    mask = np.concatenate([p["src"]["mask"], p["tgt"]["mask"]])
    caps2 = tuple(2 * c for c in CAPS)
    tg = build_unet_geometry(t(coords), t(mask), ARCHS["ResUNetSmall2"], caps2)
    fin = mask[:, None].astype(np.float32)
    scan = n(load_model(WEIGHTS, ARCHS["ResUNetSmall2"], conv_impl="scan",
                      device="cpu")(
        tg, t(fin)))
    return coords, mask, caps2, tg, fin, scan


def test_scan_forward_matches_jax_scan(small2):
    coords, mask, caps2, _, fin, scan = small2
    blob = jax_load(WEIGHTS)
    jg = jax_geometry(jnp.asarray(coords), jnp.asarray(mask),
                      JARCHS["ResUNetSmall2"], caps2)
    want, _ = resunet_apply(blob["params"], blob["bn_state"], jg,
                            jnp.asarray(fin), JARCHS["ResUNetSmall2"],
                            train=False, compute_dtype=jnp.float32,
                            conv_impl="scan")
    np.testing.assert_allclose(scan, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_scan_forward_matches_grouped_forward(small2, dtype, tol):
    _, mask, _, tg, fin, scan = small2
    out = {impl: n(load_model(WEIGHTS, ARCHS["ResUNetSmall2"],
                              conv_impl=impl, device="cpu")(
        tg, t(fin), dtype))
           for impl in ("grouped", "scan")}
    # the two forms add the same fp32 products in another order. With
    # bf16 operands a last-bit difference in one layer's sum can flip the
    # next layer's operand rounding (2^-8 relative), so the whole network
    # agrees to about 1e-2 at worst and far closer on average
    np.testing.assert_allclose(out["scan"], out["grouped"], atol=tol)
    assert np.abs(out["scan"] - out["grouped"]).mean() < tol / 20
    if dtype == torch.float32:
        np.testing.assert_array_equal(out["scan"], scan)
    assert np.abs(np.linalg.norm(out["scan"], axis=1)[mask] - 1).max() < 1e-5


def test_conv_impl_is_checked():
    with pytest.raises(ValueError, match="conv_impl"):
        ResUNet(ARCHS["ResUNetSmall2"], conv_impl="dense")
    assert ResUNet(ARCHS["ResUNetSmall2"]).conv_impl == "grouped"


@pytest.mark.parametrize("arch_name", sorted(ARCHS))
def test_init_resunet_gives_the_jax_shapes(arch_name):
    shapes = jax.eval_shape(
        lambda k: jax_init(k, JARCHS[arch_name], 1, 16), jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in params_from_jax(
        *jax.tree_util.tree_map(lambda s: np.zeros((0,) + s.shape[1:]),
                                shapes)).items()}
    with torch.device("meta"):
        model = ResUNet(ARCHS[arch_name], 1, 16)
    got = {k: (0,) + tuple(v.shape[1:]) for k, v in model.state_dict().items()}
    assert got == want
    full = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    kv = [a ** 3 for a in ARCHS[arch_name].kernel_sizes]
    assert full["conv1.w"] == (kv[0], 1, 32)
    assert full[f"conv{len(kv) - 1}_tr.w"][0] == kv[-1]
    assert ("block1.conv2.w" in full) == (ARCHS[arch_name].block == "BN")


def test_init_resunet_draws_he_normal_from_the_generator():
    arch = ARCHS["ResUNetSmall"]
    g = torch.Generator().manual_seed(7)
    model = init_resunet(arch, 1, 16, generator=g, device="cpu")
    assert not model.training
    sd = model.state_dict()
    for name, w in sd.items():
        if name.endswith(".w"):
            want = math.sqrt(2.0 / math.prod(w.shape[:-1]))
            if w.numel() >= 20000:
                assert abs(float(w.std()) / want - 1) < 0.03, name
                assert abs(float(w.mean())) < 0.05 * want, name
        elif name.endswith((".scale", ".var")):
            assert bool((w == 1).all()), name
        else:  # biases and running means
            assert bool((w == 0).all()), name
    again = init_resunet(arch, 1, 16, device="cpu",
                         generator=torch.Generator().manual_seed(7))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())
    other = init_resunet(arch, 1, 16, device="cpu",
                         generator=torch.Generator().manual_seed(8))
    assert not torch.equal(sd["conv2.w"], other.state_dict()["conv2.w"])
