"""The port's slice end to end: register_pair_e2e against the JAX
package's, one small pair (the config and capacities of tests/test_e2e.py
with filter_mode='topk', which draws nothing after the keypoints), the
in-repo weights, fp32 backbone on both sides, and the JAX keypoint draws
injected into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import CAPS, SMALL_CFG, WEIGHTS, n, rot_deg
from umeregrobust_tpu.models.resunet import ARCHS as JARCHS
from umeregrobust_tpu.pipeline.e2e import register_pair_e2e as jax_e2e
from umeregrobust_tpu.pipeline.registration import (
    RegistrationConfig as JaxConfig)
from umeregrobust_tpu.train.checkpoint import load_checkpoint as jax_load
from umeregrobust_tpu_torch.data.suite import small_pair
from umeregrobust_tpu_torch.models.resunet import ARCHS
from umeregrobust_tpu_torch.models.weights import load_model
from umeregrobust_tpu_torch.pipeline.e2e import register_pair_e2e
from umeregrobust_tpu_torch.pipeline.registration import RegistrationConfig


def _jax_keypoint_draws(key, pair, n_kp):
    """The keypoint indices registration.py:478-486 draws from `key`."""
    k_src, k_tgt, _, _ = jax.random.split(key, 4)
    out = {}
    for name, k, tag in (("src_kp", k_src, "src"), ("tgt_kp", k_tgt, "tgt")):
        p = jnp.asarray(pair[tag]["mask"]).astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        out[name] = np.asarray(jax.random.choice(
            k, p.shape[0], (n_kp,), replace=False, p=p))
    return out


def test_register_pair_e2e_matches_jax():
    cfg_kw = dict(SMALL_CFG, filter_mode="topk")
    pair = small_pair(42)
    s, tg = pair["src"], pair["tgt"]
    key = jax.random.PRNGKey(0)
    blob = jax_load(WEIGHTS)
    jTi, jTr = jax_e2e(
        blob["params"], blob["bn_state"], JARCHS["ResUNetSmall2"], CAPS,
        JaxConfig(**cfg_kw), key,
        *(jnp.asarray(a) for a in (s["coords"], s["grid"], s["mask"],
                                   tg["coords"], tg["grid"], tg["mask"],
                                   s["corr_pts"], s["corr_mask"],
                                   tg["corr_pts"], tg["corr_mask"])),
        compute_dtype=jnp.float32)

    model = load_model(WEIGHTS, ARCHS["ResUNetSmall2"], device="cpu")
    Ti, Tr = register_pair_e2e(
        model, CAPS, RegistrationConfig(**cfg_kw),
        s["coords"], s["grid"], s["mask"], tg["coords"], tg["grid"],
        tg["mask"], s["corr_pts"], s["corr_mask"], tg["corr_pts"],
        tg["corr_mask"],
        compute_dtype=torch.float32,
        draws=_jax_keypoint_draws(key, pair, cfg_kw["num_init_keypoints"]),
        device="cpu")

    jTi, jTr, Ti, Tr = (np.asarray(n(x), np.float64) for x in (jTi, jTr, Ti, Tr))
    assert np.isfinite(Ti).all() and np.isfinite(Tr).all()
    # the selected hypothesis is the same candidate
    np.testing.assert_allclose(Ti, jTi, atol=1e-4)
    # ICP from it lands on the same transform
    np.testing.assert_allclose(Tr, jTr, atol=1e-3)
    assert rot_deg(Tr[:3, :3], jTr[:3, :3]) < 0.05
    # and both register the pair (sanity: the slice does real work)
    assert rot_deg(Tr[:3, :3], pair["gt"][:3, :3]) < 1.0
    assert np.linalg.norm(Tr[:3, 3] - pair["gt"][:3, 3]) < 0.2


def _pair_args(pair):
    s, tg = pair["src"], pair["tgt"]
    return (s["coords"], s["grid"], s["mask"], tg["coords"], tg["grid"],
            tg["mask"], s["corr_pts"], s["corr_mask"], tg["corr_pts"],
            tg["corr_mask"])


def test_scan_model_registers_like_the_grouped_model():
    """The per-tap conv on every layer (conv_impl="scan") through the
    whole path gives the grouped model's transforms with the same draws."""
    cfg = RegistrationConfig(**dict(SMALL_CFG, filter_mode="topk"))
    pair = small_pair(42)
    rng = np.random.default_rng(0)
    draws = {k: rng.permutation(np.flatnonzero(pair[tag]["mask"]))[
        :cfg.num_init_keypoints] for k, tag in (("src_kp", "src"),
                                                ("tgt_kp", "tgt"))}
    out = {}
    for impl in ("grouped", "scan"):
        model = load_model(WEIGHTS, ARCHS["ResUNetSmall2"], conv_impl=impl,
                           device="cpu")
        out[impl] = [n(x) for x in register_pair_e2e(
            model, CAPS, cfg, *_pair_args(pair), compute_dtype=torch.float32,
            draws=draws, device="cpu")]
    np.testing.assert_allclose(out["scan"][0], out["grouped"][0], atol=1e-4)
    np.testing.assert_allclose(out["scan"][1], out["grouped"][1], atol=1e-4)
    assert rot_deg(out["scan"][1][:3, :3], pair["gt"][:3, :3]) < 1.0


def test_pair_features_e2e_matches_jax():
    from umeregrobust_tpu.pipeline.e2e import pair_features_e2e as jax_feats
    from umeregrobust_tpu_torch.pipeline.e2e import pair_features_e2e

    pair = small_pair(42)
    blob = jax_load(WEIGHTS)
    want = jax_feats(blob["params"], blob["bn_state"],
                     JARCHS["ResUNetSmall2"], CAPS,
                     *(jnp.asarray(a) for a in _pair_args(pair)),
                     compute_dtype=jnp.float32)
    got = pair_features_e2e(load_model(WEIGHTS, ARCHS["ResUNetSmall2"],
                                       device="cpu"), CAPS,
                            *_pair_args(pair), compute_dtype=torch.float32,
                            device="cpu")
    assert len(got) == 4
    for name, g, w in zip(("src", "tgt", "corr_src", "corr_tgt"), got, want):
        g, w = n(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, atol=2e-4, err_msg=name)
    # transferred rows are unit-norm copies on valid rows, zero elsewhere
    cm = pair["src"]["corr_mask"]
    norms = np.linalg.norm(n(got[2]), axis=1)
    np.testing.assert_allclose(norms[cm], 1.0, atol=1e-5)
    assert np.all(norms[~cm] == 0)
