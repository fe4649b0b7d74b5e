"""The backbone of the port against the JAX package: the coordinate
pyramid, per-tap neighbour tables and grouped maps of
build_unet_geometry identical on small capacities (both clouds of a pair
in one pyramid, as register_pair_e2e builds it), and the ResUNetSmall2
forward with the in-repo weights at fp32 on both sides (max abs 1e-4 on
the unit-norm features)."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import CAPS, WEIGHTS, n, t
from umeregrobust_tpu.models.resunet import (
    ARCHS as JARCHS, build_unet_geometry as jax_geometry, resunet_apply)
from umeregrobust_tpu.train.checkpoint import load_checkpoint as jax_load
from umeregrobust_tpu_torch.data.suite import small_pair
from umeregrobust_tpu_torch.models.resunet import ARCHS, build_unet_geometry
from umeregrobust_tpu_torch.models.weights import load_model


def _fused_coords(seed):
    """Both clouds of a small pair in one coordinate set (batch id 1 on
    the target), as register_pair_e2e feeds the backbone."""
    p = small_pair(seed)
    tgt = p["tgt"]["coords"].copy()
    tgt[:, 0] += p["tgt"]["mask"]
    return (np.concatenate([p["src"]["coords"], tgt]),
            np.concatenate([p["src"]["mask"], p["tgt"]["mask"]]))


@pytest.fixture(scope="module")
def geoms():
    coords, mask = _fused_coords(42)
    caps2 = tuple(2 * c for c in CAPS)
    jg = jax_geometry(jnp.asarray(coords), jnp.asarray(mask),
                      JARCHS["ResUNetSmall2"], caps2)
    tg = build_unet_geometry(t(coords), t(mask), ARCHS["ResUNetSmall2"],
                             caps2)
    return coords, mask, jg, tg


def test_pyramid_levels_identical(geoms):
    _, mask, jg, tg = geoms
    for jl, tl in zip(jg["levels"], tg["levels"]):
        np.testing.assert_array_equal(n(tl.mask), np.asarray(jl.mask))
        m = np.asarray(jl.mask)
        np.testing.assert_array_equal(n(tl.coords)[m], np.asarray(jl.coords)[m])
    # the level-0 permutation agrees on every valid row
    v = int(mask.sum())
    np.testing.assert_array_equal(n(tg["order0"])[:v],
                                  np.asarray(jg["order0"])[:v])
    np.testing.assert_array_equal(n(tg["inv0"])[mask],
                                  np.asarray(jg["inv0"])[mask])


@pytest.mark.parametrize("kind", ["enc", "block", "dec"])
def test_neighbour_tables_and_grouped_maps_identical(geoms, kind):
    _, _, jg, tg = geoms
    for jm, tm in zip(jg[f"{kind}_maps"], tg[f"{kind}_maps"]):
        np.testing.assert_array_equal(n(tm), np.asarray(jm))
    for jm, tm in zip(jg[f"{kind}_g"], tg[f"{kind}_g"]):
        for field in ("center", "masks", "patho", "worder"):
            np.testing.assert_array_equal(n(getattr(tm, field)),
                                          np.asarray(getattr(jm, field)),
                                          f"{kind} {field}")


def test_resunet_forward_matches_jax_fp32(geoms):
    coords, mask, jg, tg = geoms
    blob = jax_load(WEIGHTS)
    fin = mask[:, None].astype(np.float32)
    want, _ = resunet_apply(blob["params"], blob["bn_state"], jg,
                            jnp.asarray(fin), JARCHS["ResUNetSmall2"],
                            train=False, compute_dtype=jnp.float32)
    model = load_model(WEIGHTS, ARCHS["ResUNetSmall2"], device="cpu")
    got = n(model(tg, t(fin)))
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=1e-4)
    norms = np.linalg.norm(got, axis=1)
    np.testing.assert_allclose(norms[mask], 1.0, atol=1e-5)
    assert np.all(norms[~mask] == 0)
