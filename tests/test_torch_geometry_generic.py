"""The generic (exact-match-join) geometry of the port against the JAX
package's, exactly: pyramid levels, per-tap encoder / block / decoder maps
and the grouped forms where they exist, for archs with k5/k7 layers,
stride 4 and 'BN' blocks; the port's generic per-map lookups as an
independent reference; and the building blocks one to one."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import n, t, voxel_cloud as _cloud
from umeregrobust_tpu.models.resunet import (
    ARCHS as JARCHS, build_unet_geometry as jax_geometry,
    default_level_capacities as jax_caps)
from umeregrobust_tpu.ops import sparse as jsparse
from umeregrobust_tpu_torch.models.resunet import (
    ARCHS, _tensor_strides, build_unet_geometry, default_level_capacities)
from umeregrobust_tpu_torch.ops import sparse as tsparse
from umeregrobust_tpu_torch.ops.sparse import GroupedMap, Level

FAMILY = ["ResUNet", "ResUNet2", "ResUNet4", "ResUNet5", "ResUNetSmall"]


def _assert_map_equal(tm, jm, msg):
    if isinstance(tm, GroupedMap):
        for field in ("center", "masks", "patho", "worder"):
            np.testing.assert_array_equal(
                n(getattr(tm, field)), np.asarray(getattr(jm, field)),
                f"{msg} {field}")
    else:
        assert not isinstance(jm, jsparse.GroupedMap), msg
        np.testing.assert_array_equal(n(tm), np.asarray(jm), msg)


def test_archs_and_default_capacities_equal():
    assert {k: tuple(v) for k, v in ARCHS.items()} == {
        k: tuple(v) for k, v in JARCHS.items()}
    for name in ARCHS:
        for n0 in (2048, 16384, 32768):
            assert default_level_capacities(n0, ARCHS[name]) == jax_caps(
                n0, JARCHS[name]), name
    assert default_level_capacities(16384, ARCHS["ResUNet"]) == (
        16384, 2176, 768, 384, 128, 128)


@pytest.mark.parametrize("arch_name", FAMILY)
def test_geometry_equals_jax_exactly(arch_name):
    c4, mask = _cloud(3)
    L = len(ARCHS[arch_name].channels)
    caps = (192,) * L
    jg = jax_geometry(jnp.asarray(c4), jnp.asarray(mask), JARCHS[arch_name],
                      caps)
    tg = build_unet_geometry(t(c4), t(mask), ARCHS[arch_name], caps)
    for lv, (jl, tl) in enumerate(zip(jg["levels"], tg["levels"])):
        m = np.asarray(jl.mask)
        np.testing.assert_array_equal(n(tl.mask), m, f"level {lv}")
        np.testing.assert_array_equal(n(tl.coords)[m], np.asarray(jl.coords)[m])
    assert int(tg["levels"][1].mask.sum()) > 8  # the pyramid is not empty
    v = int(mask.sum())
    np.testing.assert_array_equal(n(tg["order0"])[:v],
                                  np.asarray(jg["order0"])[:v])
    for kind in ("enc", "block", "dec"):
        assert len(tg[f"{kind}_maps"]) == len(jg[f"{kind}_maps"])
        for i, (jm, tm) in enumerate(zip(jg[f"{kind}_maps"],
                                         tg[f"{kind}_maps"])):
            np.testing.assert_array_equal(n(tm), np.asarray(jm),
                                          f"{kind}_maps[{i}]")
        for i, (jm, tm) in enumerate(zip(jg[f"{kind}_g"], tg[f"{kind}_g"])):
            _assert_map_equal(tm, jm, f"{kind}_g[{i}]")


@pytest.mark.parametrize("arch_name", ["ResUNet", "ResUNet5"])
def test_geometry_equals_the_per_map_lookups(arch_name):
    """build_unet_geometry's half-offset / adjoint construction gives the
    maps that one generic join per map gives (any key order)."""
    arch = ARCHS[arch_name]
    c4, mask = _cloud(5)
    L = len(arch.channels)
    geom = build_unet_geometry(t(c4), t(mask), arch, (192,) * L)
    ts = _tensor_strides(arch)
    lv_ = geom["levels"]
    np.testing.assert_array_equal(
        n(geom["enc_maps"][0]),
        n(tsparse.build_self_map(lv_[0], arch.kernel_sizes[0], 1)))
    for lv in range(L):
        np.testing.assert_array_equal(
            n(geom["block_maps"][lv]),
            n(tsparse.build_self_map(lv_[lv], 3, ts[lv])), f"block {lv}")
    for lv in range(1, L):
        np.testing.assert_array_equal(
            n(geom["enc_maps"][lv]),
            n(tsparse.build_conv_map(lv_[lv - 1], lv_[lv],
                                     arch.kernel_sizes[lv], ts[lv - 1])),
            f"enc {lv}")
        np.testing.assert_array_equal(
            n(geom["dec_maps"][L - 1 - lv]),
            n(tsparse.build_transpose_map(lv_[lv], lv_[lv - 1],
                                          arch.kernel_sizes[lv], ts[lv - 1])),
            f"dec {lv}")


@pytest.mark.parametrize("k,tstride", [(3, 1), (5, 2), (7, 1)])
def test_kernel_offsets_equal(k, tstride):
    np.testing.assert_array_equal(tsparse.kernel_offsets(k, tstride),
                                  jsparse.kernel_offsets(k, tstride))


@pytest.mark.parametrize("kernel,tstride,stride", [(5, 1, 4), (5, 4, 2),
                                                   (5, 2, 3), (3, 1, 2),
                                                   (7, 1, 2)])
def test_interface_candidates_equal(kernel, tstride, stride):
    c4, mask = _cloud(7, lim=24)
    c4[:, 1:] = np.where(mask[:, None], c4[:, 1:] // tstride * tstride,
                         c4[:, 1:])
    jc = jsparse.interface_candidates(
        jsparse.make_level(jnp.asarray(c4), jnp.asarray(mask)), kernel,
        tstride, stride)
    tc = tsparse.interface_candidates(Level(t(c4), t(mask)), kernel, tstride,
                                      stride)
    J = (2 * (kernel // 2)) // stride + 1
    assert tc.valid.shape == (J ** 3, len(mask))
    np.testing.assert_array_equal(n(tc.valid), np.asarray(jc.valid))
    v = np.asarray(jc.valid)
    np.testing.assert_array_equal(n(tc.coords)[v], np.asarray(jc.coords)[v])
    np.testing.assert_array_equal(n(tc.kidx)[v], np.asarray(jc.kidx)[v])


def test_invert_map_batch_equal():
    rng = np.random.default_rng(11)
    K, n_in, n_out = 13, 96, 120
    fwd = np.full((K, n_in), -1, np.int32)
    for k in range(K):
        hit = rng.random(n_in) < 0.6
        fwd[k, hit] = rng.choice(n_out, hit.sum(), replace=False)
    want = np.asarray(jsparse.invert_map_batch(jnp.asarray(fwd), n_out))
    np.testing.assert_array_equal(
        n(tsparse.invert_map_batch(t(fwd, dtype=None).long(), n_out)), want)


def test_generic_lookups_equal_jax():
    """build_self_map / build_conv_map / build_transpose_map (the generic
    join over unsorted keys) equal the JAX package's."""
    c4, mask = _cloud(13)
    jl = jsparse.make_level(jnp.asarray(c4), jnp.asarray(mask))
    tl = Level(t(c4), t(mask))
    np.testing.assert_array_equal(n(tsparse.build_self_map(tl, 5, 1)),
                                  np.asarray(jsparse.build_self_map(jl, 5, 1)))
    jc, jm = jsparse.downsample_coords(jl.coords, jl.mask, out_stride=2,
                                       capacity=192)
    tc, tm = tsparse.downsample_coords(tl.coords, tl.mask, 2, 192)
    jco, tco = jsparse.make_level(jc, jm), Level(tc, tm)
    np.testing.assert_array_equal(
        n(tsparse.build_conv_map(tl, tco, 5, 1)),
        np.asarray(jsparse.build_conv_map(jl, jco, 5, 1)))
    np.testing.assert_array_equal(
        n(tsparse.build_transpose_map(tco, tl, 3, 1)),
        np.asarray(jsparse.build_transpose_map(jco, jl, 3, 1)))


def test_out_of_range_voxels_drop_out_like_jax():
    """pack_code's guards (|x|, |y| < 512, |z| < 256) drop the same
    queries and keys on both sides."""
    c4, mask = _cloud(17, n_vox=120)
    rng = np.random.default_rng(0)
    far = rng.choice(int(mask.sum()), 30, replace=False)
    c4[far[:10], 1] += 505
    c4[far[10:20], 2] -= 500
    c4[far[20:], 3] += 250
    arch = "ResUNet4"
    caps = (192,) * 6
    jg = jax_geometry(jnp.asarray(c4), jnp.asarray(mask), JARCHS[arch], caps)
    tg = build_unet_geometry(t(c4), t(mask), ARCHS[arch], caps)
    for kind in ("enc", "block", "dec"):
        for jm, tm in zip(jg[f"{kind}_maps"], tg[f"{kind}_maps"]):
            np.testing.assert_array_equal(n(tm), np.asarray(jm), kind)
