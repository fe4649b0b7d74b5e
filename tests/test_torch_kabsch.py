"""The port's SO(3) solver on the CPU: `core.so3.kabsch_rotation`'s contract
(any leading dims, n = 0, sweeps 3 and 6), its dispatch
(`ops.cuda_so3.route`: CPU -> plain, CUDA under a gradient -> plain and
AUTOGRAD_CALLS, else the kernel), CPU calls never launching the kernel,
the forced cases of `ops.cuda_so3.forced_cases` against the JAX
package's kabsch_rotation and a float64 SVD Kabsch, and the constants
the wrapper and the tests share with csrc/kabsch.cu. The kernel itself is
held to the plain version bit for bit on the card:
tests/test_torch_kabsch_card.py."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import n, t
from umeregrobust_tpu.core import so3 as jso3
from umeregrobust_tpu_torch.core import so3
from umeregrobust_tpu_torch.ops import _build, cuda_so3

_FORCED = cuda_so3.forced_cases()
_KERNEL_SRC = (Path(cuda_so3.__file__).resolve().parent.parent / "csrc"
               / "kabsch.cu").read_text()


def _svd_kabsch(H):
    """float64 sign-corrected SVD Kabsch: (R, singular values, det sign)."""
    U, S, Vt = np.linalg.svd(H.astype(np.float64))
    V, Ut = Vt.transpose(0, 2, 1), U.transpose(0, 2, 1)
    d = np.sign(np.linalg.det(V @ Ut))
    D = np.tile(np.eye(3), (len(H), 1, 1))
    D[:, 2, 2] = d
    return V @ D @ Ut, S, d


def _angle_deg(A, B):
    c = (np.trace(A.transpose(0, 2, 1) @ B, axis1=1, axis2=2) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.mark.parametrize("sweeps", [3, 6])
@pytest.mark.parametrize("lead", [(), (0,), (5,), (2, 0), (2, 3, 4)])
def test_contract_any_leading_dims(lead, sweeps):
    rng = np.random.default_rng(len(lead) * 10 + sweeps)
    H = rng.normal(size=lead + (3, 3)).astype(np.float32)
    before = cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS
    got = so3.kabsch_rotation(t(H), sweeps=sweeps)
    assert (cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS) == before
    assert got.shape == lead + (3, 3) and got.dtype == torch.float32
    flat = n(so3.kabsch_rotation_plain(t(H.reshape(-1, 3, 3)), sweeps))
    np.testing.assert_array_equal(n(got).reshape(-1, 3, 3), flat)
    R = n(got).reshape(-1, 3, 3).astype(np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


@pytest.mark.parametrize("device_type,grad,req,want", [
    ("cpu", False, False, "plain"), ("cpu", True, True, "plain"),
    ("cpu", True, False, "plain"), ("meta", True, True, "plain"),
    ("cuda", True, True, "autograd"), ("cuda", True, False, "kernel"),
    ("cuda", False, True, "kernel"), ("cuda", False, False, "kernel")])
def test_route(device_type, grad, req, want):
    assert cuda_so3.route(device_type, grad, req) == want


def test_dispatch_follows_the_route(monkeypatch):
    """kabsch_rotation does what `route` says: the kernel wrapper for
    "kernel", the plain version counted in AUTOGRAD_CALLS for
    "autograd" (here faked on CPU tensors, which route to "plain")."""
    H = t(np.random.default_rng(1).normal(size=(4, 3, 3)).astype(np.float32))
    want = so3.kabsch_rotation_plain(H, 3)
    seen = []
    monkeypatch.setattr(cuda_so3, "kabsch_rotation",
                        lambda h, s: seen.append((h, s)) or want)
    monkeypatch.setattr(cuda_so3, "route", lambda *a: "kernel")
    assert so3.kabsch_rotation(H, sweeps=3) is want
    assert len(seen) == 1 and seen[0][0] is H and seen[0][1] == 3
    monkeypatch.setattr(cuda_so3, "route", lambda *a: "autograd")
    before = cuda_so3.AUTOGRAD_CALLS
    torch.testing.assert_close(so3.kabsch_rotation(H, sweeps=3), want,
                               rtol=0, atol=0)
    assert cuda_so3.AUTOGRAD_CALLS == before + 1 and len(seen) == 1


def test_cpu_calls_never_launch_the_kernel():
    rng = np.random.default_rng(2)
    H = t(rng.normal(size=(6, 3, 3)).astype(np.float32)).requires_grad_(True)
    before = cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS
    R = so3.kabsch_rotation(H, sweeps=6)
    R.sum().backward()  # the plain version keeps its graph on the CPU
    assert torch.isfinite(H.grad).all() and H.grad.abs().sum() > 0
    with torch.no_grad():
        so3.kabsch_rotation(H, sweeps=3)
    for H2 in _FORCED.values():
        so3.kabsch_rotation(t(H2), sweeps=3)
    assert (cuda_so3.LAUNCHES, cuda_so3.AUTOGRAD_CALLS) == before


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    before = cuda_so3.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_so3.kabsch_rotation(torch.zeros(2, 3, 3), 3)
    assert cuda_so3.LAUNCHES == before


@pytest.mark.parametrize("sweeps", [3, 6])
@pytest.mark.parametrize("case", sorted(_FORCED))
def test_forced_cases_match_jax_and_svd(case, sweeps):
    """Where the optimal rotation is unique (rank >= 2, the smallest two
    singular values apart when det < 0, |H|^2 finite in fp32) the plain
    version is within 1e-5 of the JAX package and within the documented
    0.13 deg of the float64 SVD solution; where it is not, both reach the
    optimum of tr(R H). |H|^2 past fp32's range gives the identity, a NaN
    entry a NaN rotation, in both."""
    H = _FORCED[case]
    got = n(so3.kabsch_rotation(t(H), sweeps=sweeps))
    want = np.asarray(jso3.kabsch_rotation(jnp.asarray(H), sweeps=sweeps))
    if np.isnan(H).any():
        bad = np.isnan(H).any(axis=(1, 2))
        assert np.isnan(got[bad]).all() and np.isnan(want[bad]).all()
        H, got, want = H[~bad], got[~bad], want[~bad]
    with np.errstate(over="ignore"):
        sq = np.sum(H * H, axis=(1, 2), dtype=np.float32)
    if not np.isfinite(sq).all():
        np.testing.assert_array_equal(got, np.broadcast_to(np.eye(3),
                                                           got.shape))
        np.testing.assert_array_equal(got, want)
        return
    R_svd, S, d = _svd_kabsch(H)
    unique = (S[:, 1] > 1e-3 * S[:, 0]) & (
        (d > 0) | (S[:, 1] - S[:, 2] > 1e-3 * S[:, 0]))
    np.testing.assert_allclose(got[unique], want[unique], atol=1e-5)
    assert (_angle_deg(got[unique].astype(np.float64), R_svd[unique])
            <= 0.13).all()
    H64 = H.astype(np.float64)
    best = np.einsum("nij,nji->n", R_svd, H64)
    for R in (got, want):
        gap = best - np.einsum("nij,nji->n", R.astype(np.float64), H64)
        assert (np.abs(gap) <= 1e-5 * np.maximum(S[:, 0], 1e-30)).all()
    if case == "zero":
        np.testing.assert_array_equal(got, np.broadcast_to(np.eye(3),
                                                           got.shape))


def test_forced_cases_reach_their_edges():
    f32 = np.float32
    _, S, d = _svd_kabsch(np.nan_to_num(_FORCED["rank1"]))
    assert (S[:, 1] < 1e-6 * S[:, 0]).all()
    _, S, _ = _svd_kabsch(_FORCED["rank2"])
    assert (S[:, 2] < 1e-6 * S[:, 0]).all() and (S[:, 1] > 0.1).all()
    _, S, d = _svd_kabsch(_FORCED["det_negative"])
    assert (d < 0).all() and (np.diff(S, axis=1) < -1e-3).all()
    _, S, d = _svd_kabsch(_FORCED["minus_rotation"])
    assert (d < 0).all() and np.allclose(S, 1.0, atol=1e-6)
    _, S, _ = _svd_kabsch(_FORCED["near_equal_singular_values"])
    gaps = np.minimum(S[:, 0] - S[:, 1], S[:, 1] - S[:, 2])
    assert (gaps < 4 * np.finfo(f32).eps).all()
    R = _FORCED["rotation_180"].astype(np.float64)
    np.testing.assert_allclose(np.trace(R, axis1=1, axis2=2), -1.0, atol=1e-6)
    assert not _FORCED["zero"].any()
    with np.errstate(over="ignore"):
        sq = {k: np.sum(_FORCED[k] * _FORCED[k], axis=(1, 2), dtype=f32)
              for k in ("scale_1e-20", "scale_1e20")}
    assert (sq["scale_1e-20"] < np.finfo(f32).tiny).all()
    assert (sq["scale_1e-20"] > 0).all()
    assert np.isinf(sq["scale_1e20"]).all()
    assert np.isfinite(_FORCED["scale_1e20"]).all()
    assert np.isnan(_FORCED["nan_entry"]).any(axis=(1, 2)).sum() == 3
    assert all(v.dtype == f32 and v.shape[1:] == (3, 3)
               for v in _FORCED.values())


def test_constants_mirror_the_kernel():
    """The block size and the rotation order are the kernel's; the C entry
    has its ctypes signature; no fast-math function or flag changes the
    library functions' bits."""
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", _KERNEL_SRC)}
    threads = const["kThreads"]  # the block: launch bounds and grid alike
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert "__launch_bounds__(kThreads)" in _KERNEL_SRC
    assert "(n + kThreads - 1) / kThreads" in _KERNEL_SRC
    assert "kThreads, 0," in _KERNEL_SRC
    pairs = [(int(p), int(r)) for p, r in
             re.findall(r"rotate<(\d), (\d)>\(A, V\);", _KERNEL_SRC)]
    assert pairs == so3._PAIRS
    assert _build._SIGNATURES["umr_kabsch_rotation"] == [
        _build._VP, _build._VP, _build._LL, _build._INT, _build._VP]
    for fn in ("atan2f(", "cosf(", "sinf(", "sqrtf("):
        assert fn in _KERNEL_SRC
    assert not re.search(r"__(sinf|cosf|tanf|expf|logf|powf|fdividef|"
                         r"fsqrt_rn|frsqrt_rn|fmaf_rn)\(", _KERNEL_SRC)
    assert not any("fast" in f or "fmad" in f for f in _build.NVCC_FLAGS)
