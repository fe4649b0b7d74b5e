"""The SO(3) solver as one CUDA kernel: wrapper of csrc/kabsch.cu.

`core.so3.kabsch_rotation` sends a CUDA tensor that takes no gradient
here: one launch a call, one thread a 3x3 cross-covariance, the plain
version's Horn matrix, Jacobi sweeps, argmax, normalised quaternion and
rotation in its order of fp32 operations, so that the card gives the
plain version's bits (held on the card by
tests/test_torch_kabsch_card.py). `route` is the dispatch: CPU tensors
and CUDA tensors that autograd differentiates (the training loss) run
`core.so3.kabsch_rotation_plain`; the latter are counted in
AUTOGRAD_CALLS.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from umeregrobust_tpu_torch.ops import _build

__all__ = ["kabsch_rotation", "route", "forced_cases", "LAUNCHES",
           "AUTOGRAD_CALLS"]

LAUNCHES = 0  # kernel launches by kabsch_rotation
AUTOGRAD_CALLS = 0  # CUDA calls sent to the plain version for autograd


def route(device_type: str, grad_enabled: bool, requires_grad: bool) -> str:
    """Which solver a call takes: "plain" off the card, "autograd" (the
    plain version, for its graph) on the card where a gradient is asked,
    else "kernel"."""
    if device_type != "cuda":
        return "plain"
    if grad_enabled and requires_grad:
        return "autograd"
    return "kernel"


def kabsch_rotation(H: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """(..., 3, 3) proper rotations from (..., 3, 3) cross-covariances (cast
    to f32), `sweeps` >= 0 cyclic Jacobi sweeps, by the kernel: CUDA
    tensors that take no gradient only."""
    global LAUNCHES
    dev = H.device
    if (dev.type != "cuda" or (torch.is_grad_enabled() and H.requires_grad)
            or H.dim() < 2 or tuple(H.shape[-2:]) != (3, 3) or sweeps < 0):
        raise ValueError(
            f"kabsch_rotation's kernel takes CUDA tensors (..., 3, 3) that "
            f"take no gradient and sweeps >= 0, got {tuple(H.shape)} on "
            f"{dev} with requires_grad={H.requires_grad}, sweeps={sweeps}")
    lib = _build.load_library()  # cached; raises if it cannot be built
    lead = tuple(H.shape[:-2])
    H = H.to(torch.float32).contiguous()
    R = torch.empty(lead + (3, 3), dtype=torch.float32, device=dev)
    n = H.numel() // 9
    if n == 0:
        return R
    code = lib.umr_kabsch_rotation(H.data_ptr(), R.data_ptr(), n, sweeps,
                                   _build.stream_of(dev))
    _build.check(lib, code, "kabsch_rotation")
    LAUNCHES += 1
    return R


def _rot(axis, deg) -> np.ndarray:
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    t = np.deg2rad(deg)
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K


def forced_cases() -> Dict[str, np.ndarray]:
    """(n, 3, 3) f32 cross-covariances at the solver's edges: H = 0 (S = 0:
    every Jacobi angle atan2(0, 0)); identity; rank 1 and rank 2; det < 0
    with distinct singular values (one optimal R); minus a rotation (det <
    0, three equal singular values: a continuum of optimal R); two
    singular values a few fp32 steps apart; 180-degree rotations (Horn's
    top eigenvalue at a quaternion with w = 0); entries near 1e-20 (|H|^2
    subnormal) and near 1e20 (|H|^2 overflows to inf: S = 0, the
    identity); a NaN entry. Most cases mix random rotations in, so that R
    is not the identity by construction."""
    rng = np.random.default_rng(25)

    def rots(n):
        return np.stack([_rot(rng.normal(size=3), rng.uniform(-180, 180))
                         for _ in range(n)])

    def svd_h(sv, n):  # U diag(sv) R^T with random U, R
        U, Rt = rots(n), rots(n)
        return U @ np.diag(sv) @ Rt.transpose(0, 2, 1)

    cases = {}
    cases["zero"] = np.zeros((4, 3, 3))
    cases["identity"] = np.concatenate([np.eye(3)[None], rots(3)])
    u, v = rng.normal(size=(6, 3)), rng.normal(size=(6, 3))
    cases["rank1"] = u[:, :, None] * v[:, None, :]
    cases["rank2"] = svd_h([3.0, 1.25, 0.0], 6)
    cases["det_negative"] = np.concatenate(
        [svd_h([2.0, 1.0, 0.5], 5), svd_h([1.0, 0.7, 0.01], 3)]) @ np.diag(
            [1.0, 1.0, -1.0])
    cases["minus_rotation"] = -rots(4)
    eps = np.float32(2.0 ** -22)
    cases["near_equal_singular_values"] = np.concatenate(
        [svd_h([1.0, 1.0 - eps, 0.3], 4), svd_h([1.0, 0.6, 0.6 + eps], 4),
         svd_h([1.0, 1.0, 1.0], 2)])
    cases["rotation_180"] = np.stack(
        [_rot(a, 180.0) for a in ([1, 0, 0], [0, 1, 0], [0, 0, 1],
                                  [1, 1, 0], [1, -2, 3])]
        + [_rot(rng.normal(size=3), 180.0) for _ in range(3)])
    cases["scale_1e-20"] = rots(6) * 1e-20
    cases["scale_1e20"] = rots(6) * 1e20
    nan = rots(4)
    nan[0, 0, 0] = nan[1, 2, 1] = nan[3, 1, 2] = np.nan
    cases["nan_entry"] = nan
    return {k: v.astype(np.float32) for k, v in cases.items()}
