"""Rigid-transform utilities and registration error metrics (port of
umeregrobust_tpu/core/transforms.py). fp32 throughout; matmuls run in
full fp32 (callers keep TF32 off on the GPU)."""
from __future__ import annotations

import math

import torch

__all__ = ["make_transform", "apply_transform", "invert_rigid", "compose",
           "relative_rotation_error", "relative_translation_error"]


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) homogeneous transforms from (..., 3, 3) R and (..., 3) t."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def apply_transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) rigid transforms to (..., N, 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def invert_rigid(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_transform(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


def compose(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """T1 after T2."""
    return T1 @ T2


def relative_rotation_error(R: torch.Tensor, R_hat: torch.Tensor) -> torch.Tensor:
    """RRE in degrees via the trace formula, trace clamped to [-1, 3]."""
    delta = R_hat @ R.transpose(-1, -2)
    tr = torch.diagonal(delta, dim1=-2, dim2=-1).sum(-1).clamp(-1.0, 3.0)
    return torch.arccos((tr - 1.0) / 2.0) * (180.0 / math.pi)


def relative_translation_error(t: torch.Tensor, t_hat: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t_hat - t, dim=-1)
