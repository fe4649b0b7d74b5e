"""Rigid-transform utilities and registration error metrics (port of
umeregrobust_tpu/core/transforms.py). fp32 throughout; matmuls run in
full fp32 (callers keep TF32 off on the GPU)."""
from __future__ import annotations

import math

import torch

__all__ = ["make_transform", "apply_transform", "invert_rigid", "compose",
           "rotation_z", "random_rotation", "random_rigid_transform",
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


def rotation_z(angle_rad: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations about the z axis by (...) angles."""
    c, s = torch.cos(angle_rad), torch.sin(angle_rad)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zeros], dim=-1),
                        torch.stack([s, c, zeros], dim=-1),
                        torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)


def random_rotation(generator: torch.Generator, batch: tuple = ()
                    ) -> torch.Tensor:
    """Uniform random rotations (batch + (3, 3)) on the generator's device:
    QR of a Gaussian matrix, Q's columns signed by R's diagonal, the last
    column flipped where det Q = -1."""
    A = torch.randn(tuple(batch) + (3, 3), generator=generator,
                    device=generator.device)
    Q, R = torch.linalg.qr(A)
    Q = Q * torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))[..., None, :]
    flip = torch.ones_like(Q[..., 0, :])
    flip[..., 2] = torch.sign(torch.linalg.det(Q))
    return Q * flip[..., None, :]


def random_rigid_transform(generator: torch.Generator, batch: tuple = (),
                           max_translation: float = 10.0,
                           max_angle_rad: float = math.pi) -> torch.Tensor:
    """Random rigid transforms (batch + (4, 4)) on the generator's device:
    a Gaussian axis, an angle uniform in [-max_angle_rad, max_angle_rad]
    (Rodrigues), each translation component uniform in
    [-max_translation, max_translation]."""
    batch, dev = tuple(batch), generator.device
    axis = torch.randn(batch + (3,), generator=generator, device=dev)
    axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
                   + 1e-12)
    ang = (torch.rand(batch, generator=generator, device=dev) * 2.0 - 1.0
           ) * max_angle_rad
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(ax)
    K = torch.stack([torch.stack([zeros, -az, ay], dim=-1),
                     torch.stack([az, zeros, -ax], dim=-1),
                     torch.stack([-ay, ax, zeros], dim=-1)], dim=-2)
    s = torch.sin(ang)[..., None, None]
    c = torch.cos(ang)[..., None, None]
    R = torch.eye(3, device=dev).expand(batch + (3, 3)) + s * K \
        + (1.0 - c) * (K @ K)
    t = (torch.rand(batch + (3,), generator=generator, device=dev) * 2.0
         - 1.0) * max_translation
    return make_transform(R, t)


def relative_rotation_error(R: torch.Tensor, R_hat: torch.Tensor) -> torch.Tensor:
    """RRE in degrees via the trace formula, trace clamped to [-1, 3]."""
    delta = R_hat @ R.transpose(-1, -2)
    tr = torch.diagonal(delta, dim1=-2, dim2=-1).sum(-1).clamp(-1.0, 3.0)
    return torch.arccos((tr - 1.0) / 2.0) * (180.0 / math.pi)


def relative_translation_error(t: torch.Tensor, t_hat: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t_hat - t, dim=-1)
