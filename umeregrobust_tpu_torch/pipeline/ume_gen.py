"""UME descriptor generation by capped ball-query moment accumulation
(port of umeregrobust_tpu/pipeline/ume_gen.py).

F[k] = sum_n w[k, n] [f_n | f_n x_n | f_n y_n | f_n z_n], w[k, n] = 1 iff
point n lies within the radius of keypoint k and is among the first
max_nn such points in index order (PyTorch3D ball_query capping). The
accumulation always goes through the kernel wrapper ops/cuda_ume: the
CUDA kernel on CUDA tensors (any width C), its plain version on CPU
tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from umeregrobust_tpu_torch.ops.cuda_ume import ume_moments_fused

__all__ = ["ume_from_ball_query", "moment_rows", "moments_to_ume"]


def moment_rows(pts: torch.Tensor, feats: torch.Tensor,
                p_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """([B,] N, 4C) fp32 rows Z = [f | f x | f y | f z], f the features
    zeroed on invalid rows: what the moments kernel sums."""
    f = feats.to(torch.float32)
    if p_mask is not None:
        f = f * p_mask[..., None]
    return torch.cat([f, f * pts[..., 0:1], f * pts[..., 1:2],
                      f * pts[..., 2:3]], dim=-1).contiguous()


def moments_to_ume(F: torch.Tensor, C: int, normalize: bool = True,
                   eps: float = 1e-6,
                   k_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """([B,] M, 4C) summed rows -> ([B,] M, C, 4) moment matrices, divided
    by the total zeroth moment when normalize, zero on masked keypoints."""
    F = F.reshape(F.shape[:-1] + (4, C)).transpose(-1, -2)
    if normalize:
        total = torch.sum(F[..., 0], dim=-1, keepdim=True)[..., None]
        F = F / (total + eps)
    if k_mask is not None:
        F = F * k_mask[..., None, None]
    return F


def ume_from_ball_query(
    pts: torch.Tensor,
    feats: torch.Tensor,
    kpts: torch.Tensor,
    radius: float,
    max_nn: int,
    p_mask: Optional[torch.Tensor] = None,
    k_mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """([B,] M, C, 4) fp32 UME moment matrices [m0 | m1] for every
    keypoint, normalised by the total zeroth moment, over an optional
    leading pair axis (one kernel launch for the batch). feats ([B,] N, C)
    must be zero on invalid rows."""
    pts = pts.to(torch.float32).contiguous()
    Z = moment_rows(pts, feats, p_mask)
    pm = (p_mask if p_mask is not None
          else torch.ones(feats.shape[:-1], dtype=torch.bool,
                          device=pts.device))
    F = ume_moments_fused(kpts.to(torch.float32).contiguous(), pts, Z,
                          pm.contiguous(), radius=float(radius),
                          max_nn=int(max_nn))
    return moments_to_ume(F, feats.shape[-1], eps=eps, k_mask=k_mask)
