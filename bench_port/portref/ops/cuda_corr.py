"""Radius-capped Cauchy correlation scores, the plain version of the
port's ops/cuda_corr.py (its kernel's arithmetic, without the kernel).

score_h = sum_i sum_j 1[d2 <= (rf sigma)^2] / (1 + d2 / sigma^2) <f_i, g_j>,
d2 = |pts_t[h, i] - q_j|^2 from direct differences in fp32. Invalid rows
must carry zero features. A leading pair axis (B pairs of one shape) is
optional.
"""
from __future__ import annotations

import math

import torch

from portref.ops.neighbors import sqdist3

__all__ = ["corr_scores_plain"]


def _constants(sigma: float, radius_factor: float):
    inv_s2 = torch.tensor(1.0 / float(sigma) ** 2, dtype=torch.float32)
    r2 = torch.tensor(float(radius_factor * sigma) ** 2, dtype=torch.float32)
    return inv_s2, r2


def corr_scores_plain(pts_t: torch.Tensor, src_featw: torch.Tensor,
                      tgt_pts4: torch.Tensor, tgt_featw: torch.Tensor,
                      sigma: float = 1.5, radius_factor: float = 2.0,
                      max_elems: int = 1 << 22) -> torch.Tensor:
    """([B,] H) scores; hypotheses chunked so each (h, i, j) block holds
    at most max_elems entries."""
    inv_s2, r2 = (c.to(pts_t.device) for c in _constants(sigma, radius_factor))
    H, S = pts_t.shape[-3:-1]
    T = tgt_pts4.shape[-2]
    G = src_featw.to(torch.float32) @ tgt_featw.to(torch.float32).transpose(
        -1, -2)  # ([B,] S, T)
    q = tgt_pts4[..., None, :, :3].to(torch.float32)
    B = math.prod(pts_t.shape[:-3])
    hc = max(1, max_elems // max(B * S * T, 1))
    out = []
    for h0 in range(0, H, hc):
        d2 = sqdist3(pts_t[..., h0:h0 + hc, :, :3].to(torch.float32), q)
        w = torch.where(d2 <= r2, 1.0 / (1.0 + d2 * inv_s2),
                        torch.zeros_like(d2))
        out.append(torch.sum(w * G[..., None, :, :], dim=(-2, -1)))
    if not out:
        return torch.zeros(pts_t.shape[:-2], dtype=torch.float32,
                           device=pts_t.device)
    return torch.cat(out, dim=-1)
