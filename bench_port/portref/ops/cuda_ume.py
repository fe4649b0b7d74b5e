"""Capped ball-query UME moments, the plain version of the port's
ops/cuda_ume.py (its kernel's arithmetic, without the kernel).

out[k] = sum_n w[k, n] * Z[n], w[k, n] = 1 iff point n is valid, lies
within `radius` of keypoint k (direct-difference distance), and is among
the first `max_nn` such points in index order, or the first caps[k] where
the caller gives per-keypoint caps.
"""
from __future__ import annotations

from typing import Optional

import torch

from portref.ops.neighbors import sqdist3

__all__ = ["ume_moments_plain"]


def _r2(radius: float) -> torch.Tensor:
    return torch.tensor(float(radius) ** 2, dtype=torch.float32)


def ume_moments_plain(kpts: torch.Tensor, pts: torch.Tensor, Z: torch.Tensor,
                      p_mask: torch.Tensor, radius: float, max_nn: int,
                      chunk: int = 256,
                      caps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """([B,] M, 4C) fp32 capped moments, chunked over keypoints; caps
    ([B,] M) int32, when given, cap each keypoint in place of max_nn."""
    r2 = _r2(radius).to(pts.device)
    pts = pts.to(torch.float32)
    Z = Z.to(torch.float32)
    out = []
    for s in range(0, kpts.shape[-2], chunk):
        ok = (sqdist3(kpts[..., s:s + chunk, :].to(torch.float32), pts)
              <= r2) & p_mask[..., None, :]
        cum = torch.cumsum(ok.to(torch.int32), dim=-1)
        cap = max_nn if caps is None else caps[..., s:s + chunk, None]
        w = (ok & (cum <= cap)).to(torch.float32)
        out.append(w @ Z)
    if not out:
        return torch.zeros(kpts.shape[:-2] + (0, Z.shape[-1]),
                           dtype=torch.float32, device=Z.device)
    return torch.cat(out, dim=-2)
