"""Fixed-shape neighbor search (port of umeregrobust_tpu/ops/neighbors.py):
pairwise squared distances, kNN and the -1-padded gather."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["pairwise_sqdist", "sqdist3", "knn", "gather_padded", "topk_stable"]

_BIG = 1e30


def pairwise_sqdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(M, N) squared distances as |q|^2 + |p|^2 - 2 q.p, clamped at 0."""
    q = q.to(torch.float32)
    p = p.to(torch.float32)
    qq = torch.sum(q * q, dim=-1)
    pp = torch.sum(p * p, dim=-1)
    return torch.clamp(qq[:, None] + pp[None, :] - 2.0 * (q @ p.T), min=0.0)


def sqdist3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., A, B) squared distances between a (..., A, 3) and b (..., B, 3)
    as ((d0*d0 + d1*d1) + d2*d2), d = a - b, one rounding per operation:
    the CUDA kernels' exact arithmetic (csrc/common.cuh umr_sqdist3), so
    the plain versions make the same radius and argmin decisions."""
    d = a[..., :, None, 0] - b[..., None, :, 0]
    d2 = d * d
    d = a[..., :, None, 1] - b[..., None, :, 1]
    d2 = d2 + d * d
    d = a[..., :, None, 2] - b[..., None, :, 2]
    return d2 + d * d


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim with ties broken toward the LOWER index
    (jax.lax.top_k's order; torch.topk promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def knn(
    query: torch.Tensor,
    points: torch.Tensor,
    K: int,
    q_mask: Optional[torch.Tensor] = None,
    p_mask: Optional[torch.Tensor] = None,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest neighbors sorted ascending: (dists (M, K), idx (M, K) int64).
    Invalid points sit at +1e30 squared distance."""
    ds, ids = [], []
    for s in range(0, query.shape[0], chunk):
        d2 = pairwise_sqdist(query[s:s + chunk], points)
        if p_mask is not None:
            d2 = torch.where(p_mask[None, :], d2, torch.full_like(d2, _BIG))
        neg, idx = topk_stable(-d2, K)
        ds.append(-neg)
        ids.append(idx)
    d = torch.sqrt(torch.clamp(torch.cat(ds), min=0.0))
    if q_mask is not None:
        d = torch.where(q_mask[:, None], d, torch.full_like(d, _BIG))
    return d, torch.cat(ids)


def gather_padded(x: torch.Tensor, idx: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Rows of x (N, C) by idx (..., K); idx == -1 yields fill rows."""
    N = x.shape[0]
    x_pad = torch.cat([x, torch.full((1,) + x.shape[1:], fill, dtype=x.dtype,
                                     device=x.device)], dim=0)
    return x_pad[torch.where(idx < 0, torch.full_like(idx, N), idx)]
