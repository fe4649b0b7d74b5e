"""Fixed-shape neighbor search (port of umeregrobust_tpu/ops/neighbors.py):
pairwise squared distances, the padded ball query, kNN and the -1-padded
gather."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from umeregrobust_tpu_torch.ops.cuda_gather import (
    GatherRows, gather_rows_plain)

__all__ = ["pairwise_sqdist", "sqdist3", "ball_query", "knn", "gather_padded", "topk_stable",
           "take_rows"]

_BIG = 1e30


def pairwise_sqdist(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """([B,] M, N) squared distances as |q|^2 + |p|^2 - 2 q.p, clamped at
    0 (q ([B,] M, 3), p ([B,] N, 3))."""
    q = q.to(torch.float32)
    p = p.to(torch.float32)
    qq = torch.sum(q * q, dim=-1)
    pp = torch.sum(p * p, dim=-1)
    return torch.clamp(qq[..., :, None] + pp[..., None, :]
                       - 2.0 * (q @ p.transpose(-1, -2)), min=0.0)


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


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx, :] per leading index: x (*L, N, *R), idx (*L, K) int64
    in [0, N) -> (*L, K, *R) (plain indexing when L is empty, else one
    gather)."""
    lead = idx.shape[:-1]
    if not lead:
        return x[idx]
    rest = tuple(x.shape[len(lead) + 1:])
    full = idx.reshape(tuple(idx.shape) + (1,) * len(rest)).expand(
        tuple(idx.shape) + rest)
    return torch.gather(x, len(lead), full)


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim with ties broken toward the LOWER index
    (jax.lax.top_k's order; torch.topk promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def ball_query(
    query: torch.Tensor,
    points: torch.Tensor,
    radius: float,
    K: int,
    q_mask: Optional[torch.Tensor] = None,
    p_mask: Optional[torch.Tensor] = None,
    chunk: int = 256,
) -> torch.Tensor:
    """(M, K) int64 indices into points (N, 3) of the FIRST K points, in
    index order, whose squared distance (pairwise_sqdist) to the query is
    <= radius^2 (fp32), -1 padded (PyTorch3D's ball_query semantics).
    Invalid points (p_mask False) never match; invalid queries (q_mask
    False) get a row of -1. Queries go `chunk` at a time; K <= N."""
    N = points.shape[0]
    r2 = torch.tensor(float(radius), dtype=torch.float32) ** 2
    col = torch.arange(N, dtype=torch.int32, device=points.device)
    out = []
    for s in range(0, query.shape[0], chunk):
        ok = pairwise_sqdist(query[s:s + chunk], points) <= r2.to(points.device)
        if p_mask is not None:
            ok = ok & p_mask[None, :]
        # the K smallest scores are the first K in-radius indices; scores
        # are distinct but for the out-of-radius sentinel
        score = torch.where(ok, col, torch.full_like(col, N + 1))
        idx = -torch.topk(-score, K, dim=-1, sorted=True).values
        out.append(torch.where(idx > N, torch.full_like(idx, -1), idx))
    if not out:
        return torch.empty((0, K), dtype=torch.int64, device=points.device)
    idx = torch.cat(out).to(torch.int64)
    if q_mask is not None:
        idx = torch.where(q_mask[:, None], idx, torch.full_like(idx, -1))
    return idx


def knn(
    query: torch.Tensor,
    points: torch.Tensor,
    K: int,
    q_mask: Optional[torch.Tensor] = None,
    p_mask: Optional[torch.Tensor] = None,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest neighbors sorted ascending: (dists ([B,] M, K), idx ([B,]
    M, K) int64), over an optional leading pair axis. Invalid points sit at
    +1e30 squared distance."""
    ds, ids = [], []
    for s in range(0, query.shape[-2], chunk):
        d2 = pairwise_sqdist(query[..., s:s + chunk, :], points)
        if p_mask is not None:
            d2 = torch.where(p_mask[..., None, :], d2,
                             torch.full_like(d2, _BIG))
        neg, idx = topk_stable(-d2, K)
        ds.append(-neg)
        ids.append(idx)
    d = torch.sqrt(torch.clamp(torch.cat(ds, dim=-2), min=0.0))
    if q_mask is not None:
        d = torch.where(q_mask[..., None], d, torch.full_like(d, _BIG))
    return d, torch.cat(ids, dim=-2)


def gather_padded(x: torch.Tensor, idx: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Rows of x (N, C) by idx (..., K); idx == -1 yields fill rows. With a
    leading pair axis, x (B, N, C) and idx (B, ..., K) take pair b's rows
    for pair b's indices, as one gather over the flattened (B N, C) table.
    With fill 0 the gather is `GatherRows` (differentiable in the table):
    on a CPU tensor the plain versions, on a CUDA fp32 or bf16 table the
    gather_rows kernel and, for a gradient, its backward kernel. Another
    fill takes the plain version on the CPU; any other CUDA input
    raises."""
    if x.dim() == 3:
        B, N = x.shape[:2]
        if B > 1:  # one pair's indices need no offset (>= N gives fill)
            base = (torch.arange(B, device=idx.device) * N).reshape(
                (B,) + (1,) * (idx.dim() - 1))
            idx = torch.where((idx >= 0) & (idx < N), idx + base,
                              torch.full_like(idx, -1))
        x = x.reshape(B * N, x.shape[2])
    if x.device.type == "cpu" and (fill != 0.0 or x.dim() != 2):
        return gather_rows_plain(x, idx, fill)
    if fill != 0.0 or x.dim() != 2:
        raise ValueError("gather_padded on the card takes a 2-D table and "
                         f"fill 0, got shape {tuple(x.shape)}, fill {fill}")
    out = GatherRows.apply(x.contiguous(), idx.reshape(-1).contiguous())
    return out.reshape(*idx.shape, x.shape[1])
