"""Exact 1-NN argmin, the plain version of the port's ops/cuda_nn.py
(its kernels' arithmetic, without the kernels).

For each query, the index of the nearest valid reference point from
direct squared differences summed over c = 0, 1, 2; ties go to the first
index; masked rows are parked at 1e9 and never win. A leading pair axis
(B problems of one shape) is optional. `nn1_copy_rows_plain` is the
feature transfer's form: the same search, and the winners' rows of a
table in place of the indices.
"""
from __future__ import annotations

import torch

from portref.ops.neighbors import sqdist3

__all__ = ["nn1_argmin_plain", "nn1_copy_rows_plain"]

_FAR = 1e9


def nn1_argmin_plain(queries: torch.Tensor, points: torch.Tensor,
                     p_mask: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """([B,] M) int64 index of the nearest valid point, in the kernel's
    arithmetic (one rounding per operation, first index on ties)."""
    p = torch.where(p_mask[..., None], points.to(torch.float32),
                    torch.full_like(points, _FAR, dtype=torch.float32))
    q = queries.to(torch.float32)
    out = []
    for s in range(0, q.shape[-2], chunk):
        out.append(torch.argmin(sqdist3(q[..., s:s + chunk, :], p), dim=-1))
    return torch.cat(out, dim=-1) if out else torch.zeros(
        q.shape[:-1], dtype=torch.int64, device=q.device)


def nn1_copy_rows_plain(queries: torch.Tensor, q_mask: torch.Tensor,
                        points: torch.Tensor, p_mask: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """The plain version of `nn1_copy_rows`: `nn1_argmin_plain`, then each
    query's winning row of (its pair's) table, a zero row where q_mask is
    false."""
    idx = nn1_argmin_plain(queries, points, p_mask)
    rows = torch.take_along_dim(table, idx[..., None], dim=-2)
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    return torch.where(q_mask[..., None], rows, zero)
