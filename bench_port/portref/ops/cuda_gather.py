"""Row gather, the plain version of the port's ops/cuda_gather.py (the
gather inside ops/neighbors.gather_padded).

out[i] = table[idx[i]], a zero row where idx[i] < 0. Its backward
scatter-adds the output's cotangent into the table's rows
(`gather_rows_backward_plain`); `GatherRows` is the autograd function of
the pair.
"""
from __future__ import annotations

import torch

__all__ = ["gather_rows_plain", "gather_rows_backward_plain", "GatherRows"]


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor,
                      fill: float = 0.0) -> torch.Tensor:
    """Rows of table (N, ...) by idx (any shape); an index outside [0, N)
    yields a `fill` row, as in the kernel. Returns idx.shape +
    table.shape[1:]."""
    N = table.shape[0]
    pad = torch.full((1,) + table.shape[1:], fill, dtype=table.dtype,
                     device=table.device)
    safe = torch.where((idx < 0) | (idx >= N), torch.full_like(idx, N), idx)
    return torch.cat([table, pad], dim=0)[safe.to(torch.int64)]


def gather_rows_backward_plain(dout: torch.Tensor, idx: torch.Tensor,
                               n_rows: int) -> torch.Tensor:
    """(n_rows, C) fp32: row r the sum of dout's rows i with idx[i] == r
    (index_add_: on the CPU in ascending i); indices outside [0, n_rows)
    add nothing."""
    idx = idx.reshape(-1).to(torch.int64)
    dout = dout.reshape(idx.shape[0], -1).to(torch.float32)
    ok = (idx >= 0) & (idx < n_rows)
    out = torch.zeros((n_rows, dout.shape[1]), dtype=torch.float32,
                      device=dout.device)
    return out.index_add_(0, idx[ok], dout[ok])


class GatherRows(torch.autograd.Function):
    """table (N, C), idx (M,) -> (M, C) by gather_rows_plain, with
    gather_rows_backward_plain as its backward (fp32 tables; no gradient
    to the indices)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return gather_rows_plain(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        return gather_rows_backward_plain(g.to(torch.float32).contiguous(),
                                          idx, ctx.n_rows), None
