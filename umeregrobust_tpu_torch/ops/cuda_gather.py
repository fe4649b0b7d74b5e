"""Row gather: wrapper of the CUDA kernel csrc/gather_rows.cu and its
plain PyTorch version (port of the Pallas row-gather probe `pg` in
tools/exp_gather2.py, the gather inside ops/neighbors.gather_padded).

out[i] = table[idx[i]], a zero row where idx[i] < 0. Its backward,
`gather_rows_backward`, scatter-adds the output's cotangent into the
table's rows in a fixed order (kernel in the same source); `GatherRows`
is the autograd function of the pair. On a CPU tensor each wrapper runs
its plain version; on a CUDA tensor it launches its kernel or raises.
"""
from __future__ import annotations

import torch

from umeregrobust_tpu_torch.ops import _build

__all__ = ["gather_rows", "gather_rows_plain", "gather_rows_backward",
           "gather_rows_backward_plain", "GatherRows", "LAUNCHES",
           "LAUNCHES_BACKWARD"]

LAUNCHES = 0  # kernel launches by gather_rows (not by the plain version)
LAUNCHES_BACKWARD = 0  # kernel launches by gather_rows_backward

_DTYPES = (torch.float32, torch.bfloat16)
_INDEX_DTYPES = (torch.int32, torch.int64)


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


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (N, C) fp32 or bf16, idx (M,) int32 or int64 -> (M, C);
    idx < 0 yields a zero row. On the card an index >= N also yields a
    zero row (the kernel reads nothing out of bounds); the plain version
    raises for one."""
    global LAUNCHES
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    dev = table.device
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"gather_rows runs on CUDA or CPU tensors, not {dev}")
    if table.dtype not in _DTYPES:
        raise ValueError(f"table: expected fp32 or bf16, got {table.dtype}")
    if idx.dtype not in _INDEX_DTYPES:
        raise ValueError(f"idx: expected int32 or int64, got {idx.dtype}")
    _build.require(table, "table", table.dtype, (None, None), dev)
    _build.require(idx, "idx", idx.dtype, (None,), dev)
    N, C = table.shape
    M = idx.shape[0]
    if C < 1 or max(M, N) >= 2 ** 31:
        raise ValueError(f"gather_rows: unsupported size M={M}, N={N}, C={C}")
    out = torch.empty((M, C), dtype=table.dtype, device=dev)
    if M == 0:
        return out
    row_bytes = C * table.element_size()
    vec16 = (row_bytes % 16 == 0 and table.data_ptr() % 16 == 0
             and out.data_ptr() % 16 == 0)
    code = lib.umr_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), M, N, C,
        table.element_size(), int(idx.dtype == torch.int64), int(vec16),
        _build.stream_of(dev))
    _build.check(lib, code, "gather_rows")
    LAUNCHES += 1
    return out


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


def gather_rows_backward(dout: torch.Tensor, idx: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """The cotangent of a row gather's table: dout (M, C) fp32, idx (M,)
    int32 / int64 -> (n_rows, C) fp32. On the card: the indices sorted
    once (stable), each row's segment of them found, then the kernel (a
    warp a row, its cotangents added in ascending position: the bits of
    the plain version on the CPU)."""
    global LAUNCHES_BACKWARD
    if dout.device.type == "cpu":
        return gather_rows_backward_plain(dout, idx, n_rows)
    dev = dout.device
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"gather_rows_backward runs on CUDA or CPU tensors, "
                         f"not {dev}")
    if idx.dtype not in _INDEX_DTYPES:
        raise ValueError(f"idx: expected int32 or int64, got {idx.dtype}")
    _build.require(dout, "dout", torch.float32, (None, None), dev)
    _build.require(idx, "idx", idx.dtype, (dout.shape[0],), dev)
    M, C = dout.shape
    if C < 1 or max(M, n_rows) >= 2 ** 31:
        raise ValueError(f"gather_rows_backward: unsupported size M={M}, "
                         f"N={n_rows}, C={C}")
    out = torch.empty((n_rows, C), dtype=torch.float32, device=dev)
    if n_rows == 0:
        return out
    key = idx.to(torch.int64)
    key = torch.where((key >= 0) & (key < n_rows), key,
                      torch.full_like(key, n_rows))
    sorted_key, perm = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        sorted_key, torch.arange(n_rows + 1, dtype=torch.int64, device=dev))
    code = lib.umr_gather_rows_backward(
        dout.data_ptr(), perm.data_ptr(), starts.data_ptr(), out.data_ptr(),
        n_rows, C, _build.stream_of(dev))
    _build.check(lib, code, "gather_rows_backward")
    LAUNCHES_BACKWARD += 1
    return out


class GatherRows(torch.autograd.Function):
    """table (N, C), idx (M,) -> (M, C) by gather_rows, with
    gather_rows_backward as its backward (fp32 tables; no gradient to the
    indices)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return gather_rows(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        return gather_rows_backward(g.to(torch.float32).contiguous(), idx,
                                    ctx.n_rows), None
