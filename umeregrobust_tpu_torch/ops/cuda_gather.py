"""Row gather: wrapper of the CUDA kernel csrc/gather_rows.cu and its
plain PyTorch version (port of the Pallas row-gather probe `pg` in
tools/exp_gather2.py, the gather inside ops/neighbors.gather_padded).

out[i] = table[idx[i]], a zero row where idx[i] < 0. Its backward,
`gather_rows_backward`, scatter-adds the output's cotangent into the
table's rows in a fixed order (kernels in the same source: a counting
sort of the positions by row, `row_segments`, then a sum a row);
`GatherRows` is the autograd function of the pair. On a CPU tensor each
wrapper runs its plain version; on a CUDA tensor it launches its kernel
or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from umeregrobust_tpu_torch.ops import _build

__all__ = ["gather_rows", "gather_rows_plain", "gather_rows_backward",
           "gather_rows_backward_plain", "row_segments", "row_segments_plain",
           "segment_scratch", "GatherRows", "LAUNCHES", "LAUNCHES_BACKWARD"]

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


_SCAN_TILE = 4096  # counts a scan block of the row segments (csrc kScanTile)


def segment_scratch(m: int, n_rows: int) -> int:
    """int32 scratch of the row segments (csrc umr_row_segments): counts
    and starts (n_rows + 1 each), a sum per scan tile, the positions and
    their merge twin (m each)."""
    n = n_rows + 1
    return 2 * n + -(-n // _SCAN_TILE) + 2 * m


def row_segments_plain(idx: torch.Tensor, n_rows: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(starts (n_rows + 1,), positions (V,)) int32: the V positions i with
    0 <= idx[i] < n_rows grouped by row, row r's in ascending i at
    positions[starts[r]:starts[r + 1]]. starts from the rows' counts
    (bincount, exclusive cumulative sum), positions by a stable order of
    their rows."""
    idx = idx.reshape(-1).to(torch.int64)
    ok = (idx >= 0) & (idx < n_rows)
    at = torch.nonzero(ok).reshape(-1)
    counts = torch.bincount(idx[ok], minlength=n_rows)
    starts = torch.zeros(n_rows + 1, dtype=torch.int64, device=idx.device)
    starts[1:] = torch.cumsum(counts, 0)
    order = torch.argsort(idx[ok], stable=True)
    return starts.to(torch.int32), at[order].to(torch.int32)


def _segments_checked(idx, n_rows, name):
    dev = idx.device
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {dev}")
    if idx.dtype not in _INDEX_DTYPES:
        raise ValueError(f"idx: expected int32 or int64, got {idx.dtype}")
    _build.require(idx, "idx", idx.dtype, (None,), dev)
    if n_rows < 1 or max(idx.shape[0], n_rows) >= 2 ** 31 - 1:
        raise ValueError(f"{name}: unsupported size M={idx.shape[0]}, "
                         f"N={n_rows}")
    ints = torch.empty(segment_scratch(idx.shape[0], n_rows),
                       dtype=torch.int32, device=dev)
    return lib, ints


def row_segments(idx: torch.Tensor, n_rows: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """row_segments_plain's (starts, positions); on a CUDA tensor by the
    counting sort gather_rows_backward starts with (count, scan, place,
    sort each segment; no library sort). A check of those kernels: it
    counts no launch and reads starts[n_rows] back to size positions."""
    if idx.device.type == "cpu":
        return row_segments_plain(idx, n_rows)
    lib, ints = _segments_checked(idx, n_rows, "row_segments")
    code = lib.umr_row_segments(idx.data_ptr(), ints.data_ptr(),
                                idx.shape[0], n_rows,
                                int(idx.dtype == torch.int64),
                                _build.stream_of(idx.device))
    _build.check(lib, code, "row_segments")
    n = n_rows + 1
    starts = ints[n: 2 * n]
    at = 2 * n + -(-n // _SCAN_TILE)
    return starts, ints[at: at + int(starts[-1])]


def gather_rows_backward(dout: torch.Tensor, idx: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """The cotangent of a row gather's table: dout (M, C) fp32, idx (M,)
    int32 / int64 -> (n_rows, C) fp32. On the card one C call: the row
    segments (counting sort over [0, n_rows) in int32: a count, a scan
    that gives each row's start, a placement, a warp sorting its 32
    rows' segments in turn), then G lanes a row adding its cotangents in
    ascending position, as 16-byte pieces where C * 4 allows: the bits of
    the plain version on the CPU, with no float atomics and no library
    sort."""
    global LAUNCHES_BACKWARD
    if dout.device.type == "cpu":
        return gather_rows_backward_plain(dout, idx, n_rows)
    dev = dout.device
    if n_rows == 0:
        _build.load_library()  # raises if it cannot be built
        return torch.empty((0,) + tuple(dout.shape[1:]), dtype=torch.float32,
                           device=dev)
    lib, ints = _segments_checked(idx, n_rows, "gather_rows_backward")
    _build.require(dout, "dout", torch.float32, (None, None), dev)
    _build.require(idx, "idx", idx.dtype, (dout.shape[0],), dev)
    M, C = dout.shape
    if C < 1:
        raise ValueError(f"gather_rows_backward: unsupported C={C}")
    out = torch.empty((n_rows, C), dtype=torch.float32, device=dev)
    vec16 = (C % 4 == 0 and dout.data_ptr() % 16 == 0
             and out.data_ptr() % 16 == 0)
    code = lib.umr_gather_rows_backward(
        dout.data_ptr(), idx.data_ptr(), ints.data_ptr(), out.data_ptr(), M,
        n_rows, C, int(idx.dtype == torch.int64), int(vec16),
        _build.stream_of(dev))
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
