"""Row gather: wrapper of the CUDA kernel csrc/gather_rows.cu and its
plain PyTorch version (port of the Pallas row-gather probe `pg` in
tools/exp_gather2.py, the gather inside ops/neighbors.gather_padded).

out[i] = table[idx[i]], a zero row where idx[i] < 0. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from umeregrobust_tpu_torch.ops import _build

__all__ = ["gather_rows", "gather_rows_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches by gather_rows (not by the plain version)

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
