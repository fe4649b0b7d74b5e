"""Compact voxel codes and the rank join (port of the parts of
umeregrobust_tpu/ops/sortmaps.py that the ResUNetSmall2 geometry uses).

A (b, x, y, z) voxel packs into one code
    (b << 29) | ((x + 512) << 19) | ((y + 512) << 9) | (z + 256),
valid for b <= 2, |x|, |y| < 512 and |z| < 256 fine-voxel units; rows
outside that range, and invalid rows, take a sentinel that sorts after
every valid code. Codes are int64 here (the same values as the JAX
package's int32 codes; int64 keeps the packing of out-of-range rows from
overflowing before they are replaced by the sentinel).
"""
from __future__ import annotations

import torch

__all__ = ["KEY_SENTINEL", "QUERY_SENTINEL", "pack_code", "sorted_join_rank",
           "COMPACT_BX", "COMPACT_BZ"]

KEY_SENTINEL = 0x7FFFFFF0
QUERY_SENTINEL = 0x7FFFFF00
COMPACT_BX = 512
COMPACT_BZ = 256


def pack_code(c: torch.Tensor, valid: torch.Tensor, sentinel: int) -> torch.Tensor:
    """(..., 4) int coords -> (...) int64 codes; out-of-range or invalid
    rows -> sentinel."""
    c = c.to(torch.int64)
    b, x, y, z = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    ok = (valid & (b >= 0) & (b <= 2)
          & (x >= -COMPACT_BX) & (x < COMPACT_BX)
          & (y >= -COMPACT_BX) & (y < COMPACT_BX)
          & (z >= -COMPACT_BZ) & (z < COMPACT_BZ))
    code = ((b << 29) | ((x + COMPACT_BX) << 19) | ((y + COMPACT_BX) << 9)
            | (z + COMPACT_BZ))
    return torch.where(ok, code, torch.full_like(code, sentinel))


def sorted_join_rank(key_code: torch.Tensor, q_code: torch.Tensor) -> torch.Tensor:
    """For every query, the index of the LAST key with code <= the query's
    code (-1 if none). Precondition: key codes sorted ascending (valid
    prefix, KEY_SENTINEL padding). Invalid queries (QUERY_SENTINEL) get the
    last valid rank; callers mask them by comparing window codes."""
    return torch.searchsorted(key_code, q_code, right=True) - 1
