"""Compact voxel codes and the sorted joins behind the kernel maps
(port of umeregrobust_tpu/ops/sortmaps.py).

A (b, x, y, z) voxel packs into one code
    (b << 29) | ((x + 512) << 19) | ((y + 512) << 9) | (z + 256),
valid for 0 <= b < MAX_CLOUDS, |x|, |y| < 512 and |z| < 256 fine-voxel
units; rows outside that range, and invalid rows, take a sentinel that
sorts after every valid code. Codes are int64 here: the same values as the
JAX package's int32 codes for b <= 2, and room for the 2B clouds of a
batch of B pairs in one pyramid (the JAX package's int32 codes stop at
b = 2, one pair). The sentinels keep the JAX package's low 31 bits under
a high bit above every valid code.

Joins are a `torch.sort` (where the keys are not sorted yet) plus one
`torch.searchsorted`; the results are integer rows, equal to the JAX
package's sort-merge joins.
"""
from __future__ import annotations

import torch

__all__ = ["KEY_SENTINEL", "QUERY_SENTINEL", "pack_code", "sorted_join_rank",
           "sorted_join_code", "pack_coords", "batched_sorted_lookup",
           "COMPACT_BX", "COMPACT_BZ", "MAX_CLOUDS", "SENTINEL_HIGH"]

MAX_CLOUDS = 1 << 24  # batch indices a code holds (b < MAX_CLOUDS)
SENTINEL_HIGH = 1 << 56  # above every valid code (< MAX_CLOUDS << 29)
KEY_SENTINEL = SENTINEL_HIGH | 0x7FFFFFF0
QUERY_SENTINEL = SENTINEL_HIGH | 0x7FFFFF00
COMPACT_BX = 512
COMPACT_BZ = 256


def pack_code(c: torch.Tensor, valid: torch.Tensor, sentinel: int) -> torch.Tensor:
    """(..., 4) int coords -> (...) int64 codes; out-of-range or invalid
    rows -> sentinel."""
    c = c.to(torch.int64)
    b, x, y, z = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    ok = (valid & (b >= 0) & (b < MAX_CLOUDS)
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


def sorted_join_code(key_code: torch.Tensor, q_code: torch.Tensor) -> torch.Tensor:
    """Exact-match join: for every query, the row of the key with the same
    code, -1 if there is none. Same precondition as `sorted_join_rank`
    (keys sorted ascending, unique among valid rows, invalid keys at
    KEY_SENTINEL, invalid queries at QUERY_SENTINEL: the two sentinels
    differ, so they never match)."""
    rank = sorted_join_rank(key_code, q_code)
    safe = torch.clamp(rank, min=0)
    hit = (rank >= 0) & (key_code[safe] == q_code)
    return torch.where(hit, rank, torch.full_like(rank, -1))


def pack_coords(c: torch.Tensor, valid: torch.Tensor, sentinel: int) -> torch.Tensor:
    """(..., 4) int coords -> (...) int64 wide code, the JAX package's
    (hi, lo) word pair in one word: b < 127, |x| < 2^23, |y|, |z| < 2^15;
    invalid rows -> the sentinel's low 32 bits in both halves."""
    c = c.to(torch.int64)
    hi = (c[..., 0] << 24) | ((c[..., 1] + (1 << 23)) & 0xFFFFFF)
    lo = (((c[..., 2] + (1 << 15)) & 0xFFFF) << 16) | (
        (c[..., 3] + (1 << 15)) & 0xFFFF)
    code = (hi << 32) | lo
    low = sentinel & 0xFFFFFFFF
    return torch.where(valid, code, torch.full_like(code, (low << 32) | low))


def batched_sorted_lookup(key_coords: torch.Tensor, key_mask: torch.Tensor,
                          query_coords: torch.Tensor, query_mask: torch.Tensor
                          ) -> torch.Tensor:
    """Row index into key_coords (N, 4) for every query (M, 4), -1 if
    absent or invalid. The keys may be in any order (the generic join
    behind build_self_map / build_conv_map / build_transpose_map); among
    duplicate keys the highest row wins, as in the JAX package."""
    k_code, k_row = torch.sort(pack_coords(key_coords, key_mask, KEY_SENTINEL),
                               stable=True)
    q_code = pack_coords(query_coords, query_mask, QUERY_SENTINEL)
    pos = torch.searchsorted(k_code, q_code, right=True) - 1
    safe = torch.clamp(pos, min=0)
    hit = (pos >= 0) & (k_code[safe] == q_code)
    return torch.where(hit, k_row[safe], torch.full_like(pos, -1))
