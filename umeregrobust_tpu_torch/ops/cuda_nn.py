"""Exact 1-NN argmin: wrapper of the CUDA kernel csrc/nn1_argmin.cu and
its plain PyTorch version (port of umeregrobust_tpu/ops/pallas_nn.py).

For each query, the index of the nearest valid reference point from
direct squared differences summed over c = 0, 1, 2; ties go to the first
index; masked rows are parked at 1e9 and never win. A leading pair axis
(B problems of one shape) is optional and costs no extra launch. On a CPU
tensor the wrapper runs the plain version; on a CUDA tensor it launches
the kernel or raises. `nn1_copy_rows` is the feature transfer's form: the
same search, and the winners' rows of a table copied by the kernel's
merge in place of the indices.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from umeregrobust_tpu_torch.ops import _build
from umeregrobust_tpu_torch.ops.neighbors import sqdist3

__all__ = ["nn1_argmin", "nn1_argmin_plain", "nn1_copy_rows",
           "nn1_copy_rows_plain", "launch_plan", "forced_cases", "LAUNCHES",
           "LAUNCHES_COPY", "QUERIES_PER_BLOCK", "TILE", "STEP"]

# calls that launched the kernels (nn1_argmin and nn1_copy_rows, 2 launches
# each), and of those the nn1_copy_rows calls (the merge's row copy)
LAUNCHES = 0
LAUNCHES_COPY = 0

# the kernel's shape (csrc/nn1_argmin.cu kThreads x kQ, kTile, kStep)
QUERIES_PER_BLOCK = 128 * 4  # a block's queries: 128 threads, 4 each
TILE = 512  # targets a block stages in shared memory a pass
STEP = 4  # targets a step of the sweep; segments are whole steps
_BLOCKS_PER_SM = 2  # the grid aims at this many blocks an SM, one wave

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


def launch_plan(M: int, N: int, sms: int, B: int = 1
                ) -> Tuple[int, int, int]:
    """(query tiles, segments S, segment length) of one call over B pairs:
    each pair's targets are cut into S segments of whole steps so that B x
    query tiles x S is about two blocks on each of `sms` SMs."""
    tiles = max(1, -(-M // QUERIES_PER_BLOCK))
    S = max(1, min(-(-_BLOCKS_PER_SM * sms // (tiles * B)), -(-N // STEP)))
    seg = -(-N // S)
    seg = -(-seg // STEP) * STEP
    return tiles, -(-N // seg), seg


def nn1_argmin(queries: torch.Tensor, points: torch.Tensor,
               p_mask: torch.Tensor) -> torch.Tensor:
    """Index of the nearest valid reference point per query: ([B,] M)
    int64. queries ([B,] M, 3) f32, points ([B,] N, 3) f32, p_mask ([B,] N)
    bool; with a leading pair axis B, pair b's queries search pair b's
    points, all pairs in one launch."""
    global LAUNCHES
    if queries.device.type == "cpu":
        return nn1_argmin_plain(queries, points, p_mask)
    dev = queries.device
    lib = _build.load_library()  # cached; raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"nn1_argmin runs on CUDA or CPU tensors, not {dev}")
    lead = tuple(queries.shape[:-2])
    if len(lead) > 1:
        raise ValueError("nn1_argmin takes at most one leading pair axis, "
                         f"got queries of shape {tuple(queries.shape)}")
    B = lead[0] if lead else 1
    M, N = queries.shape[-2], points.shape[-2]
    _build.require(queries, "queries", torch.float32, lead + (None, 3), dev)
    _build.require(points, "points", torch.float32, lead + (None, 3), dev)
    _build.require(p_mask, "p_mask", torch.bool, lead + (N,), dev)
    if N == 0 or max(M, N) >= 2 ** 31 or not 1 <= B <= 65535:
        raise ValueError(f"nn1_argmin takes 1 <= N < 2^31 reference points, "
                         f"M < 2^31 queries and 1 <= B <= 65535 pairs, got "
                         f"M={M}, N={N}, B={B}")
    out = torch.empty(lead + (M,), dtype=torch.int64, device=dev)
    if M == 0:
        return out
    # get_device_properties reads the device once and keeps it
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, S, seg = launch_plan(M, N, sms, B)
    scratch = torch.empty(2 * B * S * M, dtype=torch.int32, device=dev)
    code = lib.umr_nn1_argmin(
        queries.data_ptr(), points.data_ptr(), p_mask.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), B, M, N, S, seg,
        _build.stream_of(dev))
    _build.check(lib, code, "nn1_argmin")
    LAUNCHES += 1
    return out


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


def nn1_copy_rows(queries: torch.Tensor, q_mask: torch.Tensor,
                  points: torch.Tensor, p_mask: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
    """The feature transfer: ([B,] M, C), row m the row of `table` ([B,] N,
    C) f32 at the nearest valid point of query m (`nn1_argmin`), a zero
    row where q_mask ([B,] M) bool is false; with a leading pair axis pair
    b's queries search pair b's points and read pair b's table. On CUDA
    tensors the nn1_argmin kernels, the rows copied by the merge kernel
    (two launches for the batch; the table may be a strided view whose
    rows are contiguous), counted in LAUNCHES and LAUNCHES_COPY. The copy
    carries no gradient: a table that would take one raises."""
    global LAUNCHES, LAUNCHES_COPY
    if torch.is_grad_enabled() and table.requires_grad:
        raise ValueError("nn1_copy_rows carries no gradient to its table; "
                         "call it under torch.no_grad() or detach the table")
    if queries.device.type == "cpu":
        return nn1_copy_rows_plain(queries, q_mask, points, p_mask, table)
    dev = queries.device
    lib = _build.load_library()  # cached; raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"nn1_copy_rows runs on CUDA or CPU tensors, not "
                         f"{dev}")
    lead = tuple(queries.shape[:-2])
    if len(lead) > 1:
        raise ValueError("nn1_copy_rows takes at most one leading pair axis, "
                         f"got queries of shape {tuple(queries.shape)}")
    B = lead[0] if lead else 1
    M, N = queries.shape[-2], points.shape[-2]
    _build.require(queries, "queries", torch.float32, lead + (None, 3), dev)
    _build.require(q_mask, "q_mask", torch.bool, lead + (M,), dev)
    _build.require(points, "points", torch.float32, lead + (None, 3), dev)
    _build.require(p_mask, "p_mask", torch.bool, lead + (N,), dev)
    C = table.shape[-1] if table.dim() == len(lead) + 2 else 0
    if (table.dtype != torch.float32 or table.device != dev
            or tuple(table.shape) != lead + (N, C) or C == 0
            or table.stride(-1) != 1 or table.stride(-2) < C):
        raise ValueError(f"nn1_copy_rows takes an f32 table {lead + (N,)} x "
                         f"C on {dev} with contiguous rows, got "
                         f"{table.dtype} {tuple(table.shape)} strides "
                         f"{table.stride()} on {table.device}")
    if N == 0 or max(M, N) >= 2 ** 31 or not 1 <= B <= 65535:
        raise ValueError(f"nn1_copy_rows takes 1 <= N < 2^31 reference "
                         f"points, M < 2^31 queries and 1 <= B <= 65535 "
                         f"pairs, got M={M}, N={N}, B={B}")
    out = torch.empty(lead + (M, C), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, S, seg = launch_plan(M, N, sms, B)
    scratch = torch.empty(2 * B * S * M, dtype=torch.int32, device=dev)
    code = lib.umr_nn1_copy_rows(
        queries.data_ptr(), q_mask.data_ptr(), points.data_ptr(),
        p_mask.data_ptr(), table.data_ptr(), table.stride(0) if lead else 0,
        table.stride(-2), C, scratch.data_ptr(), out.data_ptr(), B, M, N, S,
        seg, _build.stream_of(dev))
    _build.check(lib, code, "nn1_copy_rows")
    LAUNCHES += 1
    LAUNCHES_COPY += 1
    return out


def forced_cases(sms: int = 132) -> Dict[str, Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]]:
    """Inputs (queries (M, 3) f32, points (N, 3) f32, mask (N,) bool) that
    drive the kernel's edges on a card of `sms` SMs (launch_plan): equal
    nearest points on both sides of segment boundaries and of shared-memory
    tile boundaries, also with the first of each pair masked; all rows
    masked but the last; all masked (index 0); M = 1; N = 1; N = TILE + 1
    on a single segment; M not a multiple of QUERIES_PER_BLOCK;
    coordinates near 1e4. Coordinates are multiples of 1/8 within 100 of a
    base, so every distance to a valid row is exact in fp32 and equal
    distances are real ties."""
    rng = np.random.default_rng(17)

    def lattice(n, base=0.0):
        return (base + rng.integers(-128, 128, (n, 3)) / 4.0
                ).astype(np.float32)

    def valid(n, share):
        return rng.random(n) < share

    def ties(M, N, bounds, mask_first=False):
        """Equal points at b - 1 and b for each boundary b, apart from the
        rest; query i sits an eighth off the i-th pair (the answer is
        b - 1, or b where the first of the pair is masked)."""
        q, p, m = lattice(M), lattice(N), np.ones(N, bool)
        for i, b in enumerate(bounds):
            p[b - 1] = p[b] = (60.0, 8.0 * i - 40.0, 0.0)
            q[i] = p[b] + np.float32(0.125)
            m[b - 1] = not mask_first
        return q, p, m

    cases = {}
    M, N = 8, 5000  # one query tile: many short segments
    seg = launch_plan(M, N, sms)[2]
    bounds = [seg, 2 * seg, 5 * seg]
    cases["ties_at_segment_boundaries"] = ties(M, N, bounds)
    cases["ties_at_segment_boundaries_first_masked"] = ties(M, N, bounds,
                                                            True)
    M, N = 8, 300_000  # segments longer than a tile
    seg = launch_plan(M, N, sms)[2]
    bounds = [TILE, seg, seg + TILE, 2 * seg]
    cases["ties_at_tile_boundaries"] = ties(M, N, bounds)
    cases["ties_at_tile_boundaries_first_masked"] = ties(M, N, bounds, True)
    p = lattice(3000)
    last = np.zeros(3000, bool)
    last[-1] = True
    cases["all_masked_but_last"] = (lattice(40), p, last)
    cases["all_masked"] = (lattice(40), p, np.zeros(3000, bool))
    cases["M1"] = (lattice(1), lattice(4000), valid(4000, 0.9))
    cases["N1"] = (lattice(300), lattice(1), np.ones(1, bool))
    # enough query tiles that the targets are one segment: a whole tile,
    # then a ragged one
    M = _BLOCKS_PER_SM * sms * QUERIES_PER_BLOCK
    assert launch_plan(M, TILE + 1, sms)[1] == 1
    cases["N_tile_plus_1_one_segment"] = (lattice(M), lattice(TILE + 1),
                                          valid(TILE + 1, 0.9))
    cases["M_ragged"] = (lattice(QUERIES_PER_BLOCK + 37), lattice(6000),
                         valid(6000, 0.8))
    p = lattice(6000, 1e4)
    cases["near_1e4"] = (p[rng.integers(0, 6000, 700)] + np.float32(0.125),
                         p, valid(6000, 0.8))
    return cases
