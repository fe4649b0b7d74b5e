"""First-K ball query: wrapper of the CUDA kernel csrc/ball_query.cu.

For each query, the first K valid point indices in ascending index order
whose squared distance |q|^2 + |p|^2 - 2 q.p (fp32, clamped at 0) is <=
radius^2 (fp32), -1 padded; a query with q_mask false gets a row of -1.
This is `ops.neighbors.ball_query`'s contract: on a CPU tensor that
function runs its plain version (`ball_query_plain`, the chunked distance
tiles and top-k), on a CUDA tensor this kernel, which makes the same
radius decisions (|q|^2 and |p|^2 come in computed by the plain version's
expression, the dot product is the fp32 GEMM's chain of fused
multiply-adds). A leading pair axis is optional and costs no extra launch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from umeregrobust_tpu_torch.ops import _build

__all__ = ["ball_query", "radius_sq", "forced_cases", "LAUNCHES",
           "QUERIES_PER_BLOCK", "TILE"]

LAUNCHES = 0  # kernel launches by ball_query

# the kernel's shape (csrc/ball_query.cu kWarps, kTile)
QUERIES_PER_BLOCK = 16  # a warp a query
TILE = 1024  # points a block stages in shared memory a pass


def radius_sq(radius: float) -> float:
    """fp32(radius)^2 rounded to fp32, as the plain version forms it."""
    return float(torch.tensor(float(radius), dtype=torch.float32) ** 2)


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    # pairwise_sqdist's |x|^2, the same expression
    return torch.sum(x * x, dim=-1)


def ball_query(query: torch.Tensor, points: torch.Tensor, radius: float,
               K: int, q_mask: Optional[torch.Tensor] = None,
               p_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """([B,] M, K) int64: the first K in-radius valid point indices of each
    query, -1 padded. query ([B,] M, 3), points ([B,] N, 3) (cast to f32),
    q_mask ([B,] M) / p_mask ([B,] N) bool or None (all valid); with a
    leading pair axis B, pair b's queries search pair b's points, all pairs
    in one launch. CUDA tensors only; 1 <= K <= N."""
    global LAUNCHES
    dev = query.device
    lib = _build.load_library()  # cached; raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"ball_query's kernel runs on CUDA tensors, not "
                         f"{dev}")
    lead = tuple(query.shape[:-2])
    if len(lead) > 1:
        raise ValueError("ball_query takes at most one leading pair axis, "
                         f"got queries of shape {tuple(query.shape)}")
    B = lead[0] if lead else 1
    M, N = query.shape[-2], points.shape[-2]
    query = query.to(torch.float32).contiguous()
    points = points.to(torch.float32).contiguous()
    _build.require(query, "query", torch.float32, lead + (None, 3), dev)
    _build.require(points, "points", torch.float32, lead + (None, 3), dev)
    for name, m, n in (("q_mask", q_mask, M), ("p_mask", p_mask, N)):
        if m is not None:
            _build.require(m, name, torch.bool, lead + (n,), dev)
    if not 1 <= K <= N or max(M, N) >= 2 ** 31 or not 1 <= B <= 65535:
        raise ValueError(f"ball_query takes 1 <= K <= N < 2^31, M < 2^31 "
                         f"and 1 <= B <= 65535 pairs, got K={K}, M={M}, "
                         f"N={N}, B={B}")
    out = torch.empty(lead + (M, K), dtype=torch.int64, device=dev)
    if M == 0:
        return out
    qq, pp = _sq_norms(query), _sq_norms(points)
    code = lib.umr_ball_query(
        query.data_ptr(), qq.data_ptr(),
        None if q_mask is None else q_mask.data_ptr(), points.data_ptr(),
        pp.data_ptr(), None if p_mask is None else p_mask.data_ptr(),
        out.data_ptr(), B, M, N, K, radius_sq(radius),
        _build.stream_of(dev))
    _build.check(lib, code, "ball_query")
    LAUNCHES += 1
    return out


Case = Tuple[np.ndarray, np.ndarray, float, int, Optional[np.ndarray],
             Optional[np.ndarray]]


def forced_cases() -> Dict[str, Case]:
    """Inputs (query (M, 3) f32, points (N, 3) f32, radius, K, q_mask (M,)
    bool or None, p_mask (N,) bool or None) that drive the kernel's edges
    (TILE points a block stages, 32 a ballot, QUERIES_PER_BLOCK queries a
    block): a squared distance equal to radius^2; the K-th hit across a
    ballot boundary, a tile boundary and within a ballot, masked points
    among the hits; fewer than K hits and none; every point masked;
    invalid queries; duplicate points; K = 1; K = N. Coordinates are
    multiples of 1/4 under 200 and radii^2 exact, so every squared
    distance is exact in fp32 in any order of operations and a decision
    on the radius is the same in every implementation."""
    rng = np.random.default_rng(23)

    def far(n):  # points in no query's radius: a block around (150, 150, 150)
        return (150.0 + rng.integers(-64, 64, (n, 3)) / 4.0).astype(
            np.float32)

    def near(c, n, reach):  # n points within `reach` quarter steps of c
        # on each axis (reach 2: all within 1 of c)
        return (np.asarray(c, np.float32)
                + rng.integers(-reach, reach + 1, (n, 3)) / 4.0).astype(
                    np.float32)

    def centres(m):  # query centres 12 apart on a line
        return np.stack([np.arange(m) * 12.0 - 60.0, np.full(m, 4.0),
                         np.full(m, -8.0)], 1).astype(np.float32)

    cases = {}
    # on the sphere: |v|^2 = 25 exactly (in), then two inside, two at 25 +
    # 1/16 (out); 8 candidates a query, capped at K = 6
    q = centres(10)
    on = np.array([(3, 4, 0), (0, -3, 4), (5, 0, 0), (-4, 0, 3), (0, 0, -5),
                   (0, 3, 4), (3, 3.75, 1.25), (0, 4.75, -1.5),
                   (3, 4, 0.25), (4.75, 1.5, 0.5)], np.float32)
    sq = (on.astype(np.float64) ** 2).sum(1)
    assert np.all(sq[:6] == 25.0) and np.all(sq[6:8] < 25.0)
    assert np.all(sq[8:] == 25.0625)
    p = far(1500)
    slots = rng.permutation(1500)[:len(q) * len(on)].reshape(len(q), -1)
    for i, c in enumerate(q):
        p[slots[i]] = c + on
    cases["d2_equals_r2"] = (q, p, 5.0, 6, None, None)

    # K = 40 over 4000 points (ragged last tile): hit runs placed by index
    N, K = 4000, 40
    runs = [np.arange(1000, 1100),  # K-th at 1039: across tile 1024
            np.arange(10, 430, 7),  # K-th at 283: across many ballots
            np.arange(2040, 2101),  # K-th at 2079: tile 2048, mid-ballot
            np.arange(3990, 4000),  # 10 hits at the ragged end
            2400 + 33 * np.arange(20),  # one hit a ballot, 20 < K
            np.arange(3100, 3200)]  # K-th at 3139: inside a ballot
    q = centres(len(runs) + 1)  # the last query has no hit
    p = far(N)
    for c, idx in zip(q, runs):
        p[idx] = near(c, len(idx), 2)
    pm = np.ones(N, bool)
    pm[[1010, 1011, 1030, 2047, 2048, 3120]] = False  # masked among hits
    cases["more_than_K_across_ballot_and_tile"] = (q, p, 1.0, K, None, pm)

    # fewer than K, exactly K, K + 1, none
    N, K = 2500, 40
    counts = [7, 0, 39, 40, 41, 1]
    q = centres(len(counts))
    p = far(N)
    free = rng.permutation(N)
    at = 0
    for c, m in zip(q, counts):
        p[np.sort(free[at:at + m])] = near(c, m, 2)
        at += m
    cases["fewer_than_K_and_none"] = (q, p, 1.0, K, None, None)

    q = near((0, 0, 0), 20, 40)
    p = near((0, 0, 0), 3000, 40)
    cases["all_points_masked"] = (q, p, 2.0, 16, None, np.zeros(3000, bool))

    # invalid queries among valid ones, M ragged against a block's queries
    q = near((0, 0, 0), 2 * QUERIES_PER_BLOCK + 5, 24)
    p = near((0, 0, 0), 2600, 24)
    qm = np.arange(len(q)) % 3 != 1
    qm[:QUERIES_PER_BLOCK] = False  # a whole block of invalid queries
    cases["invalid_queries"] = (q, p, 1.5, 16, qm, rng.random(2600) < 0.9)

    # duplicates: one point 70 times over two tiles, in a radius of 0
    # around it and of 1 around a neighbour
    p = far(2200)
    dup = np.concatenate([np.arange(5, 25), np.arange(1000, 1050)])
    p[dup] = (1.25, -2.5, 0.75)
    p[1100:1110] = near((1.25, -2.5, 0.75), 10, 2)
    q = np.array([(1.25, -2.5, 0.75), (1.5, -2.5, 0.75), (1.25, -2.5, 0.75)],
                 np.float32)
    cases["duplicate_points"] = (q, p, 1.0, 32, None, None)
    p0 = p.copy()
    cases["duplicate_points_radius_0"] = (q, p0, 0.0, 32, None, None)

    # K = 1: the first hit, masks on both sides
    q = near((0, 0, 0), 300, 60)
    p = near((0, 0, 0), 5000, 60)
    cases["K1"] = (q, p, 1.5, 1, rng.random(300) < 0.8,
                   rng.random(5000) < 0.7)

    # K = N: every valid point in radius of some queries
    q = near((0, 0, 0), 20, 8)
    p = near((0, 0, 0), 100, 8)
    cases["K_equals_N"] = (q, p, 100.0, 100, None, rng.random(100) < 0.95)
    return cases
