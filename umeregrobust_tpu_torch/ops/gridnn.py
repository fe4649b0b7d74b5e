"""Grid-bucketed nearest-neighbour search with a bounded radius (port of
umeregrobust_tpu/ops/gridnn.py; the same results, bit for bit).

Points are sorted by voxel cell (cell edge = search radius), a hash table
(ops/hashing) maps cell -> (start, count) into the sorted order, and a
query scans the 27 neighbouring cells with a fixed per-cell candidate
budget. For radius-bounded 1-NN this is exact as long as no cell
overflows the budget; overflowing cells are truncated -- check with
`overflow_count(grid, budget)`.

ICP uses ops/densegrid.py (dense-table addressing, no hash probes); this
is the unbounded-extent index. A grid is built on the card unless the
caller passes device="cpu" (without CUDA the default raises); queries run
where the grid is.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from umeregrobust_tpu_torch.devices import resolve_device, to_device
from umeregrobust_tpu_torch.ops.hashing import (
    HashTable, build_hash_table, lookup)

__all__ = ["GridIndex", "build_grid", "nn_query", "overflow_count"]

QUERY_CHUNK = 4096  # queries a step, as the JAX package's scan takes them
_OFFSETS = [(0, dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


class GridIndex(NamedTuple):
    points: torch.Tensor  # (N, 3) original points
    mask: torch.Tensor  # (N,) validity
    order: torch.Tensor  # (N,) int64: sorted-by-cell permutation of rows
    cell_table: HashTable  # hash of unique cell coords (as (0,x,y,z))
    start: torch.Tensor  # (C,) int32 start of each cell's run in `order`
    count: torch.Tensor  # (C,) int32 run length
    cell: float  # cell edge


def overflow_count(grid: GridIndex, budget: int) -> torch.Tensor:
    """Points beyond `budget` in their cell: the candidates a query with
    this budget can never see. 0 => queries are exact."""
    return torch.sum(torch.clamp(grid.count - budget, min=0))


def _cell_coords(points: torch.Tensor, cell: float) -> torch.Tensor:
    # a divisor on the points' device: a CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds otherwise than x / cell
    c = torch.floor(points / torch.tensor(cell, dtype=points.dtype,
                                          device=points.device))
    c = c.to(torch.int32)
    return torch.cat([torch.zeros_like(c[:, :1]), c], dim=-1)


def _sqdist(q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(M, K) squared distances of q (M, 3) to cand (M, K, 3), formed as
    the JAX package's program forms them on the CPU, where XLA contracts
    the sum of squares into fused multiply-adds: fma(d2, d2, fma(d1, d1,
    d0 * d0)), d = q - cand. Each fma is a float64 product of two float32
    values (exact) plus a float32, rounded once to float32 (a second,
    float64 rounding first can differ only at an exact float64 tie). Both
    devices give the same bits."""
    d = q[:, None, :] - cand
    s = d[..., 0] * d[..., 0]
    for c in (1, 2):
        dc = d[..., c].to(torch.float64)
        s = (dc * dc + s.to(torch.float64)).to(torch.float32)
    return s


def build_grid(points, mask, cell: float, max_cells: Optional[int] = None,
               device="cuda") -> GridIndex:
    """Index `points` (N, 3) f32 (mask (N,)) on `device` for
    radius-bounded NN with search radius <= cell."""
    dev = resolve_device(device)
    points = to_device(points, dev, torch.float32)
    mask = to_device(mask, dev, torch.bool)
    N = points.shape[0]
    if max_cells is None:
        max_cells = N
    cc = _cell_coords(points, cell)
    canon = lookup(build_hash_table(cc, mask, device=dev), cc,
                   mask)  # a row per cell
    # sort rows by canonical cell row id (invalid rows -> end); stable, as
    # jnp.argsort is
    sort_key = torch.where(mask, canon, N + 1)
    order = torch.argsort(sort_key, stable=True)
    k_sorted = sort_key[order]
    is_first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          k_sorted[1:] != k_sorted[:-1]]) & (k_sorted <= N)
    cell_id = torch.cumsum(is_first.to(torch.int32), 0) - 1  # per sorted row
    n_cells = int(torch.sum(is_first.to(torch.int32)))
    # unique cell coords in sorted-run order; slot max_cells is dropped
    pos = torch.where(is_first & (cell_id < max_cells), cell_id, max_cells)
    ucoords = torch.zeros((max_cells + 1, 4), dtype=torch.int32, device=dev)
    ucoords[pos] = cc[order]
    umask = torch.arange(max_cells, device=dev) < min(n_cells, max_cells)
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    start = torch.zeros((max_cells + 1,), dtype=torch.int32, device=dev)
    start[pos] = rows
    ends = torch.zeros((max_cells + 1,), dtype=torch.int32, device=dev)
    ends.scatter_reduce_(
        0, torch.where((k_sorted <= N) & (cell_id < max_cells), cell_id,
                       max_cells).to(torch.int64), rows + 1, reduce="amax")
    start, ends = start[:max_cells], ends[:max_cells]
    count = torch.clamp(ends - start, min=0)
    table = build_hash_table(ucoords[:max_cells], umask, device=dev)
    return GridIndex(points=points, mask=mask, order=order, cell_table=table,
                     start=start, count=count, cell=float(cell))


def nn_query(grid: GridIndex, queries, radius: float, q_mask=None,
             budget: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest neighbour within `radius` (must be <= grid.cell) of each
    query (M, 3), on the grid's device.

    Returns (dist (M,), idx (M,) int32 into grid.points; -1 when no
    neighbour within radius). `budget` caps candidates per cell (exactness
    holds while every cell holds <= budget points). Queries run in chunks
    of QUERY_CHUNK; ties go to the first candidate, as jnp.argmin does.
    """
    assert radius <= grid.cell + 1e-9, "search radius must fit the cell size"
    dev = grid.points.device
    queries = to_device(queries, dev, torch.float32)
    M = queries.shape[0]
    q_mask = (torch.ones((M,), dtype=torch.bool, device=dev) if q_mask is None
              else to_device(q_mask, dev, torch.bool))
    offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=dev)
    n_off = offs.shape[0]
    r2 = torch.tensor(radius, dtype=torch.float32, device=dev) ** 2
    N = grid.order.shape[0]
    j = torch.arange(budget, dtype=torch.int32, device=dev)
    dists, idxs = [], []
    for s in range(0, M, QUERY_CHUNK):
        q, qm = queries[s:s + QUERY_CHUNK], q_mask[s:s + QUERY_CHUNK]
        n_q = q.shape[0]
        qc = _cell_coords(q, grid.cell)
        # all 27 cell lookups of the chunk at once: (n_q * 27,)
        probes = (qc[:, None, :] + offs[None, :, :]).reshape(-1, 4)
        cells = lookup(grid.cell_table, probes,
                       torch.repeat_interleave(qm, n_off))
        hit = cells >= 0
        safe = torch.where(hit, cells, 0).to(torch.int64)
        st = grid.start[safe].reshape(n_q, n_off)  # run start per offset
        n = torch.where(hit, grid.count[safe], 0).reshape(n_q, n_off)
        # candidate sorted positions: (n_q, 27, budget)
        pos = torch.clamp(st[..., None] + j, 0, N - 1).to(torch.int64)
        valid = j < n[..., None]
        rows = grid.order[pos.reshape(n_q, -1)]  # (n_q, 27 * budget)
        d2 = _sqdist(q, grid.points[rows])
        ok = valid.reshape(n_q, -1) & grid.mask[rows] & (d2 <= r2)
        d2 = torch.where(ok, d2, torch.full_like(d2, 1e30))
        k = torch.argmin(d2, dim=-1, keepdim=True)
        bd2 = torch.gather(d2, -1, k)[:, 0]
        bidx = torch.gather(rows, -1, k)[:, 0].to(torch.int32)
        idxs.append(torch.where((bd2 < 1e29) & qm, bidx, -1))
        dists.append(bd2)
    if not idxs:
        return (torch.zeros((0,), dtype=torch.float32, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev))
    best_d2, best_idx = torch.cat(dists), torch.cat(idxs)
    d2 = torch.clamp(torch.where(best_idx >= 0, best_d2, 0.0), min=0.0)
    # the root in float64, rounded once: the correctly rounded float32
    # root on either device (torch's float32 sqrt on the CPU of an H100
    # host missed it for some inputs)
    return torch.sqrt(d2.to(torch.float64)).to(torch.float32), best_idx
