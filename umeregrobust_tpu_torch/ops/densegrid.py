"""Dense-table grid index for radius-bounded NN (port of
umeregrobust_tpu/ops/densegrid.py).

Cells live in a static (Dx, Dy, Dz) box anchored at the cloud's min cell,
z fastest, so the 3 z-neighbour cells of a query form one contiguous run
of the cell-sorted points: a query reads 9 (dx, dy) windows of `budget`
rows each. Exact while every 3-z-cell window holds <= budget points
(`max_window_count`); points outside the box are counted in `overflow`.
Every function takes an optional leading pair axis: B grids of one shape,
each pair's candidates from its own grid.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from umeregrobust_tpu_torch.ops.neighbors import take_rows
from umeregrobust_tpu_torch.utils.profiling import host_read

__all__ = ["DenseGrid", "build_dense_grid", "dense_candidates",
           "dense_nn_query", "max_cell_count", "max_window_count",
           "DEFAULT_DIMS"]

DEFAULT_DIMS = (384, 384, 96)

_FAR = 1e9  # parked coordinate for masked/padded rows


class DenseGrid(NamedTuple):
    points_sorted: torch.Tensor  # ([B,] N+1, 3) points[order], masked rows FAR
    order: torch.Tensor  # ([B,] N) int64 rows sorted by flat cell id
    runs: torch.Tensor  # ([B,] C+1) int32 packed start | count << 20
    origin: torch.Tensor  # ([B,] 3) int32 min cell coordinate
    overflow: torch.Tensor  # ([B,]) valid points outside the box
    wstart: torch.Tensor  # ([B,] C+1) int64 start of each cell's z-window
    cell: float
    dims: Tuple[int, int, int]


def build_dense_grid(points: torch.Tensor, mask: torch.Tensor, cell: float,
                     dims: Tuple[int, int, int]) -> DenseGrid:
    """Index `points` ([B,] N, 3) for radius-bounded NN with search radius
    <= cell. With a leading pair axis every pair gets its own box (own
    origin), built by the same sorts and searches over the batch."""
    N = points.shape[-2]
    if N > (1 << 20) - 2:
        raise ValueError("packed run table needs N < 2^20 points")
    lead = tuple(points.shape[:-2])
    dev = points.device
    Dx, Dy, Dz = dims
    C = Dx * Dy * Dz
    cc = torch.floor(points / cell).to(torch.int32)
    big = torch.full_like(cc, 1 << 28)
    origin = torch.min(torch.where(mask[..., None], cc, big), dim=-2).values
    rel = cc - origin[..., None, :]
    dims_t = torch.tensor(dims, dtype=torch.int32, device=dev)
    host_read("densegrid.build", device=dev)  # a copy to the card
    inside = mask & torch.all((rel >= 0) & (rel < dims_t), dim=-1)
    overflow = torch.sum(mask & ~inside, dim=-1)
    flat = (rel[..., 0].long() * Dy + rel[..., 1]) * Dz + rel[..., 2]
    flat = torch.where(inside, flat, torch.full_like(flat, C))
    order = torch.argsort(flat, dim=-1, stable=True)
    f_sorted = torch.gather(flat, -1, order)
    cells = torch.arange(C + 1, device=dev).expand(lead + (C + 1,))
    cells = cells.contiguous()
    start = torch.searchsorted(f_sorted, cells)
    count = torch.searchsorted(f_sorted, cells, right=True) - start
    count[..., C] = 0  # the spill slot never matches
    start = torch.where(count > 0, start, torch.full_like(start, N))
    runs = (start | (count << 20)).to(torch.int32)
    # window start per cell: min valid start over the (z-1, z, z+1) cells
    s_valid = start[..., :C].reshape(lead + (Dx * Dy, Dz))
    ws = s_valid.clone()
    ws[..., :-1] = torch.minimum(ws[..., :-1], s_valid[..., 1:])
    ws[..., 1:] = torch.minimum(ws[..., 1:], s_valid[..., :-1])
    wstart = torch.cat([ws.reshape(lead + (C,)),
                        torch.full(lead + (1,), N, device=dev,
                                   dtype=ws.dtype)], dim=-1)
    far = torch.full(lead + (N + 1, 3), _FAR, dtype=points.dtype,
                     device=dev)
    ps = torch.where(take_rows(mask, order)[..., None],
                     take_rows(points, order), far[..., :N, :])
    ps = torch.cat([ps, far[..., N:, :]], dim=-2)
    return DenseGrid(points_sorted=ps, order=order, runs=runs,
                     origin=origin, overflow=overflow, wstart=wstart,
                     cell=float(cell), dims=tuple(dims))


def max_cell_count(grid: DenseGrid) -> torch.Tensor:
    """Max points in any cell (([B,])); queries are exact while 3 x this
    <= budget (a sufficient bound; max_window_count is the tight one)."""
    return torch.amax(grid.runs >> 20, dim=-1)


def max_window_count(grid: DenseGrid) -> torch.Tensor:
    """Exact max occupancy of any 3-z-cell query window (([B,]))."""
    lead = tuple(grid.runs.shape[:-1])
    c = (grid.runs[..., :-1] >> 20).reshape(lead + tuple(grid.dims))
    w = c.clone()
    w[..., :-1] += c[..., 1:]
    w[..., 1:] += c[..., :-1]
    return torch.amax(w, dim=(-3, -2, -1))


def _window_starts(grid: DenseGrid, queries: torch.Tensor) -> torch.Tensor:
    """([B,] M, 9) sorted-order starts of the 9 (dx, dy) 3-z-cell windows
    around each query; N for empty or out-of-box windows. z is clamped into
    the box (a clamped window's extra candidates fail the callers' radius
    filter)."""
    Dx, Dy, Dz = grid.dims
    C = Dx * Dy * Dz
    dev = queries.device
    qc = torch.floor(queries / grid.cell).to(torch.int32) \
        - grid.origin[..., None, :]
    d1 = torch.tensor([-1, 0, 1], dtype=torch.int32, device=dev)
    oxy = torch.stack(torch.meshgrid(d1, d1, indexing="ij"), -1).reshape(-1, 2)
    pxy = qc[..., :, None, :2] + oxy
    ok_xy = torch.all((pxy >= 0) & (pxy < torch.tensor(
        [Dx, Dy], dtype=torch.int32, device=dev)), dim=-1)
    host_read("densegrid.window_starts", 2, device=dev)  # two copies
    in_z = (qc[..., 2] >= -1) & (qc[..., 2] <= Dz)
    zc = torch.clamp(qc[..., 2], 0, Dz - 1)[..., None]
    ok = ok_xy & in_z[..., None]
    flat = (pxy[..., 0].long() * Dy + pxy[..., 1]) * Dz + zc
    flat = torch.where(ok, flat, torch.full_like(flat, C))
    lead = tuple(queries.shape[:-2])
    return torch.gather(grid.wstart, -1, flat.reshape(lead + (-1,))
                        ).reshape(flat.shape)


def _candidates(grid: DenseGrid, queries: torch.Tensor, budget: int):
    """(rows ([B,] M, 9*budget) of points_sorted, their points ([B,] M,
    9*budget, 3)): row k of window w is start_w + k, clamped to N, the FAR
    row past the array end."""
    s = _window_starts(grid, queries)  # ([B,] M, 9)
    N = grid.points_sorted.shape[-2] - 1
    pos = torch.clamp(s[..., None] + torch.arange(budget, device=s.device),
                      max=N).reshape(s.shape[:-1] + (-1,))
    lead = tuple(queries.shape[:-2])
    return pos, take_rows(grid.points_sorted, pos.reshape(
        lead + (-1,))).reshape(pos.shape + (3,))


def dense_candidates(grid: DenseGrid, queries: torch.Tensor,
                     budget: int = 8) -> torch.Tensor:
    """([B,] M, 9*budget, 3) candidate target points around each query
    (pair b's queries in pair b's grid): row k of window w is
    points_sorted[start_w + k], FAR past the array end. Slots past a
    window's end hold real rows of later cells of the same cloud; they are
    duplicates of slots of another window or fail the radius filter."""
    return _candidates(grid, queries, budget)[1]


def dense_nn_query(grid: DenseGrid, queries: torch.Tensor, radius: float,
                   q_mask: Optional[torch.Tensor] = None,
                   budget: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest neighbour within `radius` (<= grid.cell) among each query's
    9 x budget window candidates: (dist ([B,] M), idx ([B,] M) int64), idx
    the row of the indexed points (through grid.order), -1 and dist 0 on
    no hit or a masked query. Ties go to the lower candidate slot, as
    jnp.argmin does; the winner's sorted row is its window's start plus
    its slot. Exact while every window holds <= budget points
    (max_window_count)."""
    assert radius <= grid.cell + 1e-9, "search radius must fit the cell size"
    pos, cand = _candidates(grid, queries, budget)
    d2 = torch.sum((queries[..., :, None, :] - cand) ** 2, dim=-1)
    r2 = torch.tensor(radius, dtype=torch.float32, device=d2.device) ** 2
    d2 = torch.where(d2 <= r2, d2, torch.full_like(d2, 1e30))
    k = torch.argmin(d2, dim=-1, keepdim=True)
    bd2 = torch.gather(d2, -1, k)[..., 0]
    hit = bd2 < 1e29
    if q_mask is not None:
        hit = hit & q_mask
    idx = torch.gather(grid.order, -1, torch.gather(pos, -1, k)[..., 0]
                       .clamp(max=grid.order.shape[-1] - 1))
    dist = torch.sqrt(torch.where(hit, bd2, torch.zeros_like(bd2)))
    return dist, torch.where(hit, idx, torch.full_like(idx, -1))
