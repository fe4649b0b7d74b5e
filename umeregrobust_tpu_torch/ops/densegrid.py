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

from typing import NamedTuple, Tuple

import torch

from umeregrobust_tpu_torch.ops.neighbors import take_rows

__all__ = ["DenseGrid", "build_dense_grid", "dense_candidates",
           "max_window_count"]

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
    in_z = (qc[..., 2] >= -1) & (qc[..., 2] <= Dz)
    zc = torch.clamp(qc[..., 2], 0, Dz - 1)[..., None]
    ok = ok_xy & in_z[..., None]
    flat = (pxy[..., 0].long() * Dy + pxy[..., 1]) * Dz + zc
    flat = torch.where(ok, flat, torch.full_like(flat, C))
    lead = tuple(queries.shape[:-2])
    return torch.gather(grid.wstart, -1, flat.reshape(lead + (-1,))
                        ).reshape(flat.shape)


def dense_candidates(grid: DenseGrid, queries: torch.Tensor,
                     budget: int = 8) -> torch.Tensor:
    """([B,] M, 9*budget, 3) candidate target points around each query
    (pair b's queries in pair b's grid): row k of window w is
    points_sorted[start_w + k], FAR past the array end. Slots past a
    window's end hold real rows of later cells of the same cloud; they are
    duplicates of slots of another window or fail the radius filter."""
    s = _window_starts(grid, queries)  # ([B,] M, 9)
    N = grid.points_sorted.shape[-2] - 1
    pos = s[..., None] + torch.arange(budget, device=queries.device)
    pos = torch.clamp(pos, max=N)  # N is the FAR row
    lead = tuple(queries.shape[:-2])
    return take_rows(grid.points_sorted, pos.reshape(lead + (-1,))).reshape(
        queries.shape[:-1] + (-1, 3))
