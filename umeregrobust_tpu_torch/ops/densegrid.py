"""Dense-table grid index for radius-bounded NN (port of
umeregrobust_tpu/ops/densegrid.py).

Cells live in a static (Dx, Dy, Dz) box anchored at the cloud's min cell,
z fastest, so the 3 z-neighbour cells of a query form one contiguous run
of the cell-sorted points: a query reads 9 (dx, dy) windows of `budget`
rows each. Exact while every 3-z-cell window holds <= budget points
(`max_window_count`); points outside the box are counted in `overflow`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["DenseGrid", "build_dense_grid", "dense_candidates",
           "max_window_count"]

_FAR = 1e9  # parked coordinate for masked/padded rows


class DenseGrid(NamedTuple):
    points_sorted: torch.Tensor  # (N+1, 3) points[order], masked rows FAR
    order: torch.Tensor  # (N,) int64 rows sorted by flat cell id
    runs: torch.Tensor  # (C+1,) int32 packed start | count << 20
    origin: torch.Tensor  # (3,) int32 min cell coordinate
    overflow: torch.Tensor  # () valid points outside the box
    wstart: torch.Tensor  # (C+1,) int64 start of each cell's z-window
    cell: float
    dims: Tuple[int, int, int]


def build_dense_grid(points: torch.Tensor, mask: torch.Tensor, cell: float,
                     dims: Tuple[int, int, int]) -> DenseGrid:
    """Index `points` for radius-bounded NN with search radius <= cell."""
    N = points.shape[0]
    if N > (1 << 20) - 2:
        raise ValueError("packed run table needs N < 2^20 points")
    dev = points.device
    Dx, Dy, Dz = dims
    C = Dx * Dy * Dz
    cc = torch.floor(points / cell).to(torch.int32)
    big = torch.full_like(cc, 1 << 28)
    origin = torch.min(torch.where(mask[:, None], cc, big), dim=0).values
    rel = cc - origin
    dims_t = torch.tensor(dims, dtype=torch.int32, device=dev)
    inside = mask & torch.all((rel >= 0) & (rel < dims_t), dim=-1)
    overflow = torch.sum(mask & ~inside)
    flat = (rel[:, 0].long() * Dy + rel[:, 1]) * Dz + rel[:, 2]
    flat = torch.where(inside, flat, torch.full_like(flat, C))
    order = torch.argsort(flat, stable=True)
    f_sorted = flat[order]
    cells = torch.arange(C + 1, device=dev)
    start = torch.searchsorted(f_sorted, cells)
    count = torch.searchsorted(f_sorted, cells, right=True) - start
    count[C] = 0  # the spill slot never matches
    start = torch.where(count > 0, start, torch.full_like(start, N))
    runs = (start | (count << 20)).to(torch.int32)
    # window start per cell: min valid start over the (z-1, z, z+1) cells
    s_valid = start[:C].reshape(Dx * Dy, Dz)
    ws = s_valid.clone()
    ws[:, :-1] = torch.minimum(ws[:, :-1], s_valid[:, 1:])
    ws[:, 1:] = torch.minimum(ws[:, 1:], s_valid[:, :-1])
    wstart = torch.cat([ws.reshape(-1), torch.full((1,), N, device=dev,
                                                   dtype=ws.dtype)])
    ps = torch.where(mask[order, None], points[order],
                     torch.full((N, 3), _FAR, dtype=points.dtype, device=dev))
    ps = torch.cat([ps, torch.full((1, 3), _FAR, dtype=points.dtype,
                                   device=dev)])
    return DenseGrid(points_sorted=ps, order=order, runs=runs,
                     origin=origin, overflow=overflow, wstart=wstart,
                     cell=float(cell), dims=tuple(dims))


def max_window_count(grid: DenseGrid) -> torch.Tensor:
    """Exact max occupancy of any 3-z-cell query window."""
    c = (grid.runs[:-1] >> 20).reshape(grid.dims)
    w = c.clone()
    w[:, :, :-1] += c[:, :, 1:]
    w[:, :, 1:] += c[:, :, :-1]
    return torch.max(w)


def _window_starts(grid: DenseGrid, queries: torch.Tensor) -> torch.Tensor:
    """(M, 9) sorted-order starts of the 9 (dx, dy) 3-z-cell windows around
    each query; N for empty or out-of-box windows. z is clamped into the
    box (a clamped window's extra candidates fail the callers' radius
    filter)."""
    Dx, Dy, Dz = grid.dims
    C = Dx * Dy * Dz
    dev = queries.device
    qc = torch.floor(queries / grid.cell).to(torch.int32) - grid.origin
    d1 = torch.tensor([-1, 0, 1], dtype=torch.int32, device=dev)
    oxy = torch.stack(torch.meshgrid(d1, d1, indexing="ij"), -1).reshape(-1, 2)
    pxy = qc[:, None, :2] + oxy[None]
    ok_xy = torch.all((pxy >= 0) & (pxy < torch.tensor(
        [Dx, Dy], dtype=torch.int32, device=dev)), dim=-1)
    in_z = (qc[:, 2] >= -1) & (qc[:, 2] <= Dz)
    zc = torch.clamp(qc[:, 2], 0, Dz - 1)[:, None]
    ok = ok_xy & in_z[:, None]
    flat = (pxy[..., 0].long() * Dy + pxy[..., 1]) * Dz + zc
    flat = torch.where(ok, flat, torch.full_like(flat, C))
    return grid.wstart[flat]


def dense_candidates(grid: DenseGrid, queries: torch.Tensor,
                     budget: int = 8) -> torch.Tensor:
    """(M, 9*budget, 3) candidate target points around each query: row
    k of window w is points_sorted[start_w + k], FAR past the array end.
    Slots past a window's end hold real rows of later cells; they are
    duplicates of slots of another window or fail the radius filter."""
    s = _window_starts(grid, queries)  # (M, 9)
    N = grid.points_sorted.shape[0] - 1
    pos = s[..., None] + torch.arange(budget, device=queries.device)
    pos = torch.clamp(pos, max=N)  # N is the FAR row
    return grid.points_sorted[pos].reshape(queries.shape[0], -1, 3)
