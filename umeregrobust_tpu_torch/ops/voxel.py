"""Voxel quantization and coords -> metric mapping (port of
umeregrobust_tpu/ops/voxel.py): host numpy versions for the data layer,
and fixed-capacity tensor versions (`quantize_torch`,
`coords_to_grid_pts`) on any device. The data layer imports this module
on the host only, so torch is imported inside the tensor versions."""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np

if TYPE_CHECKING:
    import torch

__all__ = ["quantize_np", "quantize_torch", "coords_to_grid_pts",
           "coords_to_grid_pts_np"]


def quantize_np(pts: np.ndarray, voxel_size: float) -> Tuple[np.ndarray, np.ndarray]:
    """(coords (M, 3) int32 = floor(pts / voxel), index of the first input
    point of each voxel, in input order)."""
    coords = np.floor(pts / voxel_size).astype(np.int64)
    view = np.ascontiguousarray(coords).view(
        np.dtype((np.void, coords.dtype.itemsize * 3))).ravel()
    _, first_idx = np.unique(view, return_index=True)
    first_idx = np.sort(first_idx)
    return coords[first_idx].astype(np.int32), first_idx


def quantize_torch(pts: "torch.Tensor", voxel_size: float,
                   mask: "torch.Tensor", max_voxels: int):
    """Fixed-capacity voxel quantization of (N, 3) points with (N,) mask:
    (coords (M, 3) int32 (row 0's coords where invalid), rep (M,) int32
    index of the first input point of each voxel (-1 where invalid),
    out_mask (M,)), M = max_voxels, voxels in the order of their packed
    key (x, then y, then z from the valid minimum), as the JAX package's
    quantize_jax makes them."""
    import torch

    N = pts.shape[0]
    coords = torch.floor(pts / voxel_size).to(torch.int32)
    cmin = torch.min(torch.where(mask[:, None], coords, 2 ** 30), dim=0).values
    rel = (coords - cmin).to(torch.int64)
    extent = torch.max(torch.where(mask[:, None], rel, -1), dim=0).values + 2
    key = (rel[:, 0] * extent[1] + rel[:, 1]) * extent[2] + rel[:, 2]
    key = torch.where(mask, key, 2 ** 31 - 1)  # invalid rows: one bucket
    order = torch.argsort(key, stable=True)  # ties keep input order
    k_sorted = key[order]
    is_first = torch.ones_like(mask[order])
    is_first[1:] = k_sorted[1:] != k_sorted[:-1]
    rank = torch.cumsum(is_first.to(torch.int64), 0) - 1  # voxel id a row
    take = is_first & (k_sorted != 2 ** 31 - 1) & (rank < max_voxels)
    rep = torch.full((max_voxels + 1,), -1, dtype=torch.int32,
                     device=pts.device)
    rep[torch.where(take, rank, max_voxels)] = torch.where(
        take, order, -1).to(torch.int32)
    rep = rep[:max_voxels]
    out_mask = rep >= 0
    return coords[torch.where(out_mask, rep, 0).long()], rep, out_mask


def coords_to_grid_pts(pts: "torch.Tensor", coords: "torch.Tensor",
                       voxel_size: float,
                       pts_mask: Optional["torch.Tensor"] = None,
                       coords_mask: Optional["torch.Tensor"] = None
                       ) -> "torch.Tensor":
    """coords_to_grid_pts_np's affine map on tensors, the extremes taken
    over the masked rows where masks are given."""
    import torch

    pts = pts.to(torch.float32)
    c = coords.to(torch.float32)

    def extremes(x, m):
        if m is None:
            return x.max(0).values, x.min(0).values
        return (torch.where(m[:, None], x, -1e30).max(0).values,
                torch.where(m[:, None], x, 1e30).min(0).values)

    pmax, pmin = extremes(pts, pts_mask)
    cmax, cmin = extremes(c, coords_mask)
    a = pmax - 0.5 * voxel_size
    cc = pmin + 0.5 * voxel_size
    alpha = (a - cc) / (cmax - cmin)
    beta = (cmax * cc - a * cmin) / (cmax - cmin)
    return c * alpha + beta


def coords_to_grid_pts_np(pts: np.ndarray, coords: np.ndarray,
                          voxel_size: float) -> np.ndarray:
    """Per-axis affine map fitted so the extreme coords land on the
    half-voxel-inset extreme points (reference convert_coords_to_grid_pts)."""
    pts = pts.astype(np.float32)
    c = coords.astype(np.float32)
    a = pts.max(0) - 0.5 * voxel_size
    b = c.max(0)
    cc = pts.min(0) + 0.5 * voxel_size
    d = c.min(0)
    alpha = (a - cc) / (b - d)
    beta = (b * cc - a * d) / (b - d)
    return (c * alpha + beta).astype(np.float32)
