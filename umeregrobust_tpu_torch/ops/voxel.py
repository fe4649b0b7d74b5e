"""Host-side voxel quantization and coords -> metric mapping (numpy; the
port's own copy of the numpy half of umeregrobust_tpu/ops/voxel.py)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["quantize_np", "coords_to_grid_pts_np"]


def quantize_np(pts: np.ndarray, voxel_size: float) -> Tuple[np.ndarray, np.ndarray]:
    """(coords (M, 3) int32 = floor(pts / voxel), index of the first input
    point of each voxel, in input order)."""
    coords = np.floor(pts / voxel_size).astype(np.int64)
    view = np.ascontiguousarray(coords).view(
        np.dtype((np.void, coords.dtype.itemsize * 3))).ravel()
    _, first_idx = np.unique(view, return_index=True)
    first_idx = np.sort(first_idx)
    return coords[first_idx].astype(np.int32), first_idx


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
