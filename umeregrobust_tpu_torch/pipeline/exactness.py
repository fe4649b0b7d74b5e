"""ICP dense-grid exactness pre-checks on the host (numpy; the port's own
copy of umeregrobust_tpu/pipeline/exactness.py).

The fine-stage ICP correspondence query is exact only while every
3-z-cell window of the target grid holds at most `icp_budget` points;
callers measure the worst window before a run and escalate the budget.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = ["fine_grid_geometry", "window_occupancy", "escalated_budget"]


def fine_grid_geometry(cfg) -> Tuple[float, Tuple[int, int, int]]:
    """Cell size and dims of the fine-stage ICP grid of a
    RegistrationConfig."""
    cell = float(cfg.icp_max_corr) * float(cfg.icp_grid_scale)
    dims = tuple(int(math.ceil(d * cfg.icp_max_corr / cell - 1e-6))
                 for d in cfg.icp_dims)
    return cell, dims


def window_occupancy(pts: np.ndarray, cell: float,
                     grid_dims: Tuple[int, int, int]) -> Tuple[int, int]:
    """(max 3-z-cell window count, #points outside the grid box)."""
    pts = np.asarray(pts)
    if len(pts) == 0:
        return 0, 0
    cc = np.floor(pts / cell).astype(np.int64)
    cc -= cc.min(axis=0)
    dims = cc.max(axis=0) + 1
    box_bad = int(np.sum((cc >= np.asarray(grid_dims)).any(axis=1)))
    occ = np.zeros(dims, np.int32)
    np.add.at(occ, tuple(cc.T), 1)
    w = occ.copy()
    w[:, :, :-1] += occ[:, :, 1:]
    w[:, :, 1:] += occ[:, :, :-1]
    return int(w.max()), box_bad


def escalated_budget(worst_window: int, budget: int) -> int:
    """Smallest multiple of 8 covering the worst window (capped at 128),
    or the current budget when it already suffices."""
    if worst_window <= budget:
        return int(budget)
    return int(min(-(-worst_window // 8) * 8, 128))
