"""Host-side ground-truth correspondences for dataset items (the port's
own copy of umeregrobust_tpu/data/matching_host.py): one-sided and mutual
nearest-neighbour matches under the ground-truth transform (reference
utils/general_utils.py:38-59).

The nearest neighbour comes from the native grid hash
(umeregrobust_tpu_torch/native, C++, float32), as in the JAX package, so
both give the same matches; scipy's cKDTree stands in where the native
library cannot be built.
"""
from __future__ import annotations

import numpy as np

from umeregrobust_tpu_torch import native

__all__ = ["nn_radius", "one_side_matches", "mutual_matches"]


def nn_radius(q: np.ndarray, p: np.ndarray, radius: float
              ) -> tuple[np.ndarray, np.ndarray]:
    """(idx (Nq,) int64, dist (Nq,) float32): each query's nearest point of
    p within radius (inclusive), idx -1 and dist -1 where there is none."""
    return native.nn_radius(q, p, radius)


def one_side_matches(
    src_pts: np.ndarray,
    tgt_pts: np.ndarray,
    tform: np.ndarray,
    radius: float,
) -> np.ndarray:
    """(K, 2) int64 [src_idx, tgt_idx]: the transformed source point's
    nearest target point, where it lies strictly closer than `radius`."""
    src_tf = (src_pts @ tform[:3, :3].T + tform[:3, 3]).astype(np.float32)
    idx, dist = nn_radius(src_tf, tgt_pts, radius)
    ok = (idx >= 0) & (dist < radius)
    return np.stack([np.nonzero(ok)[0], idx[ok]], axis=1).astype(np.int64)


def mutual_matches(
    src_pts: np.ndarray,
    tgt_pts: np.ndarray,
    tform: np.ndarray,
    radius: float,
) -> np.ndarray:
    """The pairs (i, j) where j is i's forward match and i is j's backward
    match under the inverse transform."""
    fwd = one_side_matches(src_pts, tgt_pts, tform, radius)
    inv = np.linalg.inv(tform)
    bwd = one_side_matches(tgt_pts, src_pts, inv, radius)
    back = np.full(len(tgt_pts), -1, dtype=np.int64)
    back[bwd[:, 0]] = bwd[:, 1]
    ok = back[fwd[:, 1]] == fwd[:, 0]
    return fwd[ok]
