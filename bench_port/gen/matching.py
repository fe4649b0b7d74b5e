"""Ground-truth correspondences on the host (the port's
data/matching_host.py, its nearest neighbours from scipy's cKDTree)."""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def nn_radius(q: np.ndarray, p: np.ndarray, radius: float):
    """(idx (Nq,) int64, dist (Nq,) float32): each query's nearest point of
    p within radius (inclusive), idx -1 and dist -1 where there is none."""
    q = np.ascontiguousarray(q, np.float32)
    p = np.ascontiguousarray(p, np.float32)
    dist, idx = cKDTree(p).query(q, k=1)
    idx = np.where(dist <= radius, idx, -1).astype(np.int64)
    dist = np.where(idx >= 0, dist, -1.0).astype(np.float32)
    return idx, dist


def one_side_matches(src_pts, tgt_pts, tform, radius: float) -> np.ndarray:
    """(K, 2) int64 [src_idx, tgt_idx]: the transformed source point's
    nearest target point, where it lies strictly closer than `radius`."""
    src_tf = (src_pts @ tform[:3, :3].T + tform[:3, 3]).astype(np.float32)
    idx, dist = nn_radius(src_tf, tgt_pts, radius)
    ok = (idx >= 0) & (dist < radius)
    return np.stack([np.nonzero(ok)[0], idx[ok]], axis=1).astype(np.int64)


def mutual_matches(src_pts, tgt_pts, tform, radius: float) -> np.ndarray:
    """The pairs (i, j) where j is i's forward match and i is j's backward
    match under the inverse transform."""
    fwd = one_side_matches(src_pts, tgt_pts, tform, radius)
    bwd = one_side_matches(tgt_pts, src_pts, np.linalg.inv(tform), radius)
    back = np.full(len(tgt_pts), -1, dtype=np.int64)
    back[bwd[:, 0]] = bwd[:, 1]
    return fwd[back[fwd[:, 1]] == fwd[:, 0]]
