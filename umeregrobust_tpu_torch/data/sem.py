"""SEM -- Sampling Equalizer Module, voxel mode (the port's own copy of
umeregrobust_tpu/data/sem.py; numpy + scipy).

Replaces the reference's NKSR surface resampling with a voxel-equalized
resampler: quantize the scan at a fine voxel, spread the sample budget
uniformly over occupied voxels, jitter samples on each voxel's local
tangent plane, and copy labels from the nearest raw point within
label_copy_dist (else 0 = unlabeled). The 'patch' and 'oracle' modes of
the JAX package are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["SEMConfig", "equalize_sampling"]


@dataclass
class SEMConfig:
    num_points: int = 125000
    fine_voxel: float = 0.1
    label_copy_dist: float = 3.0
    tangent_jitter: bool = True
    knn_normal: int = 16
    seed: int = 0


def _nn_radius(q: np.ndarray, p: np.ndarray, radius: float) -> np.ndarray:
    """Index of the nearest point of p within radius for each q (-1: none)."""
    dist, idx = cKDTree(p).query(q, k=1)
    return np.where(dist <= radius, idx, -1).astype(np.int64)


def equalize_sampling(pts: np.ndarray, seg: np.ndarray,
                      cfg: SEMConfig | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Returns (new_pts (num_points, 3) float32, new_seg (num_points,) int32)."""
    cfg = cfg or SEMConfig()
    rng = np.random.default_rng(cfg.seed)
    v = cfg.fine_voxel
    coords = np.floor(pts / v).astype(np.int64)
    view = np.ascontiguousarray(coords).view(
        np.dtype((np.void, coords.dtype.itemsize * 3))).ravel()
    _, first_idx, _ = np.unique(view, return_index=True, return_inverse=True)
    n_vox = len(first_idx)
    centers = (coords[first_idx] + 0.5) * v

    per = np.full(n_vox, cfg.num_points // n_vox, np.int64)
    extra = cfg.num_points - per.sum()
    if extra > 0:
        per[rng.choice(n_vox, extra, replace=False)] += 1
    reps = np.repeat(np.arange(n_vox), per)
    base = centers[reps]

    if cfg.tangent_jitter and n_vox > cfg.knn_normal:
        tree = cKDTree(centers)
        _, nbr = tree.query(centers, k=min(cfg.knn_normal, n_vox))
        nb = centers[nbr]
        X = nb - nb.mean(axis=1, keepdims=True)
        cov = np.einsum("vki,vkj->vij", X, X) / X.shape[1]
        # smallest eigenvector = normal; the two largest span the plane
        _, V = np.linalg.eigh(cov)
        t1 = V[:, :, 2]
        t2 = V[:, :, 1]
        u = rng.uniform(-0.5, 0.5, size=len(base)).astype(np.float32)
        s = rng.uniform(-0.5, 0.5, size=len(base)).astype(np.float32)
        new_pts = (base + u[:, None] * t1[reps] * v
                   + s[:, None] * t2[reps] * v).astype(np.float32)
    else:
        new_pts = (base + rng.uniform(-0.5, 0.5, size=base.shape) * v).astype(
            np.float32)

    idx = _nn_radius(new_pts, pts.astype(np.float32), cfg.label_copy_dist)
    new_seg = np.zeros(len(new_pts), np.int32)
    ok = idx >= 0
    new_seg[ok] = seg[idx[ok]]
    return new_pts, new_seg
