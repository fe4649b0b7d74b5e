"""SEM -- Sampling Equalizer Module (the port's own copy of
umeregrobust_tpu/data/sem.py; numpy + scipy, nearest neighbours from the
native grid hash through data/matching_host as in the JAX package).

Replaces the reference's NKSR surface resampling (a reconstructed mesh
sampled at 125k points, labels copied back from the raw scan within 3 m,
kitti_dataset.py:511-542) with resamplers that remove the LiDAR's 1/r^2
density falloff:

- mode="voxel" (default): quantize the scan at a fine voxel, spread the
  sample budget uniformly over occupied voxels, jitter samples on each
  voxel's local tangent plane;
- mode="patch": a plane per coarse patch from the neighbouring patch
  centroids; planar patches are filled across their whole extent (the
  gaps between rings), others jitter around observed points;
- mode="oracle": a probe for synthetic scenes whose surface is known: the
  scan gains the scene samples within oracle_radius of an observed point
  (a completion both scans of a pair share), then goes through the voxel
  mode.

Every mode copies labels from the nearest raw point within
label_copy_dist (else 0 = unlabeled). The numpy generator's calls come in
the JAX package's order, so a seed gives the same points.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.spatial import cKDTree

from umeregrobust_tpu_torch.data.matching_host import nn_radius

__all__ = ["SEMConfig", "equalize_sampling"]


@dataclass
class SEMConfig:
    num_points: int = 125000
    fine_voxel: float = 0.1
    label_copy_dist: float = 3.0
    tangent_jitter: bool = True
    knn_normal: int = 16
    seed: int = 0
    mode: str = "voxel"
    patch: float = 0.6  # mode="patch": patch edge (m)
    # mode="patch": a neighbourhood whose smallest / middle PCA eigenvalue
    # ratio is below this is a surface, and its patch is filled
    planarity_max: float = 0.15
    oracle_radius: float = 1.5  # mode="oracle": scene samples kept (m)


def _unique_rows(coords: np.ndarray):
    """np.unique over the rows of an int64 (N, 3) array: (first index,
    inverse) in sorted-row order."""
    view = np.ascontiguousarray(coords).view(
        np.dtype((np.void, coords.dtype.itemsize * 3))).ravel()
    _, first_idx, inv = np.unique(view, return_index=True, return_inverse=True)
    return first_idx, inv.reshape(-1)


def _tangent_frames(centers: np.ndarray, knn: int):
    """(eigenvalues (n, 3) ascending, the two tangent axes t1, t2 (n, 3))
    of each center's neighbourhood of its knn nearest centers."""
    _, nbr = cKDTree(centers).query(centers, k=knn)
    nb = centers[nbr]
    X = nb - nb.mean(axis=1, keepdims=True)
    cov = np.einsum("vki,vkj->vij", X, X) / X.shape[1]
    # smallest eigenvector = normal; the two largest span the plane
    w, V = np.linalg.eigh(cov)
    return w, V[:, :, 2], V[:, :, 1]


def _budget(n_cells: int, num_points: int, rng) -> np.ndarray:
    """Cell index of every sample: the budget spread uniformly, the
    remainder on randomly chosen cells."""
    per = np.full(n_cells, num_points // n_cells, np.int64)
    extra = num_points - per.sum()
    if extra > 0:
        per[rng.choice(n_cells, extra, replace=False)] += 1
    return np.repeat(np.arange(n_cells), per)


def _copy_labels(new_pts, pts, seg, radius):
    idx, _ = nn_radius(new_pts, pts, radius)
    new_seg = np.zeros(len(new_pts), np.int32)
    ok = idx >= 0
    new_seg[ok] = seg[idx[ok]]
    return new_seg


def _patch_resample(pts: np.ndarray, cfg: SEMConfig,
                    rng: np.random.Generator) -> np.ndarray:
    """Uniform-areal resampling at patch scale: planar patches filled over
    their (t1, t2) extent, the others jittered around observed points."""
    P = cfg.patch
    first_idx, inv = _unique_rows(np.floor(pts / P).astype(np.int64))
    n_pat = len(first_idx)
    # centroid of each patch's own points
    cent = np.zeros((n_pat, 3), np.float64)
    np.add.at(cent, inv, pts)
    cnt = np.bincount(inv, minlength=n_pat).astype(np.float64)
    cent /= cnt[:, None]

    w, t1, t2 = _tangent_frames(cent, min(cfg.knn_normal, n_pat))
    planar = w[:, 0] <= cfg.planarity_max * np.maximum(w[:, 1], 1e-12)

    reps = _budget(n_pat, cfg.num_points, rng)
    u = rng.uniform(-0.5, 0.5, size=len(reps))
    s = rng.uniform(-0.5, 0.5, size=len(reps))
    filled = (cent[reps]
              + (u * P)[:, None] * t1[reps]
              + (s * P)[:, None] * t2[reps])
    # the fallback: jitter around a random observed point of the patch
    order = np.argsort(inv, kind="stable")
    starts = np.zeros(n_pat + 1, np.int64)
    np.cumsum(np.bincount(inv, minlength=n_pat), out=starts[1:])
    pick = (starts[reps]
            + rng.integers(0, np.maximum(cnt[reps].astype(np.int64), 1)))
    anchored = (pts[order[pick]]
                + rng.uniform(-0.5, 0.5, size=(len(reps), 3))
                * cfg.fine_voxel)
    return np.where(planar[reps, None], filled, anchored).astype(np.float32)


def equalize_sampling(
    pts: np.ndarray, seg: np.ndarray, cfg: SEMConfig | None = None,
    scene_pts: np.ndarray | None = None,
    scene_seg: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (new_pts (num_points, 3) float32, new_seg (num_points,) int32).

    scene_pts / scene_seg: the scene's surface samples in this scan's
    frame, which mode="oracle" needs; the other modes ignore them.
    """
    cfg = cfg or SEMConfig()
    rng = np.random.default_rng(cfg.seed)
    if cfg.mode == "oracle":
        if scene_pts is None:
            raise ValueError("mode='oracle' needs scene_pts/scene_seg")
        idx, _ = nn_radius(scene_pts, pts, cfg.oracle_radius)
        keep = idx >= 0
        pts = np.concatenate([np.asarray(pts, np.float32),
                              scene_pts[keep].astype(np.float32)], axis=0)
        seg = np.concatenate([np.asarray(seg, np.int32),
                              scene_seg[keep].astype(np.int32)])
        # then the voxel mode on the augmented cloud
    if cfg.mode == "patch":
        new_pts = _patch_resample(np.asarray(pts, np.float64), cfg, rng)
        return new_pts, _copy_labels(new_pts, pts, seg, cfg.label_copy_dist)
    v = cfg.fine_voxel
    coords = np.floor(pts / v).astype(np.int64)
    first_idx, _ = _unique_rows(coords)
    n_vox = len(first_idx)
    centers = (coords[first_idx] + 0.5) * v

    reps = _budget(n_vox, cfg.num_points, rng)
    base = centers[reps]

    if cfg.tangent_jitter and n_vox > cfg.knn_normal:
        _, t1, t2 = _tangent_frames(centers, min(cfg.knn_normal, n_vox))
        u = rng.uniform(-0.5, 0.5, size=len(base)).astype(np.float32)
        s = rng.uniform(-0.5, 0.5, size=len(base)).astype(np.float32)
        new_pts = (base + u[:, None] * t1[reps] * v
                   + s[:, None] * t2[reps] * v).astype(np.float32)
    else:
        new_pts = (base + rng.uniform(-0.5, 0.5, size=base.shape) * v).astype(
            np.float32)
    return new_pts, _copy_labels(new_pts, pts, seg, cfg.label_copy_dist)
