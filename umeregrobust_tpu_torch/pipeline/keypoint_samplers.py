"""Standalone keypoint samplers (port of
umeregrobust_tpu/pipeline/keypoint_samplers.py): the reference's
sample_smart_keypoints (utils/loc_utils.py:448-500: non-flat labels,
dense neighbourhoods, minimum spacing by voxel-grid thinning) and
sample_smart_keypoints2 (:503-558: a coarse xy / z lattice snapped to a
non-flat point, then density-filtered), at fixed shapes with masks.

Row order follows the JAX package's: candidates by descending index
(lax.top_k, lower index first among ties: a stable sort here), one
keypoint per spacing cell (the cell's first candidate), then ascending
position. Masked rows come out zero.
"""
from __future__ import annotations

from typing import Tuple

import torch

from umeregrobust_tpu_torch.devices import resolve_device, to_device
from umeregrobust_tpu_torch.ops.neighbors import ball_query, topk_stable
from umeregrobust_tpu_torch.ops.sortmaps import pack_coords

__all__ = ["sample_smart_keypoints", "sample_grid_keypoints"]


def _inputs(pts, seg, mask, device):
    dev = resolve_device(device)
    return (to_device(pts, dev, torch.float32), to_device(seg, dev),
            to_device(mask, dev, torch.bool))


def _candidates(seg, mask, flat_labels):
    cand = mask
    for fl in flat_labels:
        cand = cand & (seg != fl)
    return cand


def _dense(kpts, pts, mask, q_mask, nn_r, max_nn, min_nn):
    nbr = ball_query(kpts, pts, radius=nn_r, K=max_nn, q_mask=q_mask,
                     p_mask=mask)
    return torch.sum((nbr >= 0).to(torch.int32), -1) >= min_nn


def sample_smart_keypoints(
    pts, seg, mask,
    num_samples: int = 1024,
    nn_r: float = 10.0,
    max_nn: int = 750,
    min_nn: int = 300,
    flat_labels: Tuple[int, ...] = (9,),
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-flat, dense-neighbourhood keypoints at least one nn_r cell
    apart: (kpts (num_samples, 3), kp_mask), on `device` (the card unless
    device="cpu"; raises without CUDA)."""
    pts, seg, mask = _inputs(pts, seg, mask, device)
    N = pts.shape[0]
    work = min(8 * num_samples, N)
    idx = torch.arange(N, dtype=torch.int32, device=pts.device)
    score = torch.where(_candidates(seg, mask, flat_labels), idx,
                        torch.full_like(idx, -1))
    top, rows = topk_stable(score, work)  # descending index order
    kpts, kmask = pts[rows], top >= 0
    keep = kmask & _dense(kpts, pts, mask, kmask, nn_r, max_nn, min_nn)
    # spacing: the first candidate (lowest position) of each nn_r cell
    coords = torch.cat([torch.zeros((work, 1), dtype=torch.int32,
                                    device=pts.device),
                        torch.floor(kpts / nn_r).to(torch.int32)], dim=1)
    code = pack_coords(coords, keep, 0x7FFFFFF0)
    code_s, row_s = torch.sort(code, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=pts.device),
                       code_s[1:] != code_s[:-1]]) & keep[row_s]
    rep = torch.where(first, row_s, torch.full_like(row_s, work))
    rep = torch.sort(rep).values[:num_samples]
    kp_mask = rep < work
    out = kpts[torch.where(kp_mask, rep, torch.zeros_like(rep))]
    return out * kp_mask[:, None], kp_mask


def sample_grid_keypoints(
    pts, seg, mask,
    num_samples: int = 1024,
    nn_r: float = 10.0,
    max_nn: int = 750,
    min_nn: int = 300,
    d_grid: float = 4.0,
    dz_grid: float = 2.0,
    grid_clip_thr: float = 0.75,
    flat_labels: Tuple[int, ...] = (9,),
    grid_extent: float = 60.0,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-seeded keypoints: a fixed xy / z lattice over +-grid_extent,
    each node snapped to the first non-flat point within grid_clip_thr,
    then density-filtered; (kpts (num_samples, 3), kp_mask) in lattice
    order, on `device` (the card unless device="cpu")."""
    pts, seg, mask = _inputs(pts, seg, mask, device)
    dev = pts.device
    nx = int(2 * grid_extent / d_grid)
    nz = max(int(8.0 / dz_grid), 1)
    xs = ((torch.arange(nx, dtype=torch.float32, device=dev) - nx / 2)
          * d_grid + 0.5 * d_grid)
    zs = ((torch.arange(nz, dtype=torch.float32, device=dev) - nz / 2)
          * dz_grid + 0.5 * dz_grid)
    gx, gy, gz = torch.meshgrid(xs, xs, zs, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    G = grid.shape[0]

    snap = ball_query(grid, pts, radius=grid_clip_thr, K=1,
                      p_mask=_candidates(seg, mask, flat_labels))[:, 0]
    hit = snap >= 0
    kpts = pts[torch.where(hit, snap, torch.zeros_like(snap))]
    keep = hit & _dense(kpts, pts, mask, hit, nn_r, max_nn, min_nn)
    lattice = torch.arange(G, dtype=torch.int64, device=dev)
    sel = torch.sort(torch.where(keep, lattice, torch.full_like(lattice, G))
                     ).values[:num_samples]
    kp_mask = sel < G
    out = kpts[torch.where(kp_mask, sel, torch.zeros_like(sel))]
    return out * kp_mask[:, None], kp_mask
