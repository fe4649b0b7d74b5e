"""Train-time keypoint selection and paired UME generation (port of
umeregrobust_tpu/pipeline/train_keypoints.py), the routine behind the
UME-contrastive and cube-registration losses and the inlier-ratio metric.

Source keypoints pass, in order: a non-flat semantic label (flat_labels),
a ground-truth-transformed point with a target point within
nn_intersection_r, and at least min_nn in-radius source neighbours; the
first num_samples survivors in DESCENDING point-index order are kept.
Density is evaluated on a working set of the 2 num_samples highest-index
candidates (approx_truncated flags the one case where that can differ
from evaluating every candidate). Source UMEs come from the capped ball
of each keypoint, target UMEs from the ball of its transformed position
in the target cloud (no re-centring). matched_nn_intersection_ratio: per
keypoint, the share of its max_nn source-neighbour slots whose
transformed position lies within nn_intersection_r of one of the
keypoint's target-neighbour slots (pad slots included, as in JAX).

Both `lax.top_k` selections of JAX break ties toward the lower index;
`topk_stable` keeps that order. The inputs carry a leading pair axis B;
the selection runs pair by pair (no gradient), the feature gathers for
all pairs at once through gather_padded (the gather_rows kernel and its
backward on the card), and the per-keypoint (max_nn x max_nn) distance
tiles of the ratio a chunk of keypoints at a time.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from umeregrobust_tpu_torch.core.transforms import apply_transform
from umeregrobust_tpu_torch.core.ume import moment_matrix
from umeregrobust_tpu_torch.ops.neighbors import (
    ball_query, gather_padded, topk_stable)
from umeregrobust_tpu_torch.utils.profiling import host_read, span

__all__ = ["TrainKeypoints", "generate_training_umes"]

# keypoints whose (max_nn x max_nn) distance tile is formed at once
_RATIO_CHUNK = 32


class TrainKeypoints(NamedTuple):
    src_ume: torch.Tensor  # (B, K, C, 4)
    tgt_ume: torch.Tensor  # (B, K, C, 4)
    src_kpts: torch.Tensor  # (B, K, 3)
    tgt_kpts: torch.Tensor  # (B, K, 3) = GT-transformed src keypoints
    kp_mask: torch.Tensor  # (B, K) valid keypoint
    nn_intersection_ratio: torch.Tensor  # (B, K)
    # (B,) bool: the working set was full AND fewer than num_samples
    # survived density (the trainer logs it as `kp_truncated`)
    approx_truncated: torch.Tensor


def _select(src_pts, src_seg, src_mask, tgt_pts, tgt_mask, gt, num_samples,
            max_nn, min_nn, nn_r, nn_intersection_r, flat_labels):
    """One pair's keypoints: (kpts (K, 3), kp_mask (K,), src neighbour
    indices (K, max_nn), target neighbour indices (K, max_nn), tgt_kpts
    (K, 3), truncated ())."""
    N = src_pts.shape[0]
    dev = src_pts.device
    non_flat = src_mask
    for fl in flat_labels:
        non_flat = non_flat & (src_seg != fl)
    src_tf = apply_transform(gt, src_pts)
    inter = ball_query(src_tf, tgt_pts, radius=nn_intersection_r, K=1,
                       q_mask=src_mask, p_mask=tgt_mask)
    cand = non_flat & (inter[:, 0] >= 0)

    work = min(2 * num_samples, N)
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    score = torch.where(cand, rows, torch.full_like(rows, -1))
    top_scores, top_idx = topk_stable(score, work)  # descending index
    work_valid = top_scores >= 0
    kpts = src_pts[top_idx]
    nbr_idx = ball_query(kpts, src_pts, radius=nn_r, K=max_nn,
                         q_mask=work_valid, p_mask=src_mask)
    dense = torch.sum((nbr_idx >= 0).to(torch.int32), dim=-1) >= min_nn
    keep = work_valid & dense

    # the first num_samples kept, in descending-index order
    slots = torch.arange(work, dtype=torch.int32, device=dev)
    order_score = torch.where(keep, slots, torch.full_like(slots, work + 1))
    neg_top, sel = topk_stable(-order_score, num_samples)
    kp_mask = (-neg_top) <= work
    sel = torch.where(kp_mask, sel, torch.zeros_like(sel))
    kpts = kpts[sel]
    nbr_idx = torch.where(kp_mask[:, None], nbr_idx[sel],
                          torch.full_like(nbr_idx[sel], -1))
    tgt_kpts = apply_transform(gt, kpts)
    tnbr_idx = ball_query(tgt_kpts, tgt_pts, radius=nn_r, K=max_nn,
                          q_mask=kp_mask, p_mask=tgt_mask)
    truncated = (torch.sum(cand.to(torch.int32)) > work) & (
        torch.sum(keep.to(torch.int32)) < num_samples)
    return kpts, kp_mask, nbr_idx, tnbr_idx, tgt_kpts, truncated


def _intersection_ratio(a: torch.Tensor, b: torch.Tensor,
                        radius: float) -> torch.Tensor:
    """(P,) share of a's rows (P, K, 3) within `radius` of one of b's rows
    (P, K, 3), keypoint by keypoint: |a|^2 + |b|^2 - 2 a.b in fp32, as in
    JAX."""
    out = []
    r2 = torch.tensor(radius, dtype=torch.float32) ** 2
    for s in range(0, a.shape[0], _RATIO_CHUNK):
        x, y = a[s:s + _RATIO_CHUNK], b[s:s + _RATIO_CHUNK]
        d2 = (torch.sum(x * x, dim=-1)[..., :, None]
              + torch.sum(y * y, dim=-1)[..., None, :]
              - 2.0 * (x @ y.transpose(-1, -2)))
        near = torch.amin(d2, dim=-1) <= r2.to(a.device)
        out.append(torch.mean(near.to(torch.float32), dim=-1))
    # each chunk copies r2 to the card
    host_read("train_keypoints.intersection_ratio", len(out), device=a.device)
    if not out:
        return torch.zeros((0,), dtype=torch.float32, device=a.device)
    return torch.cat(out)


def generate_training_umes(
    src_pts: torch.Tensor,
    src_seg: torch.Tensor,
    src_feat: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_pts: torch.Tensor,
    tgt_feat: torch.Tensor,
    tgt_mask: torch.Tensor,
    gt_tform: torch.Tensor,
    num_samples: int = 256,
    max_nn: int = 750,
    min_nn: int = 300,
    nn_r: float = 5.0,
    nn_intersection_r: float = 0.6,
    flat_labels: Tuple[int, ...] = (9,),
    normalize: bool = True,
) -> TrainKeypoints:
    """Training keypoints and UMEs of B pairs: points (B, N, 3), labels
    (B, N), features (B, N, C) (gradients flow to them), masks (B, N),
    gt_tform (B, 4, 4)."""
    B = src_pts.shape[0]
    src_pts = src_pts.to(torch.float32)
    tgt_pts = tgt_pts.to(torch.float32)
    gt_tform = gt_tform.to(torch.float32)
    with torch.no_grad(), span("step.keypoints"):
        picks = [_select(src_pts[b], src_seg[b], src_mask[b], tgt_pts[b],
                         tgt_mask[b], gt_tform[b], num_samples, max_nn,
                         min_nn, nn_r, nn_intersection_r, flat_labels)
                 for b in range(B)]
        kpts, kp_mask, nbr_idx, tnbr_idx, tgt_kpts, truncated = (
            torch.stack(x) for x in zip(*picks))

    with span("step.umes"):
        nn_pts = gather_padded(src_pts, nbr_idx)  # (B, K, max_nn, 3)
        nn_feat = gather_padded(src_feat, nbr_idx)
        src_ume = moment_matrix(nn_pts, nn_feat, normalize=normalize)
        tnn_pts = gather_padded(tgt_pts, tnbr_idx)
        tnn_feat = gather_padded(tgt_feat, tnbr_idx)
        tgt_ume = moment_matrix(tnn_pts, tnn_feat, normalize=normalize)
        with torch.no_grad():
            K = kpts.shape[1]
            nn_tf = apply_transform(gt_tform[:, None], nn_pts)
            ratio = _intersection_ratio(
                nn_tf.reshape((B * K,) + nn_tf.shape[2:]),
                tnn_pts.reshape((B * K,) + tnn_pts.shape[2:]),
                nn_intersection_r).reshape(B, K) * kp_mask
    km = kp_mask.to(torch.float32)
    return TrainKeypoints(
        src_ume=src_ume * km[..., None, None],
        tgt_ume=tgt_ume * km[..., None, None],
        src_kpts=kpts * km[..., None], tgt_kpts=tgt_kpts * km[..., None],
        kp_mask=kp_mask, nn_intersection_ratio=ratio,
        approx_truncated=truncated)
