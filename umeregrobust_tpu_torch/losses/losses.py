"""Training losses (port of umeregrobust_tpu/losses/losses.py): pointwise
InfoNCE, UME-contrastive and cube-registration.

Each loss takes one pair or a leading pair axis (any leading dims) and
returns per-pair values. Invalid keypoints and matches are excluded by
masks, as in the JAX package, and every epsilon guard of the JAX code is
kept: each one keeps a gradient finite (a zero row under a norm, a zero
distance under a square root). Where JAX's functions guard a degenerate
case inside the library, the port guards it itself:
- `jax.nn.logsumexp` of a row with no finite entry has zero gradients;
  torch's gives NaN (exp(-inf - -inf)), so a row with no valid column
  takes zeros before the reduction (`_masked_logsumexp`);
- `jnp.nanmedian` averages the two middle values of an even count;
  `torch.nanmedian` returns the lower one, so medians are taken with
  `nanmedian_mean`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from umeregrobust_tpu_torch.core.transforms import relative_rotation_error
from umeregrobust_tpu_torch.core.ume import (
    estimate_rigid_from_ume, subspace_projection, ume_validity_mask)
from umeregrobust_tpu_torch.ops.neighbors import gather_padded, take_rows
from umeregrobust_tpu_torch.utils.profiling import host_read

__all__ = ["pointwise_infonce", "ume_contrastive_loss",
           "cube_registration_loss", "CUBE_CORNERS", "nanmedian_mean"]

CUBE_CORNERS = np.array(
    [
        [-1, 1, 1], [1, 1, 1], [-1, -1, 1], [1, -1, 1],
        [-1, 1, -1], [1, 1, -1], [-1, -1, -1], [1, -1, -1],
    ],
    dtype=np.float32,
)


def nanmedian_mean(x: torch.Tensor) -> torch.Tensor:
    """Median over the last dim ignoring NaNs, the two middle values
    averaged for an even count (jnp.nanmedian); NaN where all are NaN."""
    return torch.nanquantile(x, 0.5, dim=-1)


def pointwise_infonce(src_feat: torch.Tensor, src_pts: torch.Tensor,
                      tgt_feat: torch.Tensor, matches: torch.Tensor,
                      match_mask: torch.Tensor, tau: float = 0.1,
                      neg_euclid_dist: float = 5.0) -> torch.Tensor:
    """InfoNCE over ground-truth matches ([B,] M, 2) [src, tgt]: anchors
    are matched source features, positives their target features,
    negatives the other positives whose anchor lies > neg_euclid_dist
    away. Returns ([B],) losses."""
    # feature rows through gather_padded: the gather_rows kernel on the
    # card, with its deterministic backward
    anchor = gather_padded(src_feat, matches[..., 0])
    pos = gather_padded(tgt_feat, matches[..., 1])
    anchor_pts = take_rows(src_pts.to(torch.float32),
                           matches[..., 0].to(torch.int64))

    def _norm(x):
        # rsqrt(sum^2 + eps): finite at an exactly-zero row
        return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)

    d_pos = torch.sum(_norm(anchor) * _norm(pos), dim=-1, keepdim=True)
    D = anchor @ pos.transpose(-1, -2)
    D_cat = torch.cat([d_pos, D], dim=-1)
    sq = torch.sum(anchor_pts ** 2, dim=-1)
    d_euc2 = (sq[..., :, None] + sq[..., None, :]
              - 2 * (anchor_pts @ anchor_pts.transpose(-1, -2)))
    far = d_euc2 > neg_euclid_dist ** 2
    neg_mask = torch.cat([torch.ones_like(match_mask[..., :, None]),
                          far & match_mask[..., None, :]], dim=-1
                         ).to(torch.float32)
    denom = torch.sum(torch.exp(D_cat / tau) * neg_mask, dim=-1)
    loss = -torch.log(torch.exp(d_pos[..., 0] / tau) / (denom + 1e-12)
                      + 1e-12)
    m = match_mask.to(torch.float32)
    return torch.sum(loss * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1),
                                                     min=1.0)


def _masked_logsumexp(logits: torch.Tensor, col_ok: torch.Tensor
                      ) -> torch.Tensor:
    """logsumexp over the last dim of logits with the columns where
    col_ok (broadcast) is False left out, as jax.nn.logsumexp of the
    -inf-masked logits: -inf, with zero gradients, for a row with no
    column left."""
    ok = col_ok.expand(logits.shape)
    any_ok = torch.any(ok, dim=-1, keepdim=True)
    safe = torch.where(ok, logits, torch.where(
        any_ok, torch.full_like(logits, -torch.inf),
        torch.zeros_like(logits)))
    out = torch.logsumexp(safe, dim=-1)
    return torch.where(any_ok[..., 0], out, torch.full_like(out, -torch.inf))


def ume_contrastive_loss(src_ume: torch.Tensor, tgt_ume: torch.Tensor,
                         kp_mask: torch.Tensor, tau: float = 0.1,
                         tau_neg: float = 0.1, svd_thr: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contrastive cross-entropy over UME subspace similarities sim = (r
    - 2 D) / r, r = sqrt(4), positives on the diagonal at temperature
    tau, negatives tau_neg; keypoints whose UME is rank-deficient on
    either side are masked out. UMEs ([B,] K, C, 4). Returns (([B],)
    losses, ([B,] K) effective keypoint mask)."""
    with torch.no_grad():
        valid = (kp_mask & ume_validity_mask(src_ume, svd_thr)
                 & ume_validity_mask(tgt_ume, svd_thr))
    K = src_ume.shape[-3]
    P1 = subspace_projection(src_ume).flatten(-2)
    P2 = subspace_projection(tgt_ume).flatten(-2)
    d2 = torch.clamp(torch.sum(P1 * P1, dim=-1)[..., :, None]
                     + torch.sum(P2 * P2, dim=-1)[..., None, :]
                     - 2 * (P1 @ P2.transpose(-1, -2)), min=0.0)
    # +eps under the sqrt: a finite gradient where d2 == 0
    D = torch.sqrt(d2 + 1e-12) / np.sqrt(2.0)
    r = float(np.sqrt(np.float32(src_ume.shape[-1])))
    sim = (r - 2.0 * D) / r
    eye = torch.eye(K, dtype=torch.bool, device=sim.device)
    tau_mat = torch.where(eye, torch.tensor(tau, device=sim.device),
                          torch.tensor(tau_neg, device=sim.device))
    host_read("losses.ume_contrastive", 2, device=sim.device)  # copies
    logits = sim / tau_mat
    col_ok = valid[..., None, :]
    logits = torch.where(col_ok, logits, torch.full_like(logits, -torch.inf))
    logZ = _masked_logsumexp(logits, col_ok)
    diag = torch.diagonal(logits, dim1=-2, dim2=-1)
    ce = -(diag - logZ)
    m = valid.to(torch.float32)
    loss = torch.sum(torch.where(valid, ce, torch.zeros_like(ce)), dim=-1) \
        / torch.clamp(torch.sum(m, dim=-1), min=1.0)
    return loss, valid


def cube_registration_loss(src_ume: torch.Tensor, tgt_ume: torch.Tensor,
                           kp_mask: torch.Tensor, gt_tform: torch.Tensor,
                           nn_intersection_ratio: torch.Tensor,
                           cube_scale: float = 30.0,
                           nn_inter_ratio_thr: float = 0.75
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """A closed-form transform a keypoint, the mean L2 error of the cube's
    transformed corners against ground truth, averaged over keypoints
    with intersection ratio >= thr (over those at or above the ratios'
    median when none qualifies). UMEs ([B,] K, C, 4), gt_tform ([B,] 4,
    4). Returns (([B],) loss, ([B,] K) rre in degrees, ([B,] K) rte)."""
    lead = src_ume.shape[:-3]
    K = src_ume.shape[-3]
    T, _ = estimate_rigid_from_ume(src_ume.reshape((-1,) + src_ume.shape[-2:]),
                                   tgt_ume.reshape((-1,) + tgt_ume.shape[-2:]),
                                   compute_distance=False)
    T = T.reshape(lead + (K, 4, 4))
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    gt_tform = gt_tform.to(torch.float32)
    R_gt = gt_tform[..., :3, :3]
    t_gt = gt_tform[..., :3, 3]
    cube = torch.as_tensor(CUBE_CORNERS, device=src_ume.device) * cube_scale
    host_read("losses.cube_registration", device=src_ume.device)
    est = cube @ R.transpose(-1, -2) + t[..., None, :]  # ([B,] K, 8, 3)
    gt = cube @ R_gt.transpose(-1, -2) + t_gt[..., None, :]  # ([B,] 8, 3)
    # sqrt(.. + eps): a finite gradient where est == gt
    per_kp = torch.mean(torch.sqrt(
        torch.sum((gt[..., None, :, :] - est) ** 2, dim=-1) + 1e-12), dim=-1)
    with torch.no_grad():
        ratio = torch.where(kp_mask, nn_intersection_ratio.to(torch.float32),
                            torch.full_like(per_kp, -1.0))
        cond = (ratio >= nn_inter_ratio_thr) & kp_mask
        med = torch.nan_to_num(nanmedian_mean(torch.where(
            kp_mask, ratio, torch.full_like(ratio, torch.nan))), nan=0.0)
        fallback = (ratio >= med[..., None]) & kp_mask
        use = torch.where(torch.any(cond, dim=-1, keepdim=True), cond,
                          fallback)
        w = use.to(torch.float32)
        rre = relative_rotation_error(R_gt[..., None, :, :].expand(R.shape), R)
        rte = torch.linalg.vector_norm(t - t_gt[..., None, :], dim=-1)
    loss = torch.sum(per_kp * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1),
                                                       min=1.0)
    return loss, rre, rte
