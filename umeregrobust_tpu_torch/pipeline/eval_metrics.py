"""Validation-time inlier-ratio metric (port of
umeregrobust_tpu/pipeline/eval_metrics.py; reference
utils/eval_utils.py:8-57): training keypoints and UMEs of both clouds,
rank-deficient ones dropped, a Hungarian assignment by subspace distance
(on the host, scipy, as in JAX), and the share of matches whose
ground-truth reprojection error is <= inlier_thr."""
from __future__ import annotations

import numpy as np
import torch

from umeregrobust_tpu_torch.core.transforms import apply_transform
from umeregrobust_tpu_torch.core.ume import (
    ume_pairwise_distance, ume_validity_mask)
from umeregrobust_tpu_torch.pipeline.matching import hungarian_match
from umeregrobust_tpu_torch.pipeline.train_keypoints import (
    generate_training_umes)

__all__ = ["calc_inlier_ratio"]


@torch.no_grad()
def calc_inlier_ratio(
    src_pts, src_seg, src_feat, src_mask,
    tgt_pts, tgt_feat, tgt_mask,
    gt_tform,
    ume_r_nn: float = 5.0,
    ume_max_nn: int = 750,
    ume_min_nn: int = 300,
    eval_num_kpts: int = 1000,
    inlier_thr: float = 0.6,
    nn_inter_thr: float = 0.6,
    svd_thr: float = 1e-5,
) -> float:
    """The inlier ratio of ONE pair (tensors without a pair axis, on one
    device)."""
    kp = generate_training_umes(
        src_pts[None], src_seg[None], src_feat[None], src_mask[None],
        tgt_pts[None], tgt_feat[None], tgt_mask[None], gt_tform[None],
        num_samples=eval_num_kpts, max_nn=ume_max_nn, min_nn=ume_min_nn,
        nn_r=ume_r_nn, nn_intersection_r=nn_inter_thr, flat_labels=(),
        normalize=False)
    su, tu = kp.src_ume[0], kp.tgt_ume[0]
    valid = (kp.kp_mask[0] & ume_validity_mask(su, svd_thr)
             & ume_validity_mask(tu, svd_thr))
    if int(valid.sum()) < 2:
        return 0.0
    D = ume_pairwise_distance(su[valid], tu[valid])
    m = torch.as_tensor(hungarian_match(D.cpu().numpy()), device=D.device)
    src_kp = kp.src_kpts[0][valid][m[:, 0]]
    tgt_kp = kp.tgt_kpts[0][valid][m[:, 1]]
    src_tf = apply_transform(gt_tform.to(torch.float32), src_kp)
    reproj = torch.linalg.vector_norm(tgt_kp - src_tf, dim=-1)
    return float(np.mean((reproj <= inlier_thr).cpu().numpy()))
