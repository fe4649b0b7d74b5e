"""RT-UME keypoint layer (port of umeregrobust_tpu/pipeline/rtume.py):
closed-form transforms from the UME matrices of keypoint neighbourhoods,
the reference's ume_kp_layer (utils/loc_utils.py:357-431).

Each cloud's keypoints get m0-normalised UME matrices of their capped
ball (pipeline/ume_gen.ume_from_ball_query: kernel `ume_moments_fused`,
two launches a call), paired diagonally, as sums over random keypoint
triplets (loc_utils.py:406-410) or as the full n_kp x n_kp grid, then one
closed-form estimate a pair (core/ume.estimate_rigid_from_ume). On the
card the moments kernel serves 4C = 128 only, so features are C = 32
wide there (the network's width); the CPU takes any C.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from umeregrobust_tpu_torch.core.ume import estimate_rigid_from_ume
from umeregrobust_tpu_torch.devices import resolve_device, to_device
from umeregrobust_tpu_torch.pipeline.ume_gen import ume_from_ball_query

__all__ = ["rtume_estimate"]


def rtume_estimate(
    src_pts, src_feat, src_kp, tgt_pts, tgt_feat, tgt_kp,
    ume_knn: int = 750,
    ume_desc_rad: float = 5.0,
    diag_only: bool = True,
    n_rand: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    draws=None,
    src_mask=None,
    tgt_mask=None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Transforms from paired keypoint UMEs, on `device` (the card unless
    device="cpu"; raises without CUDA).

    Returns (T, D, G_kp, H_kp): diag_only -> T (n_kp, 4, 4), D (n_kp,);
    with n_rand (diag mode) G and H become sums over n_rand keypoint
    triplets, drawn from `generator` (a torch.Generator on `device`) or
    given as `draws` ((n_rand, 3) indices in [0, n_kp)), and T, D have
    leading size n_rand; the full grid (diag_only=False) gives T
    (n_kp, n_kp, 4, 4) and D (n_kp, n_kp), source keypoint first.
    """
    dev = resolve_device(device)
    f32 = torch.float32

    def ume(pts, feat, kp, mask):
        return ume_from_ball_query(
            to_device(pts, dev, f32), to_device(feat, dev, f32),
            to_device(kp, dev, f32), radius=ume_desc_rad, max_nn=ume_knn,
            p_mask=to_device(mask, dev, torch.bool))

    G_kp = ume(src_pts, src_feat, src_kp, src_mask)
    H_kp = ume(tgt_pts, tgt_feat, tgt_kp, tgt_mask)
    n_kp = G_kp.shape[0]

    if diag_only:
        G, H = G_kp, H_kp
        if n_rand is not None:
            if draws is not None:
                trip = to_device(draws, dev, torch.int64)
            else:
                trip = torch.randint(0, n_kp, (n_rand, 3), generator=generator,
                                     device=dev)
            G = G_kp[trip[:, 0]] + G_kp[trip[:, 1]] + G_kp[trip[:, 2]]
            H = H_kp[trip[:, 0]] + H_kp[trip[:, 1]] + H_kp[trip[:, 2]]
        T, D = estimate_rigid_from_ume(G, H)
        return T, D, G_kp, H_kp

    # the full grid: every source keypoint against every target keypoint
    d = G_kp.shape[1]
    G = G_kp[:, None].expand(n_kp, n_kp, d, 4).reshape(-1, d, 4)
    H = H_kp[None, :].expand(n_kp, n_kp, d, 4).reshape(-1, d, 4)
    T, D = estimate_rigid_from_ume(G, H)
    return T.reshape(n_kp, n_kp, 4, 4), D.reshape(n_kp, n_kp), G_kp, H_kp
