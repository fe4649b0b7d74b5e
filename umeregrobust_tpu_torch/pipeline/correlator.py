"""Kernel-correlation hypothesis scoring, radius mode (port of the radius
parts of umeregrobust_tpu/pipeline/correlator.py; the kNN-20 mode is not
ported yet).

  m        = mean feature over src + tgt
  w_p      = mean kNN(50, self excluded) feature-difference norm per point
  f~       = (f - m) * w_p
  score(T) = sum_i sum_j 1[d <= 2 sigma] cauchy(d, sigma) <f~_i, g~_j> / N_src,
             d = |T p_i - q_j|

Scores run in the CUDA kernel ops/cuda_corr (plain version on CPU
tensors). select_best_transform runs the triage -> coarse -> exact
cascade on random subsets (drawn from a generator, or injected);
select_best_transform_batched runs it over a leading pair axis, one
kernel launch a stage for the batch. The other functions take an optional
leading pair axis as they are.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from umeregrobust_tpu_torch.ops.cuda_corr import (
    corr_scores_fused, corr_scores_plain)
from umeregrobust_tpu_torch.ops.neighbors import (
    gather_padded, knn, pairwise_sqdist, take_rows, topk_stable)
from umeregrobust_tpu_torch.pipeline.sampling import (
    injected_batched, subset_batched)

__all__ = ["cauchy_kernel", "feature_spatial_var", "prepare_weighted_features",
           "correlator_scores_radius", "correlator_scores_radius_fused",
           "select_best_transform", "select_best_transform_batched"]


def cauchy_kernel(e: torch.Tensor, k: float = 0.1) -> torch.Tensor:
    """1 / (1 + (e/k)^2)."""
    return 1.0 / (1.0 + (e / k) ** 2)


def feature_spatial_var(pts: torch.Tensor, feat: torch.Tensor,
                        mask: torch.Tensor, k: int = 50,
                        anchors: Optional[int] = None) -> torch.Tensor:
    """Mean feature-difference norm over the k-1 nearest neighbours (self
    excluded), exact top-k. anchors=M < N: computed on the first M rows and
    transferred to every point by nearest anchor. ([B,] N)."""
    if anchors is not None and anchors < pts.shape[-2]:
        a_pts, a_mask = pts[..., :anchors, :], mask[..., :anchors]
        _, idx = knn(a_pts, pts, K=k, q_mask=a_mask, p_mask=mask)
        diff = feat[..., :anchors, None, :] - gather_padded(feat,
                                                            idx[..., 1:])
        w_a = torch.mean(torch.linalg.vector_norm(diff, dim=-1), dim=-1) \
            * a_mask
        d2 = pairwise_sqdist(pts, a_pts)
        d2 = torch.where(a_mask[..., None, :], d2, torch.full_like(d2, 1e30))
        return torch.gather(w_a, -1, torch.argmin(d2, dim=-1)) * mask
    _, idx = knn(pts, pts, K=k, q_mask=mask, p_mask=mask)
    diff = feat[..., :, None, :] - gather_padded(feat, idx[..., 1:])
    return torch.mean(torch.linalg.vector_norm(diff, dim=-1), dim=-1) * mask


def prepare_weighted_features(src_pts, src_feat, src_mask, tgt_pts, tgt_feat,
                              tgt_mask, var_knn: int = 50,
                              var_anchors: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint-mean-centred, spatial-variance-weighted features."""
    m_all = torch.cat([src_mask, tgt_mask], dim=-1).to(torch.float32)
    f_all = torch.cat([src_feat, tgt_feat], dim=-2)
    m = torch.sum(f_all * m_all[..., None], dim=-2) / torch.clamp(
        torch.sum(m_all, dim=-1), min=1.0)[..., None]
    w_src = feature_spatial_var(src_pts, src_feat, src_mask, k=var_knn,
                                anchors=var_anchors)
    w_tgt = feature_spatial_var(tgt_pts, tgt_feat, tgt_mask, k=var_knn,
                                anchors=var_anchors)
    m = m[..., None, :]
    fs = (src_feat - m) * w_src[..., None] * src_mask[..., None]
    ft = (tgt_feat - m) * w_tgt[..., None] * tgt_mask[..., None]
    return fs, ft


def _radius_inputs(src_pts, src_featw, src_mask, tgt_pts, tgt_featw, tgt_mask,
                   Ts):
    """Kernel operands: ([B,] H, S, 4) transformed source points, masked
    features, ([B,] T, 4) target points."""
    R = Ts[..., :3, :3].to(torch.float32)
    t = Ts[..., :3, 3].to(torch.float32)
    pts_t = (src_pts.to(torch.float32)[..., None, :, :] @ R.transpose(-1, -2)
             + t[..., None, :])
    pad = torch.zeros(pts_t.shape[:-1] + (1,), dtype=torch.float32,
                      device=pts_t.device)
    pts_t4 = torch.cat([pts_t, pad], dim=-1).contiguous()
    tp4 = torch.cat([tgt_pts.to(torch.float32),
                     torch.zeros(tgt_pts.shape[:-1] + (1,),
                                 dtype=torch.float32, device=pts_t.device)],
                    dim=-1)
    sf = (src_featw * src_mask[..., None]).to(torch.float32).contiguous()
    tf = (tgt_featw * tgt_mask[..., None]).to(torch.float32).contiguous()
    return pts_t4, sf, tp4.contiguous(), tf


def correlator_scores_radius(src_pts, src_featw, src_mask, tgt_pts, tgt_featw,
                             tgt_mask, Ts, sigma: float = 1.5,
                             radius_factor: float = 2.0) -> torch.Tensor:
    """Radius-capped scores ([B,] H) by the plain PyTorch path on any
    device."""
    scores = corr_scores_plain(
        *_radius_inputs(src_pts, src_featw, src_mask, tgt_pts, tgt_featw,
                        tgt_mask, Ts), sigma=sigma, radius_factor=radius_factor)
    return scores / src_pts.shape[-2]


def correlator_scores_radius_fused(src_pts, src_featw, src_mask, tgt_pts,
                                   tgt_featw, tgt_mask, Ts, sigma: float = 1.5,
                                   radius_factor: float = 2.0) -> torch.Tensor:
    """Radius-capped scores ([B,] H) through the CUDA kernel (plain version
    on CPU tensors)."""
    scores = corr_scores_fused(
        *_radius_inputs(src_pts, src_featw, src_mask, tgt_pts, tgt_featw,
                        tgt_mask, Ts), sigma=sigma, radius_factor=radius_factor)
    return scores / src_pts.shape[-2]


def _score(mode, *a, sigma=1.5):
    if mode != "radius":
        raise NotImplementedError("corr_mode='knn' is not ported yet")
    return correlator_scores_radius_fused(*a, sigma=sigma)


def select_best_transform(
    src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
    Ts: torch.Tensor,
    sigma: float,
    var_knn: int = 50,
    coarse_src: Optional[int] = 1024,
    coarse_tgt: Optional[int] = None,
    rescore_top: int = 64,
    generator: Optional[torch.Generator] = None,
    mode: str = "radius",
    triage_src: Optional[int] = None,
    triage_tgt: Optional[int] = None,
    triage_top: int = 512,
    extra_Ts: Optional[torch.Tensor] = None,
    prepared: bool = False,
    var_anchors: Optional[int] = None,
    draws: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score all hypotheses and return (best_T, scores (H,), -inf where a
    hypothesis was not scored at full resolution).

    Triage (triage_src set, H > triage_top): score all hypotheses on a
    (triage_src x triage_tgt) subsample, keep the best triage_top. Coarse
    (coarse_src < S, H > rescore_top): score on a (coarse_src x coarse_tgt)
    subsample, keep rescore_top for the exact pass (plus extra_Ts).
    Subsets come from `draws` ("triage_src", "triage_tgt", "coarse_src",
    "coarse_tgt") when injected, else from `generator`. Top-k ties go to
    the lower index, as in the JAX package. The one-pair view of
    select_best_transform_batched.
    """
    best, scores = select_best_transform_batched(
        *(x[None] for x in (src_pts, src_feat, src_mask, tgt_pts, tgt_feat,
                            tgt_mask, Ts)), sigma=sigma, var_knn=var_knn,
        coarse_src=coarse_src, coarse_tgt=coarse_tgt,
        rescore_top=rescore_top, generators=[generator], mode=mode,
        triage_src=triage_src, triage_tgt=triage_tgt, triage_top=triage_top,
        extra_Ts=None if extra_Ts is None else extra_Ts[None],
        prepared=prepared, var_anchors=var_anchors, draws=[draws])
    return best[0], scores[0]


def select_best_transform_batched(
    src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
    Ts: torch.Tensor,
    sigma: float,
    var_knn: int = 50,
    coarse_src: Optional[int] = 1024,
    coarse_tgt: Optional[int] = None,
    rescore_top: int = 64,
    generators: Optional[Sequence] = None,
    mode: str = "radius",
    triage_src: Optional[int] = None,
    triage_tgt: Optional[int] = None,
    triage_top: int = 512,
    extra_Ts: Optional[torch.Tensor] = None,
    prepared: bool = False,
    var_anchors: Optional[int] = None,
    draws: Optional[Sequence] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """select_best_transform over a leading pair axis B: clouds (B, S, ..)
    and (B, T, ..), Ts (B, H, 4, 4), extra_Ts (B, E, 4, 4); returns (best_T
    (B, 4, 4), scores (B, H)). Every stage scores all pairs in one kernel
    launch; pair b's subsets come from draws[b] or generators[b], in the
    order a single pair draws them."""
    if prepared:
        fs, ft = src_feat, tgt_feat
    else:
        fs, ft = prepare_weighted_features(
            src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
            var_knn=var_knn, var_anchors=var_anchors)
    dev = src_pts.device
    B, S = src_pts.shape[:2]
    Tn, H = tgt_pts.shape[1], Ts.shape[1]
    generators = generators if generators is not None else [None] * B
    draws = draws if draws is not None else [None] * B

    def subset(name, n_all, k):
        return subset_batched(n_all, k, generators, dev,
                              injected_batched(draws, name, k, dev))

    def cut(sel, *xs):
        return [take_rows(x, sel) for x in xs]

    full_idx = None
    if triage_src is not None and triage_src < S and H > triage_top:
        ssel = subset("triage_src", S, triage_src)
        ttp, ttf, ttm = tgt_pts, ft, tgt_mask
        if triage_tgt is not None and triage_tgt < Tn:
            ttp, ttf, ttm = cut(subset("triage_tgt", Tn, triage_tgt),
                                tgt_pts, ft, tgt_mask)
        tri = _score(mode, *cut(ssel, src_pts, fs, src_mask), ttp, ttf, ttm,
                     Ts, sigma=sigma)
        _, full_idx = topk_stable(tri, triage_top)
        Ts = take_rows(Ts, full_idx)
    if coarse_src is not None and coarse_src < S and H > rescore_top:
        sel = subset("coarse_src", S, coarse_src)
        ctp, ctf, ctm = tgt_pts, ft, tgt_mask
        if coarse_tgt is not None and coarse_tgt < Tn:
            ctp, ctf, ctm = cut(subset("coarse_tgt", Tn, coarse_tgt),
                                tgt_pts, ft, tgt_mask)
        coarse = _score(mode, *cut(sel, src_pts, fs, src_mask), ctp, ctf, ctm,
                        Ts, sigma=sigma)
        _, top_idx = topk_stable(coarse, rescore_top)
        Ts_top = take_rows(Ts, top_idx)
        if extra_Ts is not None:
            Ts_top = torch.cat([Ts_top, extra_Ts], dim=1)
        fine = _score(mode, src_pts, fs, src_mask, tgt_pts, ft, tgt_mask,
                      Ts_top, sigma=sigma)
        best = torch.argmax(fine, dim=-1)
        out_idx = top_idx if full_idx is None else take_rows(full_idx,
                                                             top_idx)
        scores = torch.full((B, H), -float("inf"), device=dev).scatter(
            1, out_idx, fine[:, :top_idx.shape[1]])
        return take_rows(Ts_top, best[:, None])[:, 0], scores
    n_main = Ts.shape[1]
    Ts_all = torch.cat([Ts, extra_Ts], dim=1) if extra_Ts is not None else Ts
    scores_all = _score(mode, src_pts, fs, src_mask, tgt_pts, ft, tgt_mask,
                        Ts_all, sigma=sigma)
    best_T = take_rows(Ts_all, torch.argmax(scores_all, dim=-1)[:, None])[:, 0]
    scores = scores_all[:, :n_main]
    if full_idx is not None:
        scores = torch.full((B, H), -float("inf"), device=dev).scatter(
            1, full_idx, scores)
    return best_T, scores
