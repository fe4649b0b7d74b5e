"""Per-pair registration from per-voxel features (port of
umeregrobust_tpu/pipeline/registration.py, round one and the consensus
gate):

  1. sample keypoints on each SEM-voxelized cloud,
  2. capped ball-query UME matrices around them,
  3. argmin subspace-distance matching and the match filter,
  4. one closed-form transform hypothesis per kept match,
  5. kernel-correlation selection (triage -> coarse -> exact) on the
     correlator clouds, whose features are copied from the SEM grid by
     exact 1-NN,
  6. the consensus rescue when the winner's match support is fragmented,
  7. point-to-point ICP on the dense grid.

Random draws come from a torch.Generator, or are injected through
`draws` ("src_kp", "tgt_kp", "filter", and the correlator's subsets).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from umeregrobust_tpu_torch.core.ume import estimate_rigid_from_ume
from umeregrobust_tpu_torch.ops.cuda_nn import nn1_argmin
from umeregrobust_tpu_torch.ops.densegrid import build_dense_grid
from umeregrobust_tpu_torch.ops.neighbors import gather_padded, topk_stable
from umeregrobust_tpu_torch.pipeline.consensus import (
    compact_structure, consensus_refit, polish_candidates)
from umeregrobust_tpu_torch.pipeline.correlator import (
    _score, prepare_weighted_features, select_best_transform)
from umeregrobust_tpu_torch.pipeline.icp import icp_loop
from umeregrobust_tpu_torch.pipeline.matching import (
    argmin_match, probabilistic_match_filter)
from umeregrobust_tpu_torch.pipeline.sampling import injected, weighted_sample
from umeregrobust_tpu_torch.pipeline.ume_gen import ume_from_ball_query

__all__ = ["RegistrationConfig", "RegistrationResult", "check_supported",
           "copy_features_to_raw", "refine_with_icp", "register_pair_features"]


@dataclass(frozen=True)
class RegistrationConfig:
    """The JAX package's knobs, same names and defaults (see
    umeregrobust_tpu/pipeline/registration.py for each one's rationale),
    so configs carry over unchanged. Knobs whose paths are not ported yet
    raise NotImplementedError at run time (`check_supported`)."""

    ume_r_nn: float = 5.0
    ume_max_nn: int = 750
    ume_n_samples: int = 2500
    num_init_keypoints: int = 10000
    filter_by_ume_dist: bool = True
    tau: float = 0.05
    filter_mode: str = "prob"  # 'prob' | 'topk' | 'mix'
    corr_kernel_sigma: float = 1.5
    corr_knn: int = 20
    corr_var_knn: int = 50
    corr_var_anchors: Optional[int] = 1024
    corr_coarse_src: Optional[int] = 1024
    corr_coarse_tgt: Optional[int] = None
    corr_rescore_top: int = 64
    corr_triage_src: Optional[int] = 256
    corr_triage_tgt: Optional[int] = 512
    corr_triage_top: int = 512
    corr_mode: str = "radius"
    consensus_cands: int = 16
    consensus_tau: float = 2.0
    consensus_nms_rot_deg: float = 15.0
    consensus_nms_trans: float = 5.0
    consensus_polish_rows: int = 256
    consensus_polish_radii: Tuple[float, ...] = (1.0, 0.45)
    consensus_polish_inner: int = 4
    consensus_struct_cap: int = 2048
    consensus_gate_inliers: float = 0.0
    consensus_gate_radius: float = 0.6
    sr_kpts: int = 0
    sr_hyps: int = 512
    sr_overlap_radius: float = 2.0
    sr_gate_inliers: float = 0.4
    sr_cands: int = 8
    estimator_sweeps: int = 3
    icp_max_corr: float = 0.2
    icp_max_iter: int = 200
    icp_coarse_corr: Optional[float] = None
    icp_coarse_iter: int = 25
    icp_budget: int = 8
    icp_raw_iter: int = 12
    icp_raw_budget: int = 24
    icp_multires: int = 1024
    icp_multires_iter: int = 40
    icp_multires_budget: int = 8
    icp_exact_rows: int = 0
    icp_disp_exit: float = 1e-3
    icp_dims: Tuple[int, int, int] = (384, 384, 96)
    icp_grid_scale: float = 1.0
    icp_inner: int = 6
    feat_copy_radius: Optional[float] = None
    feat_copy_budget: int = 16
    feat_copy_dims: Tuple[int, int, int] = (256, 256, 64)
    kp_struct_boost: float = 0.0
    kp_struct_dz: float = 0.35


class RegistrationResult(NamedTuple):
    T_init: torch.Tensor  # (4, 4) correlator-selected hypothesis
    T_refined: torch.Tensor  # (4, 4) after ICP
    icp_rmse: torch.Tensor
    icp_fitness: torch.Tensor


def check_supported(cfg: RegistrationConfig) -> None:
    """Raise NotImplementedError for knobs whose paths are not ported."""
    unported = {
        "sr_kpts > 0 (second round)": cfg.sr_kpts > 0,
        "feat_copy_radius (grid feature copy)": cfg.feat_copy_radius is not None,
        "corr_mode='knn'": cfg.corr_mode != "radius",
        "filter_by_ume_dist=False": not cfg.filter_by_ume_dist,
        "icp_inner=1": cfg.icp_inner < 2,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError("not ported yet: " + ", ".join(bad))
    if cfg.filter_mode not in ("prob", "topk", "mix"):
        raise ValueError(f"unknown filter_mode {cfg.filter_mode!r}")


def _sample_keypoints(pts, mask, n, generator, idx=None, struct_boost=0.0,
                      struct_dz=0.35):
    """n keypoints without replacement, uniform over valid rows (or
    structure-biased by struct_boost). Returns (pts[idx], mask[idx]);
    surplus slots on small clouds land on padded rows and come back
    masked. `idx` injects the draw."""
    if idx is None:
        p = mask.to(torch.float32)
        if struct_boost > 0.0:
            grid_dim = 64
            big = 1e9
            lo = torch.min(torch.where(mask[:, None], pts[:, :2],
                                       torch.full_like(pts[:, :2], big)),
                           dim=0).values
            hi = torch.max(torch.where(mask[:, None], pts[:, :2],
                                       torch.full_like(pts[:, :2], -big)),
                           dim=0).values
            cell = torch.clamp(torch.max(hi - lo) / (grid_dim - 1), min=2.0)
            cc = torch.floor(pts[:, :2] / cell).to(torch.int32)
            cc = cc - torch.min(torch.where(mask[:, None], cc, torch.full_like(
                cc, 1 << 20)), dim=0).values
            cc = torch.clamp(cc, 0, grid_dim - 1).to(torch.int64)
            flat = cc[:, 0] * grid_dim + cc[:, 1]
            minz = torch.full((grid_dim * grid_dim,), big, device=pts.device
                              ).scatter_reduce(0, flat, torch.where(
                                  mask, pts[:, 2], torch.full_like(
                                      pts[:, 2], big)), reduce="amin")
            is_struct = mask & (pts[:, 2] - minz[flat] > struct_dz)
            p = p * (1.0 + struct_boost * is_struct.to(torch.float32))
        idx = weighted_sample(p / torch.clamp(torch.sum(p), min=1.0), n,
                              generator)
    return pts[idx], mask[idx]


def copy_features_to_raw(raw_pts, raw_mask, sem_pts, sem_feat, sem_mask):
    """1-NN feature transfer from SEM grid points to correlator points
    (reference evaluate.py:272-275) through the nn1_argmin kernel."""
    idx = nn1_argmin(raw_pts.contiguous(), sem_pts.contiguous(),
                     sem_mask.contiguous())
    # a row copy through the gather_rows kernel; masked rows come out
    # zero (= sem_feat[idx] * raw_mask for finite features)
    return gather_padded(sem_feat, torch.where(raw_mask, idx,
                                               torch.full_like(idx, -1)))


def refine_with_icp(cfg: RegistrationConfig, T: torch.Tensor,
                    corr_src_pts, corr_src_mask, corr_tgt_pts, corr_tgt_mask,
                    raw_src_pts=None, raw_src_mask=None, raw_tgt_pts=None,
                    raw_tgt_mask=None, return_iters: bool = False):
    """The ICP schedule: optional coarse-radius stage -> multi-resolution
    stage -> exact correlator-cloud stage -> optional raw-cloud stage.
    Every stage indexes its target on one physical box (icp_dims cells at
    the fine radius). Returns (T, rmse, fitness[, per-stage iterations])."""
    fine = float(cfg.icp_max_corr)
    box = tuple(d * fine for d in cfg.icp_dims)

    def grid(pts, mask, radius):
        cell = float(radius) * float(cfg.icp_grid_scale)
        dims = tuple(int(math.ceil(b / cell - 1e-6)) for b in box)
        return build_dense_grid(pts, mask, cell=cell, dims=dims)

    stages = []
    if cfg.icp_coarse_corr is not None:
        stages.append((grid(corr_tgt_pts, corr_tgt_mask, cfg.icp_coarse_corr),
                       float(cfg.icp_coarse_corr), int(cfg.icp_coarse_iter),
                       32, corr_src_pts, corr_src_mask))
    corr_grid = grid(corr_tgt_pts, corr_tgt_mask, fine)
    m = int(cfg.icp_multires)
    if m and m < corr_src_pts.shape[0]:
        stages.append((corr_grid, fine, int(cfg.icp_multires_iter),
                       int(cfg.icp_multires_budget), corr_src_pts[:m],
                       corr_src_mask[:m]))
    e = int(cfg.icp_exact_rows)
    if e and e < corr_src_pts.shape[0]:
        exact_sp, exact_smk = corr_src_pts[:e], corr_src_mask[:e]
    else:
        exact_sp, exact_smk = corr_src_pts, corr_src_mask
    stages.append((corr_grid, fine, int(cfg.icp_max_iter), int(cfg.icp_budget),
                   exact_sp, exact_smk))
    if raw_src_pts is not None and cfg.icp_raw_iter > 0:
        stages.append((grid(raw_tgt_pts, raw_tgt_mask, fine), fine,
                       int(cfg.icp_raw_iter), int(cfg.icp_raw_budget),
                       raw_src_pts, raw_src_mask))
    rmse = fit = torch.zeros((), dtype=torch.float32, device=T.device)
    iters = []
    for g, corr, n_iter, budget, sp, smk in stages:
        T, rmse, fit, it = icp_loop(sp, smk, g, T, corr, n_iter, budget,
                                    inner=int(cfg.icp_inner),
                                    disp_exit=float(cfg.icp_disp_exit))
        iters.append(it)
    if return_iters:
        return T, rmse, fit, iters
    return T, rmse, fit


def _hypotheses_and_select(cfg: RegistrationConfig,
                           src_pts, src_feat, src_mask,
                           tgt_pts, tgt_feat, tgt_mask,
                           corr_src_pts, corr_src_feat, corr_src_mask,
                           corr_tgt_pts, corr_tgt_feat, corr_tgt_mask,
                           generator: Optional[torch.Generator] = None,
                           draws: Optional[dict] = None):
    """Round one: keypoints -> UME -> matches -> hypotheses -> cascade,
    then the consensus rescue behind its gate (a Python branch on one
    host read). Returns (best_T, Ts, scores)."""
    dev = src_pts.device
    n_init = cfg.num_init_keypoints
    kw = dict(struct_boost=cfg.kp_struct_boost, struct_dz=cfg.kp_struct_dz)
    src_kp, src_kp_ok = _sample_keypoints(
        src_pts, src_mask, n_init, generator,
        idx=injected(draws, "src_kp", n_init, dev), **kw)
    tgt_kp, tgt_kp_ok = _sample_keypoints(
        tgt_pts, tgt_mask, n_init, generator,
        idx=injected(draws, "tgt_kp", n_init, dev), **kw)

    ume_src = ume_from_ball_query(
        src_pts, src_feat, src_kp, radius=cfg.ume_r_nn, max_nn=cfg.ume_max_nn,
        p_mask=src_mask, k_mask=src_kp_ok)
    ume_tgt = ume_from_ball_query(
        tgt_pts, tgt_feat, tgt_kp, radius=cfg.ume_r_nn, max_nn=cfg.ume_max_nn,
        p_mask=tgt_mask, k_mask=tgt_kp_ok)
    m, d = argmin_match(ume_src, ume_tgt, src_mask=src_kp_ok,
                        tgt_mask=tgt_kp_ok)

    n = cfg.ume_n_samples
    if cfg.filter_mode == "topk":
        keep = topk_stable(-d, n)[1]
    elif cfg.filter_mode == "mix":
        h = n // 2
        keep_top = topk_stable(-d, h)[1]
        d_rest = d.clone()
        d_rest[keep_top] = 1e6
        keep_s = probabilistic_match_filter(
            d_rest, n - h, cfg.tau, generator,
            idx=injected(draws, "filter", n - h, dev))
        keep = torch.cat([keep_top, keep_s])
    else:  # 'prob': reference parity (evaluate.py:233-245)
        keep = probabilistic_match_filter(
            d, n, cfg.tau, generator, idx=injected(draws, "filter", n, dev))

    m_keep = torch.clamp(m[keep], min=0)
    Ts, _ = estimate_rigid_from_ume(ume_src[keep], ume_tgt[m_keep],
                                    compute_distance=False,
                                    sweeps=cfg.estimator_sweeps)

    use_cons = cfg.consensus_cands > 0
    if use_cons:
        fs_w, ft_w = prepare_weighted_features(
            corr_src_pts, corr_src_feat, corr_src_mask,
            corr_tgt_pts, corr_tgt_feat, corr_tgt_mask,
            var_knn=cfg.corr_var_knn, var_anchors=cfg.corr_var_anchors)
    else:
        fs_w, ft_w = corr_src_feat, corr_tgt_feat
    best_T, scores = select_best_transform(
        corr_src_pts, fs_w, corr_src_mask, corr_tgt_pts, ft_w, corr_tgt_mask,
        Ts, sigma=cfg.corr_kernel_sigma, var_knn=cfg.corr_var_knn,
        coarse_src=cfg.corr_coarse_src, coarse_tgt=cfg.corr_coarse_tgt,
        rescore_top=cfg.corr_rescore_top, generator=generator,
        mode=cfg.corr_mode, triage_src=cfg.corr_triage_src,
        triage_tgt=cfg.corr_triage_tgt, triage_top=cfg.corr_triage_top,
        prepared=use_cons, var_anchors=cfg.corr_var_anchors, draws=draws)

    if use_cons:
        pair_ok = src_kp_ok[keep] & (d[keep] < 1e5)
        kp_s = src_kp[keep]
        kp_t = tgt_kp[m_keep]
        run = True
        if cfg.consensus_gate_inliers > 0.0:
            # inlier ratio of the winner over the matched keypoint set:
            # fragmented support is the regime the rescue stack wins
            mapped = kp_s @ best_T[:3, :3].T + best_T[:3, 3]
            err2 = torch.sum((mapped - kp_t) ** 2, dim=-1)
            r2 = torch.tensor(cfg.consensus_gate_radius ** 2,
                              dtype=torch.float32, device=dev)
            n_ok = torch.clamp(torch.sum(pair_ok.to(torch.float32)), min=1.0)
            inl = torch.sum((pair_ok & (err2 < r2)).to(torch.float32)) / n_ok
            run = bool(inl < cfg.consensus_gate_inliers)
        if run:
            cand = consensus_refit(
                Ts, kp_s, kp_t, pair_ok, tau=cfg.consensus_tau,
                n_cand=cfg.consensus_cands,
                nms_rot_deg=cfg.consensus_nms_rot_deg,
                nms_trans=cfg.consensus_nms_trans)
            cand = torch.cat([cand, best_T[None]], dim=0)
            rows = cfg.consensus_polish_rows
            pol = polish_candidates(
                cand, corr_src_pts[:rows], corr_src_mask[:rows],
                corr_tgt_pts, corr_tgt_mask,
                radii=cfg.consensus_polish_radii,
                inner=cfg.consensus_polish_inner)
            sp_c, sf_c, sm_c = compact_structure(
                corr_src_pts, fs_w, corr_src_mask,
                min(cfg.consensus_struct_cap, corr_src_pts.shape[0]))
            tp_c, tf_c, tm_c = compact_structure(
                corr_tgt_pts, ft_w, corr_tgt_mask,
                min(cfg.consensus_struct_cap, corr_tgt_pts.shape[0]))
            s_struct = _score(cfg.corr_mode, sp_c, sf_c, sm_c, tp_c, tf_c,
                              tm_c, pol, sigma=cfg.corr_kernel_sigma)
            best_T = pol[torch.argmax(s_struct)]
    return best_T, Ts, scores


def register_pair_features(
    cfg: RegistrationConfig,
    src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
    corr_src_pts, corr_src_feat, corr_src_mask,
    corr_tgt_pts, corr_tgt_feat, corr_tgt_mask,
    raw_src_pts=None, raw_src_mask=None, raw_tgt_pts=None, raw_tgt_mask=None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[dict] = None,
) -> RegistrationResult:
    """Register a pair given SEM-grid features and correlator clouds whose
    features were already copied (copy_features_to_raw). The two stages
    are torch.profiler ranges "hypotheses" and "icp"."""
    check_supported(cfg)
    with torch.profiler.record_function("hypotheses"):
        best_T, _, _ = _hypotheses_and_select(
            cfg, src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
            corr_src_pts, corr_src_feat, corr_src_mask,
            corr_tgt_pts, corr_tgt_feat, corr_tgt_mask,
            generator=generator, draws=draws)
    with torch.profiler.record_function("icp"):
        T_ref, rmse, fit = refine_with_icp(
            cfg, best_T, corr_src_pts, corr_src_mask, corr_tgt_pts,
            corr_tgt_mask, raw_src_pts, raw_src_mask, raw_tgt_pts,
            raw_tgt_mask)
    return RegistrationResult(T_init=best_T, T_refined=T_ref, icp_rmse=rmse,
                              icp_fitness=fit)
