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

Every stage runs over a leading pair axis (register_pair_features_batched:
B pairs of one shape, one kernel launch a call site for the batch);
register_pair_features is its one-pair view. Per pair stay only the random
draws (pair i from generators[i]) and nothing else: the consensus gate and
ICP's exit are read once for the batch. register_pair_hungarian is the
reference-parity path with a host-side Hungarian assignment.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from umeregrobust_tpu_torch.core.ume import (
    estimate_rigid_from_ume, ume_pairwise_distance)
from umeregrobust_tpu_torch.devices import resolve_device, to_device
from umeregrobust_tpu_torch.ops.cuda_nn import nn1_argmin
from umeregrobust_tpu_torch.ops.densegrid import build_dense_grid
from umeregrobust_tpu_torch.ops.neighbors import (
    gather_padded, take_rows, topk_stable)
from umeregrobust_tpu_torch.pipeline.consensus import (
    compact_structure, consensus_refit, height_above_floor,
    polish_candidates)
from umeregrobust_tpu_torch.pipeline.correlator import (
    _score, prepare_weighted_features, select_best_transform,
    select_best_transform_batched)
from umeregrobust_tpu_torch.pipeline.icp import icp_loop
from umeregrobust_tpu_torch.pipeline.matching import (
    argmin_match, hungarian_match, probabilistic_match_filter_batched)
from umeregrobust_tpu_torch.pipeline.sampling import (
    injected_batched, weighted_sample_batched)
from umeregrobust_tpu_torch.pipeline.ume_gen import ume_from_ball_query

__all__ = ["RegistrationConfig", "RegistrationResult", "check_supported",
           "copy_features_to_raw", "refine_with_icp", "register_pair_features",
           "register_pair_features_batched", "register_pair_hungarian"]


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
    T_init: torch.Tensor  # ([B,] 4, 4) correlator-selected hypothesis
    T_refined: torch.Tensor  # ([B,] 4, 4) after ICP
    icp_rmse: torch.Tensor  # ([B,])
    icp_fitness: torch.Tensor  # ([B,])


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


def _sample_keypoints(pts, mask, n, generators, fixed, struct_boost=0.0,
                      struct_dz=0.35):
    """n keypoints a pair without replacement, uniform over valid rows (or
    structure-biased by struct_boost): pts (B, N, 3), mask (B, N) ->
    (pts[idx], mask[idx]), (B, n, ..). Surplus slots on small clouds land
    on padded rows and come back masked. fixed[b] injects pair b's draw."""
    if any(f is None for f in fixed):
        p = mask.to(torch.float32)
        if struct_boost > 0.0:
            grid_dim = 64
            big = 1e9
            lo = torch.min(torch.where(mask[..., None], pts[..., :2],
                                       torch.full_like(pts[..., :2], big)),
                           dim=-2).values
            hi = torch.max(torch.where(mask[..., None], pts[..., :2],
                                       torch.full_like(pts[..., :2], -big)),
                           dim=-2).values
            cell = torch.clamp(torch.max(hi - lo, dim=-1).values
                               / (grid_dim - 1), min=2.0)
            is_struct = mask & (height_above_floor(
                pts, mask, cell[:, None, None], grid_dim) > struct_dz)
            p = p * (1.0 + struct_boost * is_struct.to(torch.float32))
        p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1.0)
        idx = weighted_sample_batched(p, n, generators, fixed)
    else:
        idx = torch.stack(fixed)
    return take_rows(pts, idx), take_rows(mask, idx)


def copy_features_to_raw(raw_pts, raw_mask, sem_pts, sem_feat, sem_mask):
    """1-NN feature transfer from SEM grid points to correlator points
    (reference evaluate.py:272-275) through the nn1_argmin kernel, over an
    optional leading pair axis (one launch of each kernel for the batch)."""
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
    the fine radius). Returns (T, rmse, fitness[, per-stage iterations]).

    With a leading pair axis (T (B, 4, 4), clouds (B, .., 3)) each stage
    runs until every pair has converged, converged pairs frozen, and the
    per-stage iterations are (B,) tensors. The window budgets are one for
    the batch: a pair's result is what it gets alone only while the budget
    covers its own windows (callers escalate cfg.icp_budget to the worst
    window of all pairs, pipeline/exactness.py)."""
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
    S = corr_src_pts.shape[-2]
    m = int(cfg.icp_multires)
    if m and m < S:
        stages.append((corr_grid, fine, int(cfg.icp_multires_iter),
                       int(cfg.icp_multires_budget),
                       corr_src_pts[..., :m, :], corr_src_mask[..., :m]))
    e = int(cfg.icp_exact_rows)
    if e and e < S:
        exact_sp, exact_smk = corr_src_pts[..., :e, :], corr_src_mask[..., :e]
    else:
        exact_sp, exact_smk = corr_src_pts, corr_src_mask
    stages.append((corr_grid, fine, int(cfg.icp_max_iter), int(cfg.icp_budget),
                   exact_sp, exact_smk))
    if raw_src_pts is not None and cfg.icp_raw_iter > 0:
        stages.append((grid(raw_tgt_pts, raw_tgt_mask, fine), fine,
                       int(cfg.icp_raw_iter), int(cfg.icp_raw_budget),
                       raw_src_pts, raw_src_mask))
    rmse = fit = torch.zeros(T.shape[:-2], dtype=torch.float32,
                             device=T.device)
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
                           generators: Sequence, draws: Sequence):
    """Round one over B pairs (every input with a leading pair axis):
    keypoints -> UME -> matches -> hypotheses -> cascade, then the
    consensus rescue behind its gate. The gate is read once for the batch
    (a Python branch on any(inlier ratio < gate)); when it fires the rescue
    runs for every pair and only the pairs whose own gate fired take its
    winner (JAX's lax.cond under vmap). Returns (best_T (B, 4, 4), Ts (B,
    H, 4, 4), scores (B, H))."""
    dev = src_pts.device
    n_init = cfg.num_init_keypoints
    kw = dict(struct_boost=cfg.kp_struct_boost, struct_dz=cfg.kp_struct_dz)
    src_kp, src_kp_ok = _sample_keypoints(
        src_pts, src_mask, n_init, generators,
        injected_batched(draws, "src_kp", n_init, dev), **kw)
    tgt_kp, tgt_kp_ok = _sample_keypoints(
        tgt_pts, tgt_mask, n_init, generators,
        injected_batched(draws, "tgt_kp", n_init, dev), **kw)

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
        d_rest = d.scatter(-1, keep_top, 1e6)
        keep_s = probabilistic_match_filter_batched(
            d_rest, n - h, cfg.tau, generators,
            injected_batched(draws, "filter", n - h, dev))
        keep = torch.cat([keep_top, keep_s], dim=-1)
    else:  # 'prob': reference parity (evaluate.py:233-245)
        keep = probabilistic_match_filter_batched(
            d, n, cfg.tau, generators,
            injected_batched(draws, "filter", n, dev))

    m_keep = torch.clamp(torch.gather(m, -1, keep), min=0)
    Ts, _ = estimate_rigid_from_ume(take_rows(ume_src, keep),
                                    take_rows(ume_tgt, m_keep),
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
    best_T, scores = select_best_transform_batched(
        corr_src_pts, fs_w, corr_src_mask, corr_tgt_pts, ft_w, corr_tgt_mask,
        Ts, sigma=cfg.corr_kernel_sigma, var_knn=cfg.corr_var_knn,
        coarse_src=cfg.corr_coarse_src, coarse_tgt=cfg.corr_coarse_tgt,
        rescore_top=cfg.corr_rescore_top, generators=generators,
        mode=cfg.corr_mode, triage_src=cfg.corr_triage_src,
        triage_tgt=cfg.corr_triage_tgt, triage_top=cfg.corr_triage_top,
        prepared=use_cons, var_anchors=cfg.corr_var_anchors, draws=draws)

    if use_cons:
        pair_ok = (torch.gather(src_kp_ok, -1, keep)
                   & (torch.gather(d, -1, keep) < 1e5))
        kp_s = take_rows(src_kp, keep)
        kp_t = take_rows(tgt_kp, m_keep)
        fire = None
        if cfg.consensus_gate_inliers > 0.0:
            # inlier ratio of the winner over the matched keypoint set:
            # fragmented support is the regime the rescue stack wins
            mapped = kp_s @ best_T[:, :3, :3].transpose(-1, -2) \
                + best_T[:, None, :3, 3]
            err2 = torch.sum((mapped - kp_t) ** 2, dim=-1)
            r2 = torch.tensor(cfg.consensus_gate_radius ** 2,
                              dtype=torch.float32, device=dev)
            n_ok = torch.clamp(torch.sum(pair_ok.to(torch.float32), dim=-1),
                               min=1.0)
            inl = torch.sum((pair_ok & (err2 < r2)).to(torch.float32),
                            dim=-1) / n_ok
            fire = inl < cfg.consensus_gate_inliers
        # the one host read of the gate, for the whole batch
        if fire is None or bool(torch.any(fire)):
            cand = consensus_refit(
                Ts, kp_s, kp_t, pair_ok, tau=cfg.consensus_tau,
                n_cand=cfg.consensus_cands,
                nms_rot_deg=cfg.consensus_nms_rot_deg,
                nms_trans=cfg.consensus_nms_trans)
            cand = torch.cat([cand, best_T[:, None]], dim=1)
            rows = cfg.consensus_polish_rows
            pol = polish_candidates(
                cand, corr_src_pts[:, :rows], corr_src_mask[:, :rows],
                corr_tgt_pts, corr_tgt_mask,
                radii=cfg.consensus_polish_radii,
                inner=cfg.consensus_polish_inner)
            sp_c, sf_c, sm_c = compact_structure(
                corr_src_pts, fs_w, corr_src_mask,
                min(cfg.consensus_struct_cap, corr_src_pts.shape[1]))
            tp_c, tf_c, tm_c = compact_structure(
                corr_tgt_pts, ft_w, corr_tgt_mask,
                min(cfg.consensus_struct_cap, corr_tgt_pts.shape[1]))
            s_struct = _score(cfg.corr_mode, sp_c, sf_c, sm_c, tp_c, tf_c,
                              tm_c, pol, sigma=cfg.corr_kernel_sigma)
            won = take_rows(pol, torch.argmax(s_struct, dim=-1)[:, None])[:, 0]
            best_T = won if fire is None else torch.where(
                fire[:, None, None], won, best_T)
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
    features were already copied (copy_features_to_raw): the one-pair view
    of register_pair_features_batched. The two stages are torch.profiler
    ranges "hypotheses" and "icp"."""
    args = [None if x is None else x[None] for x in (
        src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
        corr_src_pts, corr_src_feat, corr_src_mask, corr_tgt_pts,
        corr_tgt_feat, corr_tgt_mask, raw_src_pts, raw_src_mask, raw_tgt_pts,
        raw_tgt_mask)]
    res = register_pair_features_batched(cfg, *args, generators=[generator],
                                         draws=[draws])
    return RegistrationResult(*(x[0] for x in res))


def register_pair_features_batched(
    cfg: RegistrationConfig,
    src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
    corr_src_pts, corr_src_feat, corr_src_mask,
    corr_tgt_pts, corr_tgt_feat, corr_tgt_mask,
    raw_src_pts=None, raw_src_mask=None, raw_tgt_pts=None, raw_tgt_mask=None,
    generators: Optional[Sequence] = None,
    draws: Optional[Sequence] = None,
) -> RegistrationResult:
    """register_pair_features over a leading pair axis B (every array has
    it): pair b draws from generators[b] unless draws[b] injects, and gets
    what the one-pair call with that generator gives it. Returns
    (B, 4, 4) transforms and (B,) ICP rmse and fitness."""
    check_supported(cfg)
    B = src_pts.shape[0]
    generators = generators if generators is not None else [None] * B
    draws = draws if draws is not None else [None] * B
    if len(generators) != B or len(draws) != B:
        raise ValueError(f"{B} pairs need {B} generators and draws, got "
                         f"{len(generators)} and {len(draws)}")
    with torch.profiler.record_function("hypotheses"):
        best_T, _, _ = _hypotheses_and_select(
            cfg, src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
            corr_src_pts, corr_src_feat, corr_src_mask,
            corr_tgt_pts, corr_tgt_feat, corr_tgt_mask,
            generators=generators, draws=draws)
    with torch.profiler.record_function("icp"):
        T_ref, rmse, fit = refine_with_icp(
            cfg, best_T, corr_src_pts, corr_src_mask, corr_tgt_pts,
            corr_tgt_mask, raw_src_pts, raw_src_mask, raw_tgt_pts,
            raw_tgt_mask)
    return RegistrationResult(T_init=best_T, T_refined=T_ref, icp_rmse=rmse,
                              icp_fitness=fit)


# ---------------------------------------------------------------------------
# Hungarian parity mode (reference evaluate.py:216-222): the assignment is a
# host algorithm, so the path splits into a device phase (keypoints, UME,
# the full distance matrix), the host assignment and probabilistic filter
# (numpy), and a device phase (hypotheses, selection, ICP). D comes to the
# host once; the matches go back once.
# ---------------------------------------------------------------------------


def _ume_and_distance(cfg: RegistrationConfig, src_pts, src_feat, src_mask,
                      tgt_pts, tgt_feat, tgt_mask, generator=None,
                      draws: Optional[dict] = None):
    """Keypoints, UME matrices and the (n, n) subspace-distance matrix D
    of one pair; pairs of invalid keypoints sit at 1e3 (beyond any real
    distance, <= sqrt(8), and finite for the assignment)."""
    dev = src_pts.device
    n_init = (cfg.num_init_keypoints if cfg.filter_by_ume_dist
              else cfg.ume_n_samples)
    kw = dict(struct_boost=cfg.kp_struct_boost, struct_dz=cfg.kp_struct_dz)
    src_kp, src_kp_ok = _sample_keypoints(
        src_pts[None], src_mask[None], n_init, [generator],
        injected_batched([draws], "src_kp", n_init, dev), **kw)
    tgt_kp, tgt_kp_ok = _sample_keypoints(
        tgt_pts[None], tgt_mask[None], n_init, [generator],
        injected_batched([draws], "tgt_kp", n_init, dev), **kw)
    ume_src = ume_from_ball_query(
        src_pts, src_feat, src_kp[0], radius=cfg.ume_r_nn,
        max_nn=cfg.ume_max_nn, p_mask=src_mask, k_mask=src_kp_ok[0])
    ume_tgt = ume_from_ball_query(
        tgt_pts, tgt_feat, tgt_kp[0], radius=cfg.ume_r_nn,
        max_nn=cfg.ume_max_nn, p_mask=tgt_mask, k_mask=tgt_kp_ok[0])
    D = ume_pairwise_distance(ume_src, ume_tgt)
    D = torch.where(src_kp_ok[0][:, None] & tgt_kp_ok[0][None, :], D,
                    torch.full_like(D, 1e3))
    return ume_src, ume_tgt, D


def _select_from_matches(cfg: RegistrationConfig, ume_src, ume_tgt, m_src,
                         m_tgt, corr_src_pts, corr_src_feat, corr_src_mask,
                         corr_tgt_pts, corr_tgt_feat, corr_tgt_mask,
                         generator=None, draws: Optional[dict] = None):
    """One hypothesis a match, then the correlator cascade (features
    prepared inside, no consensus stage, as in the JAX path). Returns
    (best_T, scores)."""
    Ts, _ = estimate_rigid_from_ume(ume_src[m_src], ume_tgt[m_tgt],
                                    compute_distance=False,
                                    sweeps=cfg.estimator_sweeps)
    return select_best_transform(
        corr_src_pts, corr_src_feat, corr_src_mask,
        corr_tgt_pts, corr_tgt_feat, corr_tgt_mask,
        Ts, sigma=cfg.corr_kernel_sigma, var_knn=cfg.corr_var_knn,
        coarse_src=cfg.corr_coarse_src, coarse_tgt=cfg.corr_coarse_tgt,
        rescore_top=cfg.corr_rescore_top, generator=generator,
        mode=cfg.corr_mode, triage_src=cfg.corr_triage_src,
        triage_tgt=cfg.corr_triage_tgt, triage_top=cfg.corr_triage_top,
        var_anchors=cfg.corr_var_anchors, draws=draws)


def register_pair_hungarian(
    cfg: RegistrationConfig,
    src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
    corr_src_pts, corr_src_feat, corr_src_mask,
    corr_tgt_pts, corr_tgt_feat, corr_tgt_mask,
    raw_src_pts=None, raw_src_mask=None, raw_tgt_pts=None, raw_tgt_mask=None,
    run_icp: bool = True,
    rng: Optional[np.random.Generator] = None,
    generator: Optional[torch.Generator] = None,
    draws: Optional[dict] = None,
    device="cuda",
) -> RegistrationResult:
    """Reference-parity registration with Hungarian keypoint matching
    (evaluate.py:216-232): a 1:1 assignment over the full UME distance
    matrix instead of the per-source argmin, then the probabilistic filter
    over the matched distances (numpy `rng`, default
    np.random.default_rng(0)) or, with filter_by_ume_dist=False, every
    valid match (n = ume_n_samples keypoints). Inputs as for
    register_pair_features (features from pair_features_e2e), numpy arrays
    or tensors; they are moved to `device` (the card unless device="cpu";
    raises without CUDA). Keypoint and correlator draws come from
    `generator` (on `device`, default seed 0) unless `draws` injects them."""
    check_supported(replace(cfg, filter_by_ume_dist=True))
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    f32, b = torch.float32, torch.bool
    (src_pts, src_feat, tgt_pts, tgt_feat, corr_src_pts, corr_src_feat,
     corr_tgt_pts, corr_tgt_feat, raw_src_pts, raw_tgt_pts) = (
        to_device(x, dev, f32) for x in (
            src_pts, src_feat, tgt_pts, tgt_feat, corr_src_pts,
            corr_src_feat, corr_tgt_pts, corr_tgt_feat, raw_src_pts,
            raw_tgt_pts))
    (src_mask, tgt_mask, corr_src_mask, corr_tgt_mask, raw_src_mask,
     raw_tgt_mask) = (to_device(x, dev, b) for x in (
         src_mask, tgt_mask, corr_src_mask, corr_tgt_mask, raw_src_mask,
         raw_tgt_mask))
    with torch.no_grad():
        ume_src, ume_tgt, D = _ume_and_distance(
            cfg, src_pts, src_feat, src_mask, tgt_pts, tgt_feat, tgt_mask,
            generator, draws)
        Dh = D.cpu().numpy()  # the one device -> host copy
        m = hungarian_match(Dh)  # (K, 2), K = min(M, N)
        dist = Dh[m[:, 0], m[:, 1]]
        valid = dist < 1e2
        if not valid.any():  # degenerate pair: no real keypoints at all
            valid = np.ones_like(valid)
        if cfg.filter_by_ume_dist:
            rng = rng if rng is not None else np.random.default_rng(0)
            a = np.exp((1.0 - dist) / cfg.tau) * valid
            s = a.sum()
            p = a / s if s > 0 else valid / valid.sum()
            k = min(cfg.ume_n_samples, int(valid.sum()))
            m = m[rng.choice(len(m), size=k, replace=False, p=p)]
        else:
            m = m[valid]
        # pad to the static hypothesis count by repeating the best match
        # (duplicate hypotheses are harmless to the argmax selection)
        K = cfg.ume_n_samples
        best_row = m[np.argmin(Dh[m[:, 0], m[:, 1]])]
        if len(m) < K:
            m = np.concatenate([m, np.tile(best_row, (K - len(m), 1))])
        m = torch.from_numpy(m[:K]).to(dev)  # the one host -> device copy
        best_T, _ = _select_from_matches(
            cfg, ume_src, ume_tgt, m[:, 0], m[:, 1], corr_src_pts,
            corr_src_feat, corr_src_mask, corr_tgt_pts, corr_tgt_feat,
            corr_tgt_mask, generator, draws)
        if run_icp:
            T_ref, rmse, fit = refine_with_icp(
                cfg, best_T, corr_src_pts, corr_src_mask, corr_tgt_pts,
                corr_tgt_mask, raw_src_pts, raw_src_mask, raw_tgt_pts,
                raw_tgt_mask)
        else:
            T_ref, rmse, fit = best_T, torch.zeros((), device=dev), \
                torch.zeros((), device=dev)
    return RegistrationResult(T_init=best_T, T_refined=T_ref, icp_rmse=rmse,
                              icp_fitness=fit)
