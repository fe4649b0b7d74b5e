"""Registration end to end (port of umeregrobust_tpu/pipeline/e2e.py:
register_pair_e2e, register_pairs_batched and the feature stage alone,
pair_features_e2e; pair_features_batched is the last one's batched twin).

Every cloud of the call runs through ONE geometry build and ONE backbone
forward: cloud c (pair c // 2, source or target) carries batch index c,
so a single sparse pyramid holds them all, each pair's levels capped at
its own capacity; k5/k7 layers and `conv_impl="scan"` models run the
per-tap conv kernels. Then feature transfer to the correlator clouds
(the nn1_argmin kernels, whose merge copies the rows; with
cfg.feat_copy_radius a dense-grid query and gather_rows), hypotheses (kernel
ume_moments_fused), scoring (kernel corr_scores_fused), the consensus
gate and ICP, each stage once for all pairs. register_pair_e2e is the
one-pair view of register_pairs_batched.

The entry points run on the card unless the caller asks for the CPU: they
raise when no CUDA device exists and device="cpu" was not passed.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from umeregrobust_tpu_torch.devices import resolve_device, to_device
from umeregrobust_tpu_torch.models.resunet import ResUNet, build_unet_geometry
from umeregrobust_tpu_torch.ops.precision import tf32_off
from umeregrobust_tpu_torch.pipeline.registration import (
    RegistrationConfig, check_supported, copy_features_to_raw,
    copy_features_to_raw_grid, register_pair_features_batched)
from umeregrobust_tpu_torch.utils.profiling import span

__all__ = ["register_pair_e2e", "register_pairs_batched", "pair_features_e2e",
           "pair_features_batched", "resolve_device"]


def _feature_stage(model, caps, compute_dtype, src_coords, src_grid, src_mask,
                   tgt_coords, tgt_grid, tgt_mask, corr_src_pts,
                   corr_src_mask, corr_tgt_pts, corr_tgt_mask, cfg=None):
    """Fused geometry and forward of the 2B clouds of B pairs (inputs with
    a leading pair axis, on the model's device), then the 1-NN transfer to
    the correlator clouds: exact (copy_features_to_raw), or a dense-grid
    query when cfg.feat_copy_radius is set (copy_features_to_raw_grid).
    Returns (src_feat, tgt_feat, corr_src_feat, corr_tgt_feat), (B, .., C)
    each."""
    # stage ranges (the JAX package's named scopes) for torch.profiler;
    # each costs about 10 us on the host even with no profiler active
    with span("geometry"):
        B, N = src_coords.shape[:2]
        mask = torch.stack([src_mask, tgt_mask], dim=1)  # (B, 2, N)
        coords = torch.stack([src_coords, tgt_coords], dim=1).clone()
        cloud = torch.arange(2 * B, dtype=torch.int32,
                             device=coords.device).reshape(B, 2, 1)
        coords[..., 0] += cloud * mask  # batch index c on valid rows
        mask = mask.reshape(-1)
        geom = build_unet_geometry(coords.reshape(-1, 4), mask, model.arch,
                                   tuple(2 * c for c in caps), pairs=B)
    with span("forward"):
        feats = model(geom, mask[:, None].to(torch.float32),
                      compute_dtype=compute_dtype).reshape(B, 2, N, -1)
        src_feat, tgt_feat = feats[:, 0], feats[:, 1]
    with span("feat_to_raw"):
        copy = copy_features_to_raw
        if cfg is not None and cfg.feat_copy_radius is not None:
            def copy(*a):
                return copy_features_to_raw_grid(
                    *a, radius=cfg.feat_copy_radius,
                    budget=cfg.feat_copy_budget, dims=cfg.feat_copy_dims)
        cs_f = copy(corr_src_pts, corr_src_mask, src_grid, src_feat, src_mask)
        ct_f = copy(corr_tgt_pts, corr_tgt_mask, tgt_grid, tgt_feat, tgt_mask)
    return src_feat, tgt_feat, cs_f, ct_f


def _pair_inputs(dev, *arrays, add_axis=True):
    """The ten per-pair arrays (src_coords, src_grid, src_mask, tgt_coords,
    tgt_grid, tgt_mask, corr_src_pts, corr_src_mask, corr_tgt_pts,
    corr_tgt_mask) as tensors on `dev` in the path's types; add_axis: one
    pair's arrays get a leading pair axis of 1."""
    types = (torch.int32, torch.float32, torch.bool) * 2 + (
        torch.float32, torch.bool) * 2
    out = [to_device(x, dev, dtype) for x, dtype in zip(arrays, types)]
    return [x[None] for x in out] if add_axis else out


def pair_features_e2e(
    model: ResUNet,
    caps: Tuple[int, ...],
    src_coords, src_grid, src_mask,
    tgt_coords, tgt_grid, tgt_mask,
    corr_src_pts, corr_src_mask,
    corr_tgt_pts, corr_tgt_mask,
    compute_dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The feature stage of register_pair_e2e alone, for flows whose
    matching step runs elsewhere (register_pair_hungarian). Returns
    (src_feat, tgt_feat, corr_src_feat, corr_tgt_feat); inputs as in
    register_pair_e2e."""
    out = pair_features_batched(
        model, caps, *_pair_inputs(
            resolve_device(device), src_coords, src_grid, src_mask,
            tgt_coords, tgt_grid, tgt_mask, corr_src_pts, corr_src_mask,
            corr_tgt_pts, corr_tgt_mask), compute_dtype=compute_dtype,
        device=device)
    return tuple(x[0] for x in out)


def pair_features_batched(
    model: ResUNet,
    caps: Tuple[int, ...],
    src_coords, src_grid, src_mask,
    tgt_coords, tgt_grid, tgt_mask,
    corr_src_pts, corr_src_mask,
    corr_tgt_pts, corr_tgt_mask,
    compute_dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """pair_features_e2e over a leading pair axis B (every input has it):
    one geometry build and one forward for all 2B clouds, each pair's
    levels at its own capacities; pair b gets the features the one-pair
    call gives it. Returns (src_feat, tgt_feat, corr_src_feat,
    corr_tgt_feat), (B, .., C) each."""
    dev = resolve_device(device)
    pair = _pair_inputs(dev, src_coords, src_grid, src_mask, tgt_coords,
                        tgt_grid, tgt_mask, corr_src_pts, corr_src_mask,
                        corr_tgt_pts, corr_tgt_mask, add_axis=False)
    with torch.no_grad(), tf32_off():
        return _feature_stage(model, caps, compute_dtype, *pair)


def register_pair_e2e(
    model: ResUNet,
    caps: Tuple[int, ...],
    cfg: RegistrationConfig,
    src_coords, src_grid, src_mask,
    tgt_coords, tgt_grid, tgt_mask,
    corr_src_pts, corr_src_mask,
    corr_tgt_pts, corr_tgt_mask,
    raw_src_pts=None, raw_src_mask=None,
    raw_tgt_pts=None, raw_tgt_mask=None,
    compute_dtype: torch.dtype = torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    draws: Optional[dict] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full pipeline for one pair. Returns (T_init, T_refined), (4, 4) each.

    Inputs are numpy arrays or tensors: coords (N, 4) int32 [b, x, y, z]
    padded with invalid rows, grid points (N, 3), masks, correlator clouds
    (M, 3) with masks, optional raw clouds for the final ICP stage. `model`
    (any arch of models.resunet.ARCHS, with one capacity per level in
    `caps`) must already live on `device`. The backbone computes with
    operands rounded to `compute_dtype` and fp32 sums. `generator` (on
    `device`) draws keypoints, the match filter and the correlator subsets
    unless `draws` injects them. TF32 is off while the call runs and the
    caller's TF32 settings are restored afterwards. The one-pair view of
    register_pairs_batched.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    pair = _pair_inputs(dev, src_coords, src_grid, src_mask, tgt_coords,
                        tgt_grid, tgt_mask, corr_src_pts, corr_src_mask,
                        corr_tgt_pts, corr_tgt_mask)
    raw = [None if x is None else x[None] for x in (
        to_device(raw_src_pts, dev, torch.float32),
        to_device(raw_src_mask, dev, torch.bool),
        to_device(raw_tgt_pts, dev, torch.float32),
        to_device(raw_tgt_mask, dev, torch.bool))]
    Ti, Tr = register_pairs_batched(
        model, caps, cfg, *pair, *raw, compute_dtype=compute_dtype,
        generators=None if generator is None else [generator],
        draws=[draws], device=device)
    return Ti[0], Tr[0]


def register_pairs_batched(
    model: ResUNet,
    caps: Tuple[int, ...],
    cfg: RegistrationConfig,
    src_coords, src_grid, src_mask,
    tgt_coords, tgt_grid, tgt_mask,
    corr_src_pts, corr_src_mask,
    corr_tgt_pts, corr_tgt_mask,
    raw_src_pts=None, raw_src_mask=None,
    raw_tgt_pts=None, raw_tgt_mask=None,
    compute_dtype: torch.dtype = torch.bfloat16,
    generators: Optional[Sequence[torch.Generator]] = None,
    draws: Optional[Sequence[Optional[dict]]] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """register_pair_e2e for B pairs of one shape at once (the JAX
    package's vmap over a leading pair axis). Every input of
    register_pair_e2e gains a leading axis B; returns (T_init, T_refined),
    (B, 4, 4) each.

    Each stage runs once for the batch: one geometry build and one forward
    for the 2B clouds (capacities per pair, as in the one-pair call), one
    launch of each kernel per call site. Per pair stay only the random
    draws: pair i draws from generators[i] (on `device`; default: seed i)
    in the order register_pair_e2e draws, unless draws[i] injects them, so
    pair i gets what register_pair_e2e with that generator gives it. The
    consensus gate and the ICP exit are read once for the batch (a pair
    that converged is frozen); the ICP window budget cfg.icp_budget is one
    for the batch and must cover every pair's worst window. Runs on the
    card unless device="cpu" (raises without CUDA).
    """
    check_supported(cfg)
    dev = resolve_device(device)
    with span("inputs"):  # the batch's copy to the device
        pair = _pair_inputs(dev, src_coords, src_grid, src_mask, tgt_coords,
                            tgt_grid, tgt_mask, corr_src_pts, corr_src_mask,
                            corr_tgt_pts, corr_tgt_mask, add_axis=False)
        raw = [to_device(raw_src_pts, dev, torch.float32),
               to_device(raw_src_mask, dev, torch.bool),
               to_device(raw_tgt_pts, dev, torch.float32),
               to_device(raw_tgt_mask, dev, torch.bool)]
    B = pair[0].shape[0]
    if generators is None:
        generators = [torch.Generator(device=dev).manual_seed(i)
                      for i in range(B)]
    (_, src_grid, src_mask, _, tgt_grid, tgt_mask, corr_src_pts,
     corr_src_mask, corr_tgt_pts, corr_tgt_mask) = pair
    with torch.no_grad(), tf32_off():
        src_feat, tgt_feat, cs_f, ct_f = _feature_stage(
            model, caps, compute_dtype, *pair, cfg=cfg)
        res = register_pair_features_batched(  # spans "hypotheses", "icp"
            cfg, src_grid, src_feat, src_mask, tgt_grid, tgt_feat, tgt_mask,
            corr_src_pts, cs_f, corr_src_mask, corr_tgt_pts, ct_f,
            corr_tgt_mask, *raw, generators=generators,
            draws=draws if draws is not None else [None] * B)
    return res.T_init, res.T_refined
