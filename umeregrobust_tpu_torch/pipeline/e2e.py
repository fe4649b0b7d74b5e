"""Per-pair registration end to end (port of
umeregrobust_tpu/pipeline/e2e.py:register_pair_e2e).

Both clouds run through ONE geometry build and ONE backbone forward: the
target's batch index is offset by one, so a single sparse pyramid holds
both clouds. Then feature transfer to the correlator clouds (kernel
nn1_argmin), hypotheses (kernel ume_moments_fused), scoring (kernel
corr_scores_fused), the consensus gate and ICP.

The entry point runs on the card unless the caller asks for the CPU: it
raises when no CUDA device exists and device="cpu" was not passed.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from umeregrobust_tpu_torch.models.resunet import ResUNet, build_unet_geometry
from umeregrobust_tpu_torch.pipeline.registration import (
    RegistrationConfig, check_supported, copy_features_to_raw,
    register_pair_features)

__all__ = ["register_pair_e2e", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """torch.device(device); raises for a CUDA device on a machine without
    CUDA (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for matmuls and convolutions (full fp32, the JAX numerics)
    while the call runs; the caller's settings come back afterwards."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _on(x, dev, dtype=None):
    if x is None:
        return None
    t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
    return t.to(device=dev, dtype=dtype)


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
    must already live on `device`. The backbone computes with operands
    rounded to `compute_dtype` and fp32 sums. `generator` (on `device`)
    draws keypoints, the match filter and the correlator subsets unless
    `draws` injects them. TF32 is off while the call runs and the
    caller's TF32 settings are restored afterwards.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    f32 = torch.float32
    src_coords, tgt_coords = _on(src_coords, dev, torch.int32), _on(
        tgt_coords, dev, torch.int32)
    src_grid, tgt_grid = _on(src_grid, dev, f32), _on(tgt_grid, dev, f32)
    src_mask, tgt_mask = _on(src_mask, dev, torch.bool), _on(
        tgt_mask, dev, torch.bool)
    corr_src_pts, corr_tgt_pts = _on(corr_src_pts, dev, f32), _on(
        corr_tgt_pts, dev, f32)
    corr_src_mask, corr_tgt_mask = _on(corr_src_mask, dev, torch.bool), _on(
        corr_tgt_mask, dev, torch.bool)
    raw = [_on(raw_src_pts, dev, f32), _on(raw_src_mask, dev, torch.bool),
           _on(raw_tgt_pts, dev, f32), _on(raw_tgt_mask, dev, torch.bool)]

    # stage ranges (the JAX package's named scopes) for torch.profiler;
    # record_function costs nothing while no profiler is active
    stage = torch.profiler.record_function
    with torch.no_grad(), _tf32_off():
        with stage("geometry"):
            N = src_coords.shape[0]
            tgt_b = tgt_coords.clone()
            tgt_b[:, 0] += tgt_mask.to(torch.int32)
            coords2 = torch.cat([src_coords, tgt_b])
            mask2 = torch.cat([src_mask, tgt_mask])
            geom = build_unet_geometry(coords2, mask2, model.arch,
                                       tuple(2 * c for c in caps))
        with stage("forward"):
            both = model(geom, mask2[:, None].to(f32),
                         compute_dtype=compute_dtype)
            src_feat, tgt_feat = both[:N], both[N:]
        with stage("feat_to_raw"):
            cs_f = copy_features_to_raw(corr_src_pts, corr_src_mask,
                                        src_grid, src_feat, src_mask)
            ct_f = copy_features_to_raw(corr_tgt_pts, corr_tgt_mask,
                                        tgt_grid, tgt_feat, tgt_mask)
        res = register_pair_features(  # stages "hypotheses" and "icp"
            cfg, src_grid, src_feat, src_mask, tgt_grid, tgt_feat, tgt_mask,
            corr_src_pts, cs_f, corr_src_mask, corr_tgt_pts, ct_f,
            corr_tgt_mask, *raw, generator=generator, draws=draws)
    return res.T_init, res.T_refined
