"""Universal Manifold Embedding (UME) core (port of
umeregrobust_tpu/core/ume.py): moment matrices from padded
neighbourhoods, subspace projections, subspace distances and the
closed-form rigid estimator from matched UME pairs."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from umeregrobust_tpu_torch.core.so3 import gram_schmidt, kabsch_rotation
from umeregrobust_tpu_torch.utils.profiling import host_read

__all__ = ["moment_matrix", "orthonormalize", "subspace_projection",
           "projection_packed",
           "ume_distance", "ume_pairwise_distance", "estimate_rigid_from_ume",
           "ume_validity_mask"]


def moment_matrix(nn_pts: torch.Tensor, nn_feat: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  normalize: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """UME moment matrices F = [F0 | F1] (..., C, 4) fp32 of padded
    neighbourhoods: F0 = sum_k f_k, F1 = sum_k f_k x_k^T over nn_pts
    (..., K, 3) and nn_feat (..., K, C) (padded rows zero). mask (..., K)
    zeroes rows first; normalize divides by the total feature mass
    sum(F0) + eps. The products run in full fp32 (callers keep TF32 off)."""
    nn_pts = nn_pts.to(torch.float32)
    nn_feat = nn_feat.to(torch.float32)
    if mask is not None:
        m = mask.to(torch.float32)[..., None]
        nn_pts = nn_pts * m
        nn_feat = nn_feat * m
    ftr = nn_feat.transpose(-1, -2)  # (..., C, K)
    F1 = ftr @ nn_pts  # (..., C, 3)
    F0 = torch.sum(ftr, dim=-1, keepdim=True)  # (..., C, 1)
    F = torch.cat([F0, F1], dim=-1)
    if normalize:
        F = F / (torch.sum(F0, dim=-2, keepdim=True) + eps)
    return F


def orthonormalize(F: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of (..., d, 4) UME matrix columns (modified
    Gram-Schmidt, fp32; rank-deficient columns come out zero)."""
    return gram_schmidt(F.to(torch.float32))


def subspace_projection(F: torch.Tensor) -> torch.Tensor:
    """P = Q Q^T onto the column space of (..., d, 4) F. (..., d, d)."""
    Q = orthonormalize(F)
    return Q @ Q.transpose(-1, -2)


def projection_packed(F: torch.Tensor) -> torch.Tensor:
    """[diag(P) | sqrt(2) * offdiag(P)]: inner products of packed vectors
    equal the Frobenius inner products of the full projections."""
    P = subspace_projection(F)
    d = P.shape[-1]
    iu = torch.triu_indices(d, d, offset=1, device=F.device)
    ar = torch.arange(d, device=F.device)
    diag = P[..., ar, ar]
    off = P[..., iu[0], iu[1]] * math.sqrt(2.0)
    return torch.cat([diag, off], dim=-1)


def ume_distance(ume1: torch.Tensor, ume2: torch.Tensor) -> torch.Tensor:
    """Elementwise (matched-pair) subspace distance."""
    diff = subspace_projection(ume1) - subspace_projection(ume2)
    return torch.sqrt(torch.sum(diff * diff, dim=(-2, -1))) / math.sqrt(2.0)


def ume_pairwise_distance(ume1: torch.Tensor,
                          ume2: torch.Tensor) -> torch.Tensor:
    """Pairwise subspace distance D[..., i, j] = |P1_i - P2_j|_F / sqrt(2)
    for ume1 (..., M, d, 4), ume2 (..., N, d, 4) -> (..., M, N): one plain
    matmul of the packed projections, in full fp32 (callers keep TF32
    off), outside any kernel as in the JAX package."""
    P1 = projection_packed(ume1)
    P2 = projection_packed(ume2)
    sq1 = torch.sum(P1 * P1, dim=-1)
    sq2 = torch.sum(P2 * P2, dim=-1)
    cross = P1 @ P2.transpose(-1, -2)
    d2 = torch.clamp(sq1[..., :, None] + sq2[..., None, :] - 2.0 * cross,
                     min=0.0)
    return torch.sqrt(d2) / math.sqrt(2.0)


def estimate_rigid_from_ume(
    G: torch.Tensor, H: torch.Tensor, compute_distance: bool = True,
    sweeps: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form rigid transforms from matched (B, d, 4) UME pairs;
    G = UME(source), H = UME(target), T maps source into target.
    Returns (T (B, 4, 4), D (B,) matched distances or zeros)."""
    G = G.to(torch.float32)
    H = H.to(torch.float32)
    mg, mh = G[..., :, 0:1], H[..., :, 0:1]
    g, h = G[..., :, 1:], H[..., :, 1:]
    mg_sq = torch.sum(mg * mg, dim=-2, keepdim=True) + 1e-16
    mg_mh = torch.sum(mg * mh, dim=-2, keepdim=True)
    gmg = torch.sum(g * mg, dim=-2, keepdim=True)
    hmg = torch.sum(h * mg, dim=-2, keepdim=True)
    wlc = gmg / (mg_sq + 1e-16)
    wrc = hmg / (mg_mh + 1e-16)
    left = g - wlc * mg
    right = h - wrc * mh
    Hcov = left.transpose(-1, -2) @ right
    R = kabsch_rotation(Hcov, sweeps=sweeps)
    b2 = wrc - wlc @ R.transpose(-1, -2)
    if compute_distance:
        D = ume_distance(H, G)
    else:
        D = torch.zeros(G.shape[:-2], dtype=torch.float32, device=G.device)
    T = torch.zeros(G.shape[:-2] + (4, 4), dtype=torch.float32,
                    device=G.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = b2[..., 0, :]
    T[..., 3, 3] = 1.0
    return T, D


def ume_validity_mask(F: torch.Tensor, svd_thr: float = 1e-5) -> torch.Tensor:
    """Full-rank check: all 4 singular values above threshold. A matrix
    with a non-finite entry is invalid (JAX's SVD gives NaN singular
    values for it; torch's raises, so it sees zeros instead)."""
    F = F.to(torch.float32)
    finite = torch.isfinite(F).all(dim=-1).all(dim=-1)
    s = torch.linalg.svdvals(torch.where(finite[..., None, None], F,
                                         torch.zeros_like(F)))
    # the card's batched SVD synchronizes twice a call (seen through
    # torch.cuda.set_sync_debug_mode with torch 2.11 / CUDA 12.8, H100)
    host_read("ume.validity_mask", 2, device=F.device)
    return (torch.sum(s > svd_thr, dim=-1) == 4) & finite
