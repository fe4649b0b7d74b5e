"""Point-to-point ICP on the dense grid index (port of
umeregrobust_tpu/pipeline/icp.py).

Each outer block gathers the 9 (dx, dy) window candidates of every
source point once and runs `inner` closed-form Umeyama updates against
that frozen set (correspondences are re-ranked from the moved source in
every sub-iteration). The JAX while_loop becomes a Python loop with one
host read per block: the convergence flag (Open3D-style relative
fitness/rmse criteria, or an RMS block displacement below disp_exit).
"""
from __future__ import annotations

from typing import Tuple

import torch

from umeregrobust_tpu_torch.core.so3 import kabsch_rotation
from umeregrobust_tpu_torch.core.transforms import make_transform
from umeregrobust_tpu_torch.ops.densegrid import DenseGrid, dense_candidates

__all__ = ["umeyama", "icp_loop"]


def umeyama(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted closed-form rigid alignment argmin_T sum w |T p - q|^2:
    (4, 4). p, q (N, 3); w (N,) nonnegative."""
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    wn = (w / wsum)[:, None]
    cp = torch.sum(p * wn, dim=0)
    cq = torch.sum(q * wn, dim=0)
    H = ((p - cp) * wn).T @ (q - cq)
    R = kabsch_rotation(H, sweeps=3)
    return make_transform(R, cq - R @ cp)


def _apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ T[:3, :3].T + T[:3, 3]


def icp_loop(src: torch.Tensor, src_mask: torch.Tensor, grid: DenseGrid,
             init_T: torch.Tensor, max_corr: float, max_iter: int,
             budget: int, inner: int = 6, disp_exit: float = 1e-4
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Refine init_T; returns (T, rmse, fitness, sub-iterations run).
    max_iter counts sub-iterations; exits land on block boundaries."""
    if inner < 2:
        raise NotImplementedError(
            "icp_inner=1 (per-iteration dense_nn_query) is not ported yet")
    dev = src.device
    f32 = torch.float32
    r2 = torch.tensor(max_corr, dtype=f32, device=dev) ** 2
    m = src_mask.to(f32)
    n_src = torch.clamp(torch.sum(m), min=1.0)
    disp_lim = torch.tensor(disp_exit, dtype=f32, device=dev) ** 2
    T = init_T.to(f32)
    prev_rmse = torch.tensor(1e30, dtype=f32, device=dev)
    prev_fit = torch.tensor(0.0, dtype=f32, device=dev)
    rows = torch.arange(src.shape[0], device=dev)
    it, converged = 0, False
    while it < max_iter and not converged:
        cand = dense_candidates(grid, _apply(T, src), budget=budget)
        T_c = T
        for _ in range(inner):
            src_t = _apply(T_c, src)
            d2 = torch.sum((src_t[:, None, :] - cand) ** 2, dim=-1)
            d2 = torch.where(d2 <= r2, d2, torch.full_like(d2, 1e30))
            k = torch.argmin(d2, dim=-1)
            bd2 = d2[rows, k]
            ok = (bd2 < 1e29) & src_mask
            q = cand[rows, k]
            w = ok.to(f32)
            dT = umeyama(src_t, torch.where(ok[:, None], q, src_t), w)
            T_c = dT @ T_c
        n_ok = torch.clamp(torch.sum(w), min=1.0)
        rmse = torch.sqrt(torch.sum(torch.where(ok, bd2, torch.zeros_like(
            bd2))) / n_ok)
        fit = torch.sum(w) / n_src
        conv = ((torch.abs(prev_fit - fit)
                 <= 1e-5 * torch.clamp(prev_fit, min=1e-12))
                & (torch.abs(prev_rmse - rmse)
                   <= torch.clamp(1e-5 * prev_rmse, min=1e-5 * max_corr)))
        disp2 = torch.sum(torch.sum((_apply(T_c, src) - _apply(T, src)) ** 2,
                                    dim=-1) * m) / n_src
        conv = conv | (disp2 <= disp_lim)
        T, prev_rmse, prev_fit = T_c, rmse, fit
        it += inner
        converged = bool(conv)  # the one host read of the block
    return T, prev_rmse, prev_fit, it
