"""Point-to-point ICP on the dense grid index (port of
umeregrobust_tpu/pipeline/icp.py).

Each outer block gathers the 9 (dx, dy) window candidates of every
source point once and runs `inner` closed-form Umeyama updates against
that frozen set (correspondences are re-ranked from the moved source in
every sub-iteration). The JAX while_loop becomes a Python loop with one
host read per block: the convergence flag (Open3D-style relative
fitness/rmse criteria, or an RMS block displacement below disp_exit).
Over a leading pair axis the flag is read for the whole batch (all
converged?), and converged pairs are frozen (JAX's while_loop under vmap).
"""
from __future__ import annotations

import torch

from umeregrobust_tpu_torch.core.so3 import kabsch_rotation
from umeregrobust_tpu_torch.core.transforms import make_transform
from umeregrobust_tpu_torch.ops.densegrid import DenseGrid, dense_candidates

__all__ = ["umeyama", "icp_loop"]


def umeyama(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted closed-form rigid alignment argmin_T sum w |T p - q|^2:
    ([B,] 4, 4). p, q ([B,] N, 3); w ([B,] N) nonnegative."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    wn = (w / wsum[..., None])[..., None]
    cp = torch.sum(p * wn, dim=-2)
    cq = torch.sum(q * wn, dim=-2)
    H = ((p - cp[..., None, :]) * wn).transpose(-1, -2) @ (
        q - cq[..., None, :])
    R = kabsch_rotation(H, sweeps=3)
    return make_transform(R, cq - (R @ cp[..., None])[..., 0])


def _apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def icp_loop(src: torch.Tensor, src_mask: torch.Tensor, grid: DenseGrid,
             init_T: torch.Tensor, max_corr: float, max_iter: int,
             budget: int, inner: int = 6, disp_exit: float = 1e-4):
    """Refine init_T; returns (T, rmse, fitness, sub-iterations run).
    max_iter counts sub-iterations; exits land on block boundaries.

    With a leading pair axis (src (B, S, 3), init_T (B, 4, 4), B grids)
    every block runs for all pairs at once and the loop runs until every
    pair has converged or max_iter is reached, with one host read a block
    (all pairs converged?). A pair that has converged is frozen: its T,
    rmse and fitness stop changing, so it ends where it would end alone.
    Returns per-pair (B,) rmse, fitness and sub-iterations (an int for one
    pair)."""
    if inner < 2:
        raise NotImplementedError(
            "icp_inner=1 (per-iteration dense_nn_query) is not ported yet")
    dev = src.device
    f32 = torch.float32
    lead = tuple(src.shape[:-2])
    r2 = torch.tensor(max_corr, dtype=f32, device=dev) ** 2
    m = src_mask.to(f32)
    n_src = torch.clamp(torch.sum(m, dim=-1), min=1.0)
    disp_lim = torch.tensor(disp_exit, dtype=f32, device=dev) ** 2
    T = init_T.to(f32)
    prev_rmse = torch.full(lead, 1e30, dtype=f32, device=dev)
    prev_fit = torch.zeros(lead, dtype=f32, device=dev)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    blocks = torch.zeros(lead, dtype=torch.int64, device=dev)
    it = 0
    while it < max_iter:
        cand = dense_candidates(grid, _apply(T, src), budget=budget)
        T_c = T
        for _ in range(inner):
            src_t = _apply(T_c, src)
            d2 = torch.sum((src_t[..., :, None, :] - cand) ** 2, dim=-1)
            d2 = torch.where(d2 <= r2, d2, torch.full_like(d2, 1e30))
            k = torch.argmin(d2, dim=-1, keepdim=True)
            bd2 = torch.gather(d2, -1, k)[..., 0]
            ok = (bd2 < 1e29) & src_mask
            q = torch.gather(cand, -2, k[..., None].expand(
                k.shape + (3,)))[..., 0, :]
            w = ok.to(f32)
            dT = umeyama(src_t, torch.where(ok[..., None], q, src_t), w)
            T_c = dT @ T_c
        n_ok = torch.clamp(torch.sum(w, dim=-1), min=1.0)
        rmse = torch.sqrt(torch.sum(torch.where(ok, bd2, torch.zeros_like(
            bd2)), dim=-1) / n_ok)
        fit = torch.sum(w, dim=-1) / n_src
        conv = ((torch.abs(prev_fit - fit)
                 <= 1e-5 * torch.clamp(prev_fit, min=1e-12))
                & (torch.abs(prev_rmse - rmse)
                   <= torch.clamp(1e-5 * prev_rmse, min=1e-5 * max_corr)))
        disp2 = torch.sum(torch.sum((_apply(T_c, src) - _apply(T, src)) ** 2,
                                    dim=-1) * m, dim=-1) / n_src
        conv = conv | (disp2 <= disp_lim)
        # pairs that converged in an earlier block keep their state
        live = ~done
        T = torch.where(live[..., None, None], T_c, T)
        prev_rmse = torch.where(live, rmse, prev_rmse)
        prev_fit = torch.where(live, fit, prev_fit)
        blocks = blocks + live
        done = done | conv
        it += inner
        if bool(torch.all(done)):  # the one host read of the block
            break
    iters = inner * blocks
    return T, prev_rmse, prev_fit, (iters if lead else int(iters))
