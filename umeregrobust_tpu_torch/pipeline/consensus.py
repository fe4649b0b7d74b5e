"""Match-consensus hypothesis rescue (port of
umeregrobust_tpu/pipeline/consensus.py): vote over the match set,
NMS-select distinct SE(3) modes and IRLS-refit each over its voters
(`consensus_refit`), mini-ICP-polish candidates on the dense grid
(`polish_candidates`), and compact a cloud to its structure points
(`compact_structure`) for the structure-only arbiter. Every function
takes an optional leading pair axis ([B,] below), with no loop over
pairs."""
from __future__ import annotations

import math
from typing import Tuple

import torch

from umeregrobust_tpu_torch.core.so3 import kabsch_rotation
from umeregrobust_tpu_torch.core.transforms import make_transform
from umeregrobust_tpu_torch.ops.densegrid import build_dense_grid, dense_candidates
from umeregrobust_tpu_torch.ops.neighbors import take_rows, topk_stable

__all__ = ["consensus_refit", "polish_candidates", "compact_structure",
           "height_above_floor"]


def _pair_distances(Ts: torch.Tensor, s_kp: torch.Tensor,
                    t_kp: torch.Tensor) -> torch.Tensor:
    """([B,] V, n) distances |T_v s_i - t_i| as one (V, 17) x (17, n)
    product a pair:
    |R s + t - q|^2 = |s|^2 + |q|^2 + |t|^2 + 2 s.(R^T t) - 2 vec(R).vec(q s^T)
    - 2 t.q."""
    R = Ts[..., :3, :3].to(torch.float32)
    t = Ts[..., :3, 3].to(torch.float32)
    u = torch.einsum("...vji,...vj->...vi", R, t)
    ones_v = torch.ones(Ts.shape[:-2] + (1,), dtype=torch.float32,
                        device=Ts.device)
    A = torch.cat([torch.sum(t * t, dim=-1, keepdim=True), 2.0 * u,
                   -2.0 * R.reshape(R.shape[:-2] + (9,)), -2.0 * t, ones_v],
                  dim=-1)
    outer = t_kp[..., :, None] * s_kp[..., None, :]
    ones_n = torch.ones(s_kp.shape[:-1] + (1,), dtype=torch.float32,
                        device=Ts.device)
    B = torch.cat([ones_n, s_kp, outer.reshape(outer.shape[:-2] + (9,)), t_kp,
                   (torch.sum(s_kp * s_kp, dim=-1)
                    + torch.sum(t_kp * t_kp, dim=-1))[..., None]], dim=-1)
    return torch.sqrt(torch.clamp(A @ B.transpose(-1, -2), min=0.0))


def consensus_refit(Ts: torch.Tensor, s_kp: torch.Tensor, t_kp: torch.Tensor,
                    pair_ok: torch.Tensor, tau: float = 2.0, n_cand: int = 16,
                    nms_rot_deg: float = 15.0, nms_trans: float = 5.0,
                    refit_sigmas: Tuple[float, ...] = (1.0, 0.5, 0.25)
                    ) -> torch.Tensor:
    """Top-n_cand vote modes, inlier-refit: ([B,] n_cand, 4, 4) from Ts
    ([B,] V, 4, 4) and the matched keypoints ([B,] n, 3)."""
    dev = Ts.device
    okf = pair_ok.to(torch.float32)
    dist = _pair_distances(Ts, s_kp, t_kp)
    votes = torch.sum((dist < tau) & pair_ok[..., None, :], dim=-1)
    R = Ts[..., :3, :3]
    t = Ts[..., :3, 3]
    cos_lim = torch.cos(torch.deg2rad(torch.tensor(nms_rot_deg,
                                                   dtype=torch.float32,
                                                   device=dev)))
    v = votes
    sel = []
    for _ in range(n_cand):  # NMS over vote modes
        j = torch.argmax(v, dim=-1, keepdim=True)
        Rj = take_rows(R, j)
        tj = take_rows(t, j)
        tr_rel = torch.sum(R * Rj, dim=(-2, -1))
        near = (((tr_rel - 1.0) * 0.5) > cos_lim) & (
            torch.linalg.vector_norm(t - tj, dim=-1) < nms_trans)
        v = torch.where(near, torch.full_like(v, -1), v)
        sel.append(j)
    cand = take_rows(Ts, torch.cat(sel, dim=-1))
    for sigma in refit_sigmas:  # IRLS refit over voters
        d = _pair_distances(cand, s_kp, t_kp)
        w = okf[..., None, :] / (1.0 + (d / sigma) ** 2)
        w = torch.where(d < 2.0 * tau, w, torch.zeros_like(w))
        wsum = torch.sum(w, dim=-1, keepdim=True)
        wn = w / torch.clamp(wsum, min=1e-6)
        mu_s = wn @ s_kp
        mu_t = wn @ t_kp
        cs = s_kp[..., None, :, :] - mu_s[..., :, None, :]
        ct = t_kp[..., None, :, :] - mu_t[..., :, None, :]
        cov = torch.einsum("...vn,...vni,...vnj->...vij", wn, cs, ct)
        R_new = kabsch_rotation(cov)
        t_new = mu_t - torch.einsum("...vij,...vj->...vi", R_new, mu_s)
        keep_old = (wsum[..., 0] < 1e-3)[..., None, None]
        cand = torch.where(keep_old, cand, make_transform(R_new, t_new))
    return cand


def polish_candidates(cand: torch.Tensor, src_pts: torch.Tensor,
                      src_mask: torch.Tensor, tgt_pts: torch.Tensor,
                      tgt_mask: torch.Tensor, cell: float = 1.0,
                      radii: Tuple[float, ...] = (1.0, 0.6, 0.35),
                      inner: int = 4, budget: int = 16,
                      dims: Tuple[int, int, int] = (128, 128, 32)
                      ) -> torch.Tensor:
    """Mini-ICP polish of every candidate, batched over candidates: per
    radius stage one window gather, then `inner` Umeyama updates against
    the frozen windows. cand ([B,] V, 4, 4), clouds ([B,] S, 3) and ([B,]
    T, 3); returns ([B,] V, 4, 4)."""
    grid = build_dense_grid(tgt_pts, tgt_mask, cell=cell, dims=dims)
    V, S = cand.shape[-3], src_pts.shape[-2]
    lead = tuple(cand.shape[:-3])
    dev = cand.device
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    T = cand.to(torch.float32)

    def apply(T):
        return (src_pts[..., None, :, :] @ T[..., :3, :3].transpose(-1, -2)
                + T[..., :3, 3][..., None, :])

    for r in radii:
        r_t = torch.tensor(r, dtype=torch.float32, device=dev)
        r2 = r_t * r_t
        windows = dense_candidates(
            grid, apply(T).reshape(lead + (V * S, 3)),
            budget=budget).reshape(lead + (V, S, -1, 3))
        for _ in range(inner):
            src_t = apply(T)
            d2 = torch.sum((src_t[..., None, :] - windows) ** 2, dim=-1)
            d2 = torch.where(d2 <= r2, d2, torch.full_like(d2, 1e30))
            k = torch.argmin(d2, dim=-1, keepdim=True)
            bd2 = torch.gather(d2, -1, k)[..., 0]
            ok = (bd2 < 1e29) & src_mask[..., None, :]
            q = torch.gather(windows, -2, k[..., None].expand(
                k.shape + (3,)))[..., 0, :]
            w = ok.to(torch.float32)
            wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-6)
            wn = (w / wsum[..., None])[..., None]
            cp = torch.sum(src_t * wn, dim=-2)
            cq = torch.sum(q * w[..., None], dim=-2) / wsum[..., None]
            Hm = ((src_t - cp[..., None, :]) * wn).transpose(-1, -2) \
                @ torch.where(ok[..., None], q - cq[..., None, :],
                              torch.zeros_like(q))
            Rd = kabsch_rotation(Hm, sweeps=3)
            dT = make_transform(Rd, cq - (Rd @ cp[..., None])[..., 0])
            # no correspondences at all -> identity update
            dT = torch.where((torch.sum(w, dim=-1) < 3.0)[..., None, None],
                             eye, dT)
            T = dT @ T
    return T


def height_above_floor(pts: torch.Tensor, mask: torch.Tensor, cell,
                       grid_dim: int = 64) -> torch.Tensor:
    """([B,] N) height of each point above the lowest valid point of its
    2D cell (cells of side `cell`, a float or a ([B,] 1, 1) tensor, on a
    grid_dim x grid_dim grid anchored at the cloud's min cell; one
    scatter-min over the batch, each pair's cells apart)."""
    cc = torch.floor(pts[..., :2] / cell).to(torch.int32)
    cc = cc - torch.min(torch.where(mask[..., None], cc,
                                    torch.full_like(cc, 1 << 20)),
                        dim=-2, keepdim=True).values
    cc = torch.clamp(cc, 0, grid_dim - 1).to(torch.int64)
    lead = tuple(pts.shape[:-2])
    cells = grid_dim * grid_dim
    base = (torch.arange(math.prod(lead), device=pts.device)
            * cells).reshape(lead + (1,))
    flat = cc[..., 0] * grid_dim + cc[..., 1] + base
    z = pts[..., 2]
    minz = torch.full((math.prod(lead) * cells,), 1e9, dtype=z.dtype,
                      device=pts.device).scatter_reduce(
        0, flat.reshape(-1), torch.where(mask, z, torch.full_like(z, 1e9)
                                         ).reshape(-1), reduce="amin")
    return z - minz[flat]


def compact_structure(pts: torch.Tensor, feat: torch.Tensor,
                      mask: torch.Tensor, cap: int, cell: float = 2.0,
                      dz: float = 0.35, grid_dim: int = 64
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-`cap` structure points (highest above their 2D cell's min z):
    (pts[cap], feat[cap], struct_mask[cap]), each with the inputs' leading
    pair axis."""
    height = height_above_floor(pts, mask, cell, grid_dim)
    score = torch.where(mask & (height > dz), height,
                        torch.full_like(height, -math.inf))
    _, idx = topk_stable(score, cap)
    return (take_rows(pts, idx), take_rows(feat, idx),
            torch.isfinite(torch.gather(score, -1, idx)))
