"""Radius-capped Cauchy correlation scores: wrapper of the CUDA kernel
csrc/corr_scores.cu and its plain PyTorch version (port of
umeregrobust_tpu/ops/pallas_corr.py, same Python signature).

score_h = sum_i sum_j 1[d2 <= (rf sigma)^2] / (1 + d2 / sigma^2) <f_i, g_j>,
d2 = |pts_t[h, i] - q_j|^2 from direct differences in fp32. Invalid rows
must carry zero features. On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from umeregrobust_tpu_torch.ops import _build
from umeregrobust_tpu_torch.ops.neighbors import sqdist3

__all__ = ["corr_scores_fused", "corr_scores_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches by corr_scores_fused

_TS = 32  # source rows per CUDA block (csrc/corr_scores.cu kTS)


def _constants(sigma: float, radius_factor: float):
    inv_s2 = torch.tensor(1.0 / float(sigma) ** 2, dtype=torch.float32)
    r2 = torch.tensor(float(radius_factor * sigma) ** 2, dtype=torch.float32)
    return inv_s2, r2


def corr_scores_plain(pts_t: torch.Tensor, src_featw: torch.Tensor,
                      tgt_pts4: torch.Tensor, tgt_featw: torch.Tensor,
                      sigma: float = 1.5, radius_factor: float = 2.0,
                      max_elems: int = 1 << 22) -> torch.Tensor:
    """(H,) scores; hypotheses chunked so each (h, i, j) block holds at
    most max_elems entries."""
    inv_s2, r2 = (c.to(pts_t.device) for c in _constants(sigma, radius_factor))
    H, S, _ = pts_t.shape
    T = tgt_pts4.shape[0]
    G = src_featw.to(torch.float32) @ tgt_featw.to(torch.float32).T  # (S, T)
    q = tgt_pts4[:, :3].to(torch.float32)
    hc = max(1, max_elems // max(S * T, 1))
    out = []
    for h0 in range(0, H, hc):
        d2 = sqdist3(pts_t[h0:h0 + hc, :, :3].to(torch.float32), q)
        w = torch.where(d2 <= r2, 1.0 / (1.0 + d2 * inv_s2),
                        torch.zeros_like(d2))
        out.append(torch.sum(w * G, dim=(1, 2)))
    if not out:
        return torch.zeros(0, dtype=torch.float32, device=pts_t.device)
    return torch.cat(out)


def corr_scores_fused(pts_t: torch.Tensor, src_featw: torch.Tensor,
                      tgt_pts4: torch.Tensor, tgt_featw: torch.Tensor,
                      sigma: float = 1.5, radius_factor: float = 2.0,
                      ts: int = 256, tt: int = 512) -> torch.Tensor:
    """Radius-capped Cauchy correlation scores (H,). pts_t (H, S, 4)
    transformed source points (4th column ignored), src_featw (S, C),
    tgt_pts4 (T, 4), tgt_featw (T, C) f32, C = 32 on CUDA. `ts`/`tt` are
    the TPU kernel's tile sizes, kept for signature parity: the CUDA
    kernel tiles on its own and takes any S and T."""
    global LAUNCHES
    if pts_t.device.type == "cpu":
        return corr_scores_plain(pts_t, src_featw, tgt_pts4, tgt_featw,
                                 sigma=sigma, radius_factor=radius_factor)
    dev = pts_t.device
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"corr_scores_fused runs on CUDA or CPU tensors, not {dev}")
    H, S, _ = pts_t.shape
    T = tgt_pts4.shape[0]
    _build.require(pts_t, "pts_t", torch.float32, (None, None, 4), dev)
    _build.require(src_featw, "src_featw", torch.float32, (S, 32), dev)
    _build.require(tgt_pts4, "tgt_pts4", torch.float32, (None, 4), dev)
    _build.require(tgt_featw, "tgt_featw", torch.float32, (T, 32), dev)
    out = torch.empty(H, dtype=torch.float32, device=dev)
    if H == 0:
        return out
    partial = torch.empty((H, -(-S // _TS)), dtype=torch.float32, device=dev)
    inv_s2, r2 = _constants(sigma, radius_factor)
    code = lib.umr_corr_scores(
        pts_t.data_ptr(), src_featw.data_ptr(), tgt_pts4.data_ptr(),
        tgt_featw.data_ptr(), partial.data_ptr(), out.data_ptr(), H, S, T, 32,
        float(inv_s2), float(r2), _build.stream_of(dev))
    _build.check(lib, code, "corr_scores_fused")
    LAUNCHES += 1
    return out
