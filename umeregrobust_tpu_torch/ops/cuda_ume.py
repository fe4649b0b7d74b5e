"""Capped ball-query UME moments: wrapper of the CUDA kernel
csrc/ume_moments.cu and its plain PyTorch version (port of
umeregrobust_tpu/ops/pallas_ume.py).

out[k] = sum_n w[k, n] * Z[n], w[k, n] = 1 iff point n is valid, lies
within `radius` of keypoint k (direct-difference distance), and is among
the first `max_nn` such points in index order, or the first caps[k] where
the caller gives per-keypoint caps (a points block of a sharded cloud,
parallel/points_sharded). On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel
(which first packs the coordinates into a scratch buffer that the wrapper
allocates) or raises. The kernel works on slices of 128 columns (4C at C
= 32); other widths are zero-padded to a multiple of 128 and the slices
run as one grid. Columns are independent, so every real column keeps the
bits it has at any width.
"""
from __future__ import annotations

from typing import Optional

import torch

from umeregrobust_tpu_torch.ops import _build
from umeregrobust_tpu_torch.ops.neighbors import sqdist3

__all__ = ["ume_moments_fused", "ume_moments_plain", "padded_width",
           "LAUNCHES"]

LAUNCHES = 0  # kernel launches by ume_moments_fused
_SLICE = 128  # columns of a slice of the kernel (csrc kCols)


def padded_width(width: int) -> int:
    """The kernel's column count for Z of `width` columns: the next
    multiple of 128 (at least one slice)."""
    return max(1, -(-int(width) // _SLICE)) * _SLICE


def _r2(radius: float) -> torch.Tensor:
    return torch.tensor(float(radius) ** 2, dtype=torch.float32)


def ume_moments_plain(kpts: torch.Tensor, pts: torch.Tensor, Z: torch.Tensor,
                      p_mask: torch.Tensor, radius: float, max_nn: int,
                      chunk: int = 256,
                      caps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """([B,] M, 4C) fp32 capped moments, chunked over keypoints; caps
    ([B,] M) int32, when given, cap each keypoint in place of max_nn."""
    r2 = _r2(radius).to(pts.device)
    pts = pts.to(torch.float32)
    Z = Z.to(torch.float32)
    out = []
    for s in range(0, kpts.shape[-2], chunk):
        ok = (sqdist3(kpts[..., s:s + chunk, :].to(torch.float32), pts)
              <= r2) & p_mask[..., None, :]
        cum = torch.cumsum(ok.to(torch.int32), dim=-1)
        cap = max_nn if caps is None else caps[..., s:s + chunk, None]
        w = (ok & (cum <= cap)).to(torch.float32)
        out.append(w @ Z)
    if not out:
        return torch.zeros(kpts.shape[:-2] + (0, Z.shape[-1]),
                           dtype=torch.float32, device=Z.device)
    return torch.cat(out, dim=-2)


def ume_moments_fused(kpts: torch.Tensor, pts: torch.Tensor, Z: torch.Tensor,
                      p_mask: torch.Tensor, radius: float, max_nn: int,
                      caps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Capped UME moments ([B,] M, W) f32 for any width W (4C). kpts
    ([B,] M, 3) f32, pts ([B,] N, 3) f32, Z ([B,] N, W) f32, p_mask ([B,]
    N) bool; with a leading pair axis B, pair b's keypoints see pair b's
    points, all pairs and column slices in one launch. caps ([B,] M)
    int32, when given, is each keypoint's cap in place of max_nn (0: a
    zero row); without it the kernel runs as it always has."""
    global LAUNCHES
    if kpts.device.type == "cpu":
        return ume_moments_plain(kpts, pts, Z, p_mask, radius, max_nn,
                                 caps=caps)
    dev = kpts.device
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"ume_moments_fused runs on CUDA or CPU tensors, not {dev}")
    lead = tuple(kpts.shape[:-2])
    if len(lead) > 1:
        raise ValueError("ume_moments_fused takes at most one leading pair "
                         f"axis, got kpts of shape {tuple(kpts.shape)}")
    B = lead[0] if lead else 1
    M, N = kpts.shape[-2], pts.shape[-2]
    _build.require(kpts, "kpts", torch.float32, lead + (None, 3), dev)
    _build.require(pts, "pts", torch.float32, lead + (None, 3), dev)
    _build.require(Z, "Z", torch.float32, lead + (N, None), dev)
    _build.require(p_mask, "p_mask", torch.bool, lead + (N,), dev)
    if caps is not None:
        _build.require(caps, "caps", torch.int32, lead + (M,), dev)
    W = Z.shape[-1]
    Wp = padded_width(W)
    if M == 0 or B == 0 or W == 0:
        return torch.zeros(lead + (M, W), dtype=torch.float32, device=dev)
    if Wp != W:
        Z = torch.nn.functional.pad(Z, (0, Wp - W))
    out = torch.empty(lead + (M, Wp), dtype=torch.float32, device=dev)
    scratch = torch.empty((B * lib.umr_ume_moments_scratch(N),),
                          dtype=torch.float32, device=dev)
    code = lib.umr_ume_moments(
        kpts.data_ptr(), pts.data_ptr(), Z.data_ptr(), p_mask.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), B, M, N, Wp,
        float(radius) ** 2,  # rounded to fp32 in the call, as _r2 rounds it
        int(max_nn), None if caps is None else caps.data_ptr(),
        _build.stream_of(dev))
    _build.check(lib, code, "ume_moments_fused")
    LAUNCHES += 1
    return out if Wp == W else out[..., :W].contiguous()
