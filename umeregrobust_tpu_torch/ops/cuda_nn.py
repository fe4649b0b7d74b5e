"""Exact 1-NN argmin: wrapper of the CUDA kernel csrc/nn1_argmin.cu and
its plain PyTorch version (port of umeregrobust_tpu/ops/pallas_nn.py).

For each query, the index of the nearest valid reference point from
direct squared differences summed over c = 0, 1, 2; ties go to the first
index; masked rows are parked at 1e9 and never win. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from umeregrobust_tpu_torch.ops import _build
from umeregrobust_tpu_torch.ops.neighbors import sqdist3

__all__ = ["nn1_argmin", "nn1_argmin_plain", "LAUNCHES"]

LAUNCHES = 0  # kernel launches by nn1_argmin (not by the plain version)

_FAR = 1e9


def nn1_argmin_plain(queries: torch.Tensor, points: torch.Tensor,
                     p_mask: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """(M,) int64 index of the nearest valid point, in the kernel's
    arithmetic (one rounding per operation, first index on ties)."""
    p = torch.where(p_mask[:, None], points.to(torch.float32),
                    torch.full_like(points, _FAR, dtype=torch.float32))
    q = queries.to(torch.float32)
    out = []
    for s in range(0, q.shape[0], chunk):
        out.append(torch.argmin(sqdist3(q[s:s + chunk], p), dim=1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                  device=q.device)


def nn1_argmin(queries: torch.Tensor, points: torch.Tensor,
               p_mask: torch.Tensor) -> torch.Tensor:
    """Index of the nearest valid reference point per query: (M,) int64.
    queries (M, 3) f32, points (N, 3) f32, p_mask (N,) bool."""
    global LAUNCHES
    if queries.device.type == "cpu":
        return nn1_argmin_plain(queries, points, p_mask)
    dev = queries.device
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"nn1_argmin runs on CUDA or CPU tensors, not {dev}")
    M, N = queries.shape[0], points.shape[0]
    _build.require(queries, "queries", torch.float32, (None, 3), dev)
    _build.require(points, "points", torch.float32, (None, 3), dev)
    _build.require(p_mask, "p_mask", torch.bool, (N,), dev)
    if N == 0:
        raise ValueError("nn1_argmin needs at least one reference point")
    # enough segments of the reference cloud to put ~2 blocks on each SM
    q_blocks = -(-M // 128)
    S = max(1, min(-(-264 // max(q_blocks, 1)), -(-N // 1024)))
    out = torch.empty(M, dtype=torch.int64, device=dev)
    part_d2 = torch.empty((S, M), dtype=torch.float32, device=dev)
    part_idx = torch.empty((S, M), dtype=torch.int64, device=dev)
    if M == 0:
        return out
    code = lib.umr_nn1_argmin(
        queries.data_ptr(), points.data_ptr(), p_mask.data_ptr(),
        part_d2.data_ptr(), part_idx.data_ptr(), out.data_ptr(), M, N, S,
        _build.stream_of(dev))
    _build.check(lib, code, "nn1_argmin")
    LAUNCHES += 1
    return out
