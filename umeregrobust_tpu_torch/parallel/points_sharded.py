"""Points-axis ('sp') sharded UME moment accumulation (port of
umeregrobust_tpu/parallel/points_sharded.py).

For clouds too large for one card, the capped ball-query moment sum
(pipeline/ume_gen.py) shards over the points axis: each 'sp' rank holds a
contiguous block of the points, as shard_map's P("sp") cuts them, sums
the moments of every keypoint over its block, and one all_reduce over
'sp' gives the whole cloud's moments.

The one dependency between blocks is the cap on the first `max_nn`
neighbours in *global* index order (PyTorch3D ball_query semantics). The
blocks are in index order, so a rank needs only the in-radius counts of
the ranks before it: one all_gather of an (M,) count vector turns the
global cap into the rank's own per-keypoint cap, max(max_nn - (counts of
the ranks before), 0), which the moments kernel takes as `caps`
(ops/cuda_ume.ume_moments_fused). `local_moments` is one rank's step, so
one process can also emulate S blocks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from umeregrobust_tpu_torch.devices import to_device
from umeregrobust_tpu_torch.ops.cuda_ume import ume_moments_fused
from umeregrobust_tpu_torch.ops.neighbors import sqdist3
from umeregrobust_tpu_torch.parallel.mesh import dim_rank, mesh_device
from umeregrobust_tpu_torch.pipeline.ume_gen import (
    moment_rows, moments_to_ume)

__all__ = ["ume_from_ball_query_sp", "local_moments", "block_counts",
           "block_caps", "points_block"]


def points_block(x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Block `rank` of `size` contiguous blocks of x's leading (points)
    axis, which must divide by `size`."""
    N = x.shape[0]
    if N % size:
        raise ValueError(f"{N} points do not divide into {size} blocks")
    n = N // size
    return x[rank * n:(rank + 1) * n]


def block_counts(pts_blk: torch.Tensor, mask_blk: torch.Tensor,
                 kpts: torch.Tensor, radius: float,
                 chunk: int = 512) -> torch.Tensor:
    """(M,) int32: the block's valid points within `radius` of each
    keypoint, by the moments kernel's distance test (ops/neighbors.sqdist3,
    its arithmetic)."""
    r2 = torch.tensor(float(radius) ** 2, dtype=torch.float32,
                      device=pts_blk.device)
    out = [torch.sum((sqdist3(kpts[s:s + chunk], pts_blk) <= r2)
                     & mask_blk, dim=-1, dtype=torch.int32)
           for s in range(0, kpts.shape[0], chunk)]
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=pts_blk.device)
    return torch.cat(out)


def block_caps(counts: torch.Tensor, rank: int, max_nn: int) -> torch.Tensor:
    """(M,) int32 cap of block `rank`'s keypoints, from every block's
    counts (S, M): what is left of max_nn after the blocks before it."""
    before = torch.sum(counts[:rank], dim=0, dtype=torch.int32)
    return torch.clamp(int(max_nn) - before, min=0).to(torch.int32)


def local_moments(pts_blk: torch.Tensor, feats_blk: torch.Tensor,
                  mask_blk: torch.Tensor, kpts: torch.Tensor, radius: float,
                  caps: torch.Tensor) -> torch.Tensor:
    """(M, 4C) fp32 moments of one points block: each keypoint's first
    caps[k] valid in-radius points of the block, in index order, through
    the moments kernel (its plain version on CPU tensors)."""
    pts_blk = pts_blk.to(torch.float32).contiguous()
    Z = moment_rows(pts_blk, feats_blk, mask_blk)
    # caps stand in for max_nn, which the kernel then does not read
    return ume_moments_fused(kpts.to(torch.float32).contiguous(), pts_blk, Z,
                             mask_blk.contiguous(), radius=float(radius),
                             max_nn=0, caps=caps.contiguous())


def ume_from_ball_query_sp(
    mesh: DeviceMesh,
    pts,
    feats,
    kpts,
    radius: float,
    max_nn: int,
    p_mask=None,
    k_mask=None,
    normalize: bool = True,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Points-axis-sharded twin of pipeline/ume_gen.ume_from_ball_query.

    Every rank passes the whole cloud (pts (N, 3), feats (N, C), p_mask
    (N,)) and keypoints (M, 3); it keeps its 'sp' block of the points (N
    must divide by the 'sp' size). Returns the (M, C, 4) fp32 moments,
    the same on every rank: the single-device result up to the fp32
    order of the sum over blocks (bit for bit with one block).
    """
    dev = mesh_device(mesh)
    group = mesh.get_group("sp")
    r, S = dim_rank(mesh, "sp")
    pts = to_device(pts, dev, torch.float32)
    feats = to_device(feats, dev)
    N, C = feats.shape
    p_mask = (torch.ones((N,), dtype=torch.bool, device=dev)
              if p_mask is None else to_device(p_mask, dev, torch.bool))
    kpts = to_device(kpts, dev, torch.float32).contiguous()
    pts_b, feats_b, mask_b = (points_block(x, r, S)
                              for x in (pts, feats, p_mask))
    counts = block_counts(pts_b, mask_b, kpts, radius)
    all_counts = [torch.empty_like(counts) for _ in range(S)]
    dist.all_gather(all_counts, counts, group=group)
    caps = block_caps(torch.stack(all_counts), r, max_nn)
    F = local_moments(pts_b, feats_b, mask_b, kpts, radius, caps)
    dist.all_reduce(F, group=group)
    if k_mask is not None:
        k_mask = to_device(k_mask, dev)
    return moments_to_ume(F, C, normalize=normalize, eps=eps, k_mask=k_mask)
