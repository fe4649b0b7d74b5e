"""UME subspace-distance matching (port of
umeregrobust_tpu/pipeline/matching.py): the argmin matcher, the
probabilistic match filter, and the Hungarian assignment of the parity
path. The device functions take an optional leading pair axis."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from umeregrobust_tpu_torch import native
from umeregrobust_tpu_torch.core.ume import projection_packed
from umeregrobust_tpu_torch.pipeline.sampling import weighted_sample_batched

__all__ = ["argmin_match", "probabilistic_match_filter_batched",
           "hungarian_match"]


def argmin_match(
    ume_src: torch.Tensor,
    ume_tgt: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per source keypoint, the target minimizing the subspace distance and
    that distance: (m ([B,] M) int64, -1 on invalid sources; d ([B,] M) f32,
    1e6 on invalid sources), over an optional leading pair axis (one
    batched product a chunk). The cross term runs in full fp32 (the JAX
    package uses Precision.HIGH, 3 bf16 passes, on the TPU)."""
    A = projection_packed(ume_src)
    B = projection_packed(ume_tgt)
    sq1 = torch.sum(A * A, dim=-1)
    sq2 = torch.sum(B * B, dim=-1)
    if tgt_mask is not None:
        sq2 = torch.where(tgt_mask, sq2, torch.full_like(sq2, 1e30))
    Bt = B.transpose(-1, -2)
    ms, ds = [], []
    for s in range(0, A.shape[-2], chunk):
        dist2 = sq1[..., s:s + chunk, None] + sq2[..., None, :] - 2.0 * (
            A[..., s:s + chunk, :] @ Bt)
        j = torch.argmin(dist2, dim=-1)
        ms.append(j)
        ds.append(torch.gather(dist2, -1, j[..., None])[..., 0])
    m = torch.cat(ms, dim=-1)
    d = torch.sqrt(torch.clamp(torch.cat(ds, dim=-1), min=0.0)) / math.sqrt(
        2.0)
    if src_mask is not None:
        m = torch.where(src_mask, m, torch.full_like(m, -1))
        d = torch.where(src_mask, d, torch.full_like(d, 1e6))
    return m, d


def probabilistic_match_filter_batched(
    match_dist: torch.Tensor, num_keep: int, tau: float,
    generators: Sequence, fixed: Optional[Sequence] = None,
) -> torch.Tensor:
    """num_keep match indices a pair ~ softmax((1 - d) / tau) without
    replacement (reference evaluate.py:233-245), over a leading pair axis:
    match_dist (B, M) -> (B, num_keep) int64, pair b drawing from
    generators[b] unless fixed[b] injects its draw."""
    logits = (1.0 - match_dist) / tau
    a = torch.exp(logits - torch.max(logits, dim=-1, keepdim=True).values)
    return weighted_sample_batched(a / torch.sum(a, dim=-1, keepdim=True),
                                   num_keep, generators, fixed)


def hungarian_match(D: np.ndarray) -> np.ndarray:
    """Host-side optimal assignment over a distance matrix, returning (K, 2)
    int64 [src, tgt] pairs, K = min(M, N) (reference evaluate.py:216-222):
    the native Jonker-Volgenant solver (umeregrobust_tpu_torch/native), the
    JAX package's own, so tied costs give the same assignment in both;
    scipy's linear_sum_assignment where the native library cannot be
    built."""
    r, c = native.hungarian(np.asarray(D))
    return np.stack([r, c], axis=1).astype(np.int64)
