"""UME subspace-distance matching (port of the argmin and probabilistic-
filter parts of umeregrobust_tpu/pipeline/matching.py; the Hungarian
path is not ported yet)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from umeregrobust_tpu_torch.core.ume import projection_packed
from umeregrobust_tpu_torch.pipeline.sampling import weighted_sample

__all__ = ["argmin_match", "probabilistic_match_filter"]


def argmin_match(
    ume_src: torch.Tensor,
    ume_tgt: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per source keypoint, the target minimizing the subspace distance and
    that distance: (m (M,) int64, -1 on invalid sources; d (M,) f32, 1e6 on
    invalid sources). The cross term runs in full fp32 (the JAX package
    uses Precision.HIGH, 3 bf16 passes, on the TPU)."""
    A = projection_packed(ume_src)
    B = projection_packed(ume_tgt)
    sq1 = torch.sum(A * A, dim=-1)
    sq2 = torch.sum(B * B, dim=-1)
    if tgt_mask is not None:
        sq2 = torch.where(tgt_mask, sq2, torch.full_like(sq2, 1e30))
    ms, ds = [], []
    for s in range(0, A.shape[0], chunk):
        dist2 = sq1[s:s + chunk, None] + sq2[None, :] - 2.0 * (
            A[s:s + chunk] @ B.T)
        j = torch.argmin(dist2, dim=-1)
        ms.append(j)
        ds.append(torch.gather(dist2, 1, j[:, None])[:, 0])
    m = torch.cat(ms)
    d = torch.sqrt(torch.clamp(torch.cat(ds), min=0.0)) / math.sqrt(2.0)
    if src_mask is not None:
        m = torch.where(src_mask, m, torch.full_like(m, -1))
        d = torch.where(src_mask, d, torch.full_like(d, 1e6))
    return m, d


def probabilistic_match_filter(
    match_dist: torch.Tensor,
    num_keep: int,
    tau: float,
    generator: Optional[torch.Generator] = None,
    idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """num_keep match indices ~ softmax((1 - d) / tau) without replacement
    (reference evaluate.py:233-245): (num_keep,) int64. `idx` injects the
    draw instead of sampling."""
    if idx is not None:
        return idx
    logits = (1.0 - match_dist) / tau
    a = torch.exp(logits - torch.max(logits))
    return weighted_sample(a / torch.sum(a), num_keep, generator)
