"""Random draws of the pipeline, from explicit torch.Generators.

The JAX package draws with jax.random; the two never give the same
numbers, so every sampling site also accepts injected indices (tests feed
it the JAX draws). A generator must live on the device it samples for.
Over a leading pair axis, pair i draws from its own generator, one small
call a pair and site, in the order a single pair draws, so generator i
seeded s gives pair i the draws a single-pair call seeded s gives.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["weighted_sample", "weighted_sample_batched", "sample_uniforms",
           "uniform_subset",
           "subset_batched", "injected", "injected_batched"]


def weighted_sample(p: torch.Tensor, n: int,
                    generator: torch.Generator) -> torch.Tensor:
    """n indices drawn without replacement with probabilities p (Gumbel-
    top-k): (n,) int64. Zero-probability rows come last."""
    return weighted_sample_batched(p[None], n, [generator])[0]


def sample_uniforms(N: int, generators: Sequence, fixed: Sequence,
                    device) -> Optional[torch.Tensor]:
    """The (B, N) uniforms weighted_sample_batched draws: pair b's from
    generators[b], ones for a pair whose `fixed` entry injects its draw;
    None when every pair injects (nothing is drawn)."""
    if all(f is not None for f in fixed):
        return None
    return torch.stack([
        torch.rand((N,), generator=g, device=device) if f is None
        else torch.ones((N,), device=device)
        for g, f in zip(generators, fixed)])


def weighted_sample_batched(p: torch.Tensor, n: int, generators: Sequence,
                            fixed: Optional[Sequence] = None,
                            u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """weighted_sample over a leading pair axis: p (B, N) -> (B, n) int64,
    pair b's uniforms from generators[b] (or from `u`, drawn earlier by
    sample_uniforms), one top-k for the batch. A pair whose `fixed` entry
    is an (n,) draw takes it and draws nothing."""
    fixed = list(fixed) if fixed is not None else [None] * p.shape[0]
    if all(f is not None for f in fixed):
        return torch.stack(fixed)
    if u is None:
        u = sample_uniforms(p.shape[1], generators, fixed, p.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    keys = torch.log(p) - torch.log(-torch.log(u))
    idx = torch.topk(keys, n, dim=-1).indices
    for b, f in enumerate(fixed):
        if f is not None:
            idx[b] = f
    return idx


def uniform_subset(N: int, k: int, generator: torch.Generator,
                   device) -> torch.Tensor:
    """k distinct indices of range(N), uniformly: (k,) int64."""
    return torch.randperm(N, generator=generator, device=device)[:k]


def subset_batched(N: int, k: int, generators: Sequence, device,
                   fixed: Sequence) -> torch.Tensor:
    """(B, k) int64: per pair its `fixed` draw, else k distinct indices of
    range(N) from its generator."""
    return torch.stack([f if f is not None else
                        uniform_subset(N, k, g, device)
                        for g, f in zip(generators, fixed)])


def injected_batched(draws: Sequence, name: str, n: int,
                     device) -> List[Optional[torch.Tensor]]:
    """Per pair, its injected draw `name` (see `injected`) or None."""
    return [injected(d, name, n, device) for d in draws]


def injected(draws: Optional[dict], name: str, n: int,
             device) -> Optional[torch.Tensor]:
    """The injected index draw `name` as an int64 tensor on `device`, or
    None when the caller injected none. Raises on a wrong length."""
    if not draws or draws.get(name) is None:
        return None
    idx = draws[name]
    if not torch.is_tensor(idx):
        idx = torch.from_numpy(np.array(idx, dtype=np.int64))
    idx = idx.to(device=device, dtype=torch.int64)
    if idx.shape != (n,):
        raise ValueError(f"injected draw {name!r}: expected ({n},), got "
                         f"{tuple(idx.shape)}")
    return idx
