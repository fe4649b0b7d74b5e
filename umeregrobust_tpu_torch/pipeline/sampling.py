"""Random draws of the pipeline, from explicit torch.Generators.

The JAX package draws with jax.random; the two never give the same
numbers, so every sampling site also accepts injected indices (tests feed
it the JAX draws). A generator must live on the device it samples for.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["weighted_sample", "uniform_subset", "injected"]


def weighted_sample(p: torch.Tensor, n: int,
                    generator: torch.Generator) -> torch.Tensor:
    """n indices drawn without replacement with probabilities p (Gumbel-
    top-k): (n,) int64. Zero-probability rows come last."""
    u = torch.rand(p.shape, generator=generator, device=p.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    keys = torch.log(p) - torch.log(-torch.log(u))
    return torch.topk(keys, n).indices


def uniform_subset(N: int, k: int, generator: torch.Generator,
                   device) -> torch.Tensor:
    """k distinct indices of range(N), uniformly: (k,) int64."""
    return torch.randperm(N, generator=generator, device=device)[:k]


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
