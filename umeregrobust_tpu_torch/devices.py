"""Where the port's entry points run: the card unless the caller asks for
the CPU, with no silent fallback."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_device"]


def resolve_device(device="cuda") -> torch.device:
    """torch.device(device); raises for a CUDA device on a machine without
    CUDA (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def to_device(x, dev, dtype=None):
    """A numpy array or tensor as a tensor on `dev` (of `dtype`); None
    stays None."""
    if x is None:
        return None
    t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
    return t.to(device=dev, dtype=dtype)
