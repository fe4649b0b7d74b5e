"""Checkpoint loading for the port.

The repository's checkpoints (weights/*.pkl) are pickles of plain numpy
pytrees written by the JAX package's trainer: {"params": ..., "bn_state":
...} with conv weights (k^3, Cin, Cout) for k in 3, 5, 7, taps in
lexicographic (dx, dy, dz) order, dz fastest; 'BN' blocks carry `conv2` /
`norm2` entries beside `conv1` / `norm1`. They load with `pickle` alone. Only unpickle
checkpoints this project wrote: unpickling can run arbitrary code.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict

import numpy as np
import torch

from umeregrobust_tpu_torch.devices import resolve_device
from umeregrobust_tpu_torch.models.resunet import ArchSpec, ResUNet

__all__ = ["load_checkpoint", "params_from_jax", "load_model"]


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint dict with numpy leaves (params, bn_state, ...)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


def params_from_jax(params: Dict[str, Any], bn_state: Dict[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """A ResUNet state_dict from the JAX package's (params, bn_state)
    pytrees: nested keys join with '.', BN running stats are buffers."""
    flat = _flatten(params)
    flat.update(_flatten(bn_state))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def load_model(path: str, arch: ArchSpec, device="cuda", in_channels: int = 1,
               out_channels: int = 32, conv_impl: str = "grouped") -> ResUNet:
    """A ResUNet in eval mode with the checkpoint's weights, on `device`
    (the card unless `device="cpu"`; raises without CUDA) (`conv_impl`:
    see models.resunet.ResUNet)."""
    device = resolve_device(device)
    blob = load_checkpoint(path)
    model = ResUNet(arch, in_channels, out_channels, conv_impl)
    model.load_state_dict(params_from_jax(blob["params"], blob["bn_state"]),
                          strict=True)
    return model.to(device).eval()
