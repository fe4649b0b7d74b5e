"""Checkpoint loading for the port.

The repository's checkpoints (weights/*.pkl) are pickles of plain numpy
pytrees written by the JAX package's trainer: {"params": ..., "bn_state":
...} with conv weights (k^3, Cin, Cout) for k in 3, 5, 7, taps in
lexicographic (dx, dy, dz) order, dz fastest; 'BN' blocks carry `conv2` /
`norm2` entries beside `conv1` / `norm1`. They load with `pickle` alone,
through an unpickler that builds numpy arrays and plain Python values
only: any other class (the optax states in the opt_state of the JAX
package's training checkpoints) becomes a `ForeignObject` stand-in, and
no module outside numpy is imported. `params_to_jax` writes a ResUNet
back in the JAX package's layout.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, Tuple

import numpy as np
import torch

from umeregrobust_tpu_torch.devices import resolve_device
from umeregrobust_tpu_torch.models.resunet import ArchSpec, ResUNet

__all__ = ["load_checkpoint", "params_from_jax", "params_to_jax",
           "model_from_params", "load_model", "ForeignObject"]

_SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int",
                  "float", "complex", "bool", "str", "bytes", "bytearray",
                  "slice", "range"}


class ForeignObject:
    """What the checkpoint reader builds for a class of another library
    (`qualname` names it); its state and arguments are kept."""

    qualname = "?"

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if module in ("builtins", "__builtin__") and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        if module == "collections" and name == "OrderedDict":
            return super().find_class(module, name)
        return type(name, (ForeignObject,), {"qualname": f"{module}.{name}"})


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint dict with numpy leaves (params, bn_state, ...), read
    without importing anything beyond numpy."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


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


def params_to_jax(model: ResUNet) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, bn_state) of a ResUNet as the JAX package's nested numpy
    pytrees (float32): parameters by their dotted names, BN running
    statistics (buffers) by theirs."""
    params: Dict[str, Any] = {}
    bn_state: Dict[str, Any] = {}
    for tree, items in ((params, model.named_parameters()),
                        (bn_state, model.named_buffers())):
        for name, t in items:
            node = tree
            *path, leaf = name.split(".")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = t.detach().to("cpu", torch.float32).numpy().copy()
    return params, bn_state


def model_from_params(params: Dict[str, Any], bn_state: Dict[str, Any],
                      arch: ArchSpec, device="cuda", in_channels: int = 1,
                      out_channels: int = 32,
                      conv_impl: str = "grouped") -> ResUNet:
    """A ResUNet in eval mode with the (params, bn_state) pytrees' weights
    (every entry of the state dict, strictly), on `device` (the card
    unless `device="cpu"`; raises without CUDA) (`conv_impl`: see
    models.resunet.ResUNet)."""
    device = resolve_device(device)
    model = ResUNet(arch, in_channels, out_channels, conv_impl)
    model.load_state_dict(params_from_jax(params, bn_state), strict=True)
    return model.to(device).eval()


def load_model(path: str, arch: ArchSpec, device="cuda", in_channels: int = 1,
               out_channels: int = 32, conv_impl: str = "grouped") -> ResUNet:
    """model_from_params with a .pkl checkpoint's weights."""
    blob = load_checkpoint(path)
    return model_from_params(blob["params"], blob["bn_state"], arch, device,
                             in_channels, out_channels, conv_impl)
