"""Checkpoint save / restore of a training run (port of
umeregrobust_tpu/train/checkpoint.py): a pickle of numpy trees,
`format_version` 1, written atomically.

`params` and `bn_state` are written in the JAX package's pytree layout
(models/weights.params_to_jax), so the JAX package's load_checkpoint and
resunet_apply read the port's files, and the port reads JAX's. The
`opt_state` is the port's own: the torch optimizer's state_dict with its
tensors as numpy arrays. JAX's holds optax classes, so the port resumes
an optimizer only from its own checkpoints (`optimizer_state` raises for
a JAX one).
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

# the reader of either package's checkpoints (numpy leaves; other
# libraries' classes become ForeignObject stand-ins)
from umeregrobust_tpu_torch.models.weights import (
    ForeignObject, load_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "optimizer_state"]


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return tree


def save_checkpoint(path: str, *, params, bn_state, opt_state, epoch: int,
                    metrics: Dict[str, float] | None = None) -> None:
    """params / bn_state: nested dicts of arrays (the JAX layout);
    opt_state: a torch optimizer's state_dict (tensors become numpy)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {
        "epoch": int(epoch),
        "params": _to_numpy(params),
        "bn_state": _to_numpy(bn_state),
        "opt_state": _to_numpy(opt_state),
        "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        "format_version": 1,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn checkpoint


def _foreign(tree) -> bool:
    if isinstance(tree, ForeignObject):
        return True
    if isinstance(tree, dict):
        return any(_foreign(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_foreign(v) for v in tree)
    return False


def optimizer_state(blob: Dict[str, Any]) -> Dict[str, Any]:
    """A checkpoint's opt_state as a torch optimizer state_dict (CPU
    tensors; `load_state_dict` moves them to the parameters' device);
    raises for a checkpoint of the JAX package's trainer."""
    state = blob.get("opt_state")
    if _foreign(state) or not (isinstance(state, dict)
                               and "param_groups" in state):
        raise ValueError(
            "this checkpoint's optimizer state is not the port's (a JAX "
            "training checkpoint holds optax states): the port resumes "
            "training only from its own checkpoints; its params and "
            "bn_state load with Trainer.from_jax")
    return _to_torch(state)
