"""MinkowskiEngine checkpoint (.pth) -> the port's parameters (the port's
own copy of umeregrobust_tpu/models/convert.py, numpy leaves).

Converts the reference's released ``weights/*_coloring_best_checkpoint.pth``
state dicts (``checkpoint['model_state_dict']``, reference
train_coloring.py:215-222) into (params, bn_state) pytrees of numpy
arrays, which ``models.weights.params_from_jax`` turns into a ResUNet
state dict. The reference's layer names carry over one to one:

  conv{i}[_tr].kernel (K^3, Cin, Cout)        -> params[...]['w']
  norm{i}[_tr].bn.{weight,bias}               -> params[...]['scale'/'bias']
  norm{i}[_tr].bn.running_{mean,var}          -> bn_state[...]['mean'/'var']
  block{i}[_tr].conv{j} / .norm{j}            -> nested likewise
  mlp1.kernel (Cin, Cout), final.kernel / .bias -> params['mlp1'/'final']

Tap order: this package enumerates (dx, dy, dz) in {-1, 0, 1}^3 with dz
fastest; MinkowskiEngine's kernel region iterates with the first spatial
axis fastest. ``offset_permutation`` maps one order onto the other
(``me_order='x_fastest'``, ME's convention, by default; 'z_fastest' is the
identity). The released checkpoints are not in the repository, so the
ME convention is encoded but not yet checked against real weights;
``decide_me_order`` reads it off a trained checkpoint's anisotropy.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["convert_state_dict", "load_torch_checkpoint",
           "offset_permutation", "decide_me_order", "to_me_state_dict"]


def offset_permutation(kernel_size: int, me_order: str = "x_fastest") -> np.ndarray:
    """perm such that ours[k] = theirs[perm[k]] for kernel offset tables."""
    r = kernel_size // 2
    rng = list(range(-r, r + 1))
    ours = list(itertools.product(rng, rng, rng))  # dz fastest
    if me_order == "z_fastest":
        theirs = ours
    elif me_order == "x_fastest":
        theirs = [(dx, dy, dz) for dz in rng for dy in rng for dx in rng]
    else:
        raise ValueError(me_order)
    lut = {off: i for i, off in enumerate(theirs)}
    return np.asarray([lut[o] for o in ours], dtype=np.int64)


def _to_np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def convert_state_dict(
    sd: Mapping[str, Any], me_order: str = "x_fastest"
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A MinkowskiEngine state dict -> (params, bn_state) pytrees with
    float32 numpy leaves; raises KeyError on a key it does not know."""
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}

    def put(tree, path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for key, val in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        parts = key.split(".")
        arr = _to_np(val)
        leaf = parts[-1]
        # MinkowskiBatchNorm's ".bn." wrapper drops out of the path
        path = [p for p in parts[:-1] if p != "bn"]
        if leaf == "kernel":
            if arr.ndim == 3:  # (K^3, Cin, Cout): reorder the taps
                k = round(arr.shape[0] ** (1.0 / 3.0))
                arr = arr[offset_permutation(k, me_order)]
            put(params, path + ["w"], arr)
        elif leaf == "bias" and parts[-2] != "bn":
            put(params, path + ["b"], arr)
        elif leaf == "weight":  # BN scale
            put(params, path + ["scale"], arr)
        elif leaf == "bias":  # BN bias (parts[-2] == 'bn')
            put(params, path + ["bias"], arr)
        elif leaf == "running_mean":
            put(state, path + ["mean"], arr)
        elif leaf == "running_var":
            put(state, path + ["var"], arr)
        else:
            raise KeyError(f"unhandled checkpoint key: {key}")
    return params, state


def to_me_state_dict(
    params: Mapping[str, Any], bn_state: Mapping[str, Any],
    me_order: str = "x_fastest",
) -> Dict[str, np.ndarray]:
    """The inverse of convert_state_dict: (params, bn_state) pytrees ->
    a state dict in MinkowskiEngine key naming and `me_order` tap order
    (float32 numpy; each BN also gets num_batches_tracked = 0), e.g. to
    write a .pth of this project's weights."""
    sd: Dict[str, np.ndarray] = {}
    leaves = {"w": "kernel", "b": "bias", "scale": "bn.weight",
              "bias": "bn.bias", "mean": "bn.running_mean",
              "var": "bn.running_var"}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, prefix + [k])
                continue
            arr = np.array(v, dtype=np.float32)
            if k == "w" and arr.ndim == 3:
                k3 = round(arr.shape[0] ** (1.0 / 3.0))
                arr = arr[np.argsort(offset_permutation(k3, me_order))]
            sd[".".join(prefix + [leaves[k]])] = arr
            if k == "mean":
                sd[".".join(prefix + ["bn.num_batches_tracked"])] = np.zeros(
                    (), np.int64)

    walk(params, [])
    walk(bn_state, [])
    return sd


def decide_me_order(sd: Mapping[str, Any]) -> Tuple[str, float]:
    """The kernel-offset order of a trained checkpoint, and its margin.

    'x_fastest' and 'z_fastest' differ by an x <-> z transpose of every
    (k, k, k, Cin, Cout) kernel volume, y fixed, so an axis-symmetric
    statistic cannot tell them apart. LiDAR scenes are ground-plane
    dominated: trained kernels treat x and y alike and z differently. Under
    the true layout the first axis's total variation matches y's; under
    the transposed one z takes its place and the mismatch grows.

    Returns (order, margin): margin > 0 means the statistic favoured the
    returned order (the relative gap between the two scores); below ~0.1
    treat it as undecided and compare end-to-end recall of both.
    """
    scores = {}
    for order in ("x_fastest", "z_fastest"):
        mismatch = total = 0.0
        for key, val in sd.items():
            if not key.endswith("kernel"):
                continue
            arr = _to_np(val)
            if arr.ndim != 3:
                continue
            k = round(arr.shape[0] ** (1.0 / 3.0))
            if k ** 3 != arr.shape[0] or k < 3:
                continue
            perm = offset_permutation(k, order)
            vol = arr[perm].reshape(k, k, k, *arr.shape[1:])  # (x, y, z, ...)
            tv = [float(np.abs(np.diff(vol, axis=a)).mean()) for a in range(3)]
            mismatch += abs(tv[0] - tv[1])  # x-vs-y anisotropy
            total += (tv[0] + tv[1]) / 2.0
        scores[order] = mismatch / max(total, 1e-12)
    best = min(scores, key=scores.get)
    other = "z_fastest" if best == "x_fastest" else "x_fastest"
    margin = (scores[other] - scores[best]) / max(scores[other], 1e-12)
    return best, float(margin)


def load_torch_checkpoint(
    path: str, me_order: str = "x_fastest"
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, bn_state) of a reference .pth checkpoint. It is read with
    ``torch.load(weights_only=True)``: a file that needs arbitrary
    unpickling is refused (torch raises), never loaded unsafely."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    return convert_state_dict(sd, me_order=me_order)
