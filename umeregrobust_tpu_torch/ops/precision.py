"""Matmul precision policy (port of umeregrobust_tpu/ops/precision.py).

Geometry goes through full fp32 products: coordinates at +-50 m through
a reduced-precision product move by centimetres, which breaks sub-voxel
correspondence search, moment accumulation and the closed-form
transforms. On the card that means TF32 off: `hp_matmul` and
`hp_transform_pts` turn it off for their own product, and `tf32_off` does
so for every matmul and convolution of a whole call (the entry points
and the trainer run inside it). The backbone's feature convs round their
operands to bf16 on purpose (compute_dtype) and sum in fp32.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["HIGHEST", "hp_matmul", "hp_transform_pts", "tf32_off"]

HIGHEST = "highest"  # torch.set_float32_matmul_precision's name for fp32


@contextlib.contextmanager
def tf32_off():
    """TF32 off for matmuls and convolutions (full fp32, the JAX numerics)
    while the call runs; the caller's settings come back afterwards."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def hp_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 matmul at full precision (TF32 off)."""
    with tf32_off():
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def hp_transform_pts(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rigid-transform points at full precision: R @ p + t, over any
    leading axes of T ([..., 4, 4]) and pts ([..., N, 3])."""
    R = T[..., :3, :3].to(torch.float32)
    t = T[..., :3, 3].to(torch.float32)
    with tf32_off():
        return torch.matmul(pts.to(torch.float32),
                            R.transpose(-1, -2)) + t[..., None, :]
