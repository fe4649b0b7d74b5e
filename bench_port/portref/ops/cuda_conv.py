"""Per-tap sparse convolution, the plain version of the port's
ops/cuda_conv.py (its kernels' arithmetic, without the kernels):

    out[i] = sum_k feats[nbr[k, i]] @ w[k]   (index < 0 or >= N_in: zero row)

Operands are rounded to `compute_dtype` and the products summed in fp32
(no TF32). The weights' gradient is dW[k] = sum over tap k's entries
(o, i) of X[i]^T dY[o]; the input's gradient is the forward conv of dY
over the inverted map with the weights transposed (ops/sparse.py
`sparse_conv`).
"""
from __future__ import annotations

import torch

from portref.ops.cuda_gather import gather_rows_plain

__all__ = ["sparse_conv_plain", "sparse_conv_wgrad_plain", "round_to"]


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` and back to fp32: a product of two such values
    is exact in fp32, so an fp32 matmul over them gives the bf16-operand,
    fp32-accumulate result that the JAX package computes."""
    x = x.to(torch.float32)
    if dtype == torch.float32:
        return x
    if dtype.itemsize == 1:
        return _Fp8Round.apply(x, dtype)
    return x.to(dtype).to(torch.float32)


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to an fp8 type, one scale a tensor to the format's
    range, and back to fp32."""
    amax = x.detach().abs().amax()
    s = torch.where(amax > 0, amax / torch.finfo(dtype).max,
                    torch.ones_like(amax))
    return (x / s).to(dtype).to(torch.float32) * s


class _Fp8Round(torch.autograd.Function):
    """fp8 rounding whose backward rounds the incoming gradient the same
    way, as a bf16 cast's backward rounds it to bf16."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return _fp8(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, ctx.dtype), None


def sparse_conv_plain(feats: torch.Tensor, weights: torch.Tensor,
                      nbr_map: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """The per-tap loop in tap order, each tap one fp32 matmul over
    operands rounded to compute_dtype. Returns (N_out, Cout) fp32."""
    f = round_to(feats, compute_dtype)
    out = torch.zeros((nbr_map.shape[1], weights.shape[2]),
                      dtype=torch.float32, device=feats.device)
    for k in range(weights.shape[0]):
        out = out + gather_rows_plain(f, nbr_map[k]) @ round_to(
            weights[k], compute_dtype)
    return out


def sparse_conv_wgrad_plain(feats: torch.Tensor, dout: torch.Tensor,
                            nbr_map: torch.Tensor,
                            compute_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """The weights' gradient (K, Cin, Cout) fp32 of the per-tap conv: per
    tap, the rows of feats it gathers (zero where absent) transposed times
    dout, one fp32 matmul over operands rounded to compute_dtype."""
    f = round_to(feats, compute_dtype)
    g = round_to(dout, compute_dtype)
    return torch.stack([gather_rows_plain(f, nbr_map[k]).T @ g
                        for k in range(nbr_map.shape[0])])
