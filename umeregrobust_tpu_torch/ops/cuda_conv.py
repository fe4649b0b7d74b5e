"""Per-tap sparse convolution: wrappers of the two CUDA kernels in
csrc/sparse_conv_taps.cu and their plain PyTorch version (port of the
Pallas gather-conv experiments conv_pallas_unroll and conv_pallas_taps in
tools/exp_pallas_gather.py, which compute
umeregrobust_tpu/ops/sparse.py:sparse_conv).

    out[i] = sum_k feats[nbr[k, i]] @ w[k]        (nbr < 0: zero row)

Operands are rounded to `compute_dtype` and the products summed in fp32
(no TF32). `sparse_conv_rowtile` walks all taps in one block per output
tile; `sparse_conv_tapsplit` splits the taps over grid z and adds the
partial sums in a fixed order. `choose_kernel` picks between them from the
shapes alone. On a CPU tensor the wrappers run the plain version; on a
CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from umeregrobust_tpu_torch.ops import _build
from umeregrobust_tpu_torch.ops.cuda_gather import gather_rows_plain

__all__ = ["sparse_conv_rowtile", "sparse_conv_tapsplit", "sparse_conv_plain",
           "choose_kernel", "round_to", "LAUNCHES", "TRACE"]

# kernel launches by each wrapper (not by the plain version)
LAUNCHES = {"sparse_conv_rowtile": 0, "sparse_conv_tapsplit": 0}
# when a list: one (kernel, N_in, N_out, Cin, Cout, K, S) per launch
TRACE: Optional[List[tuple]] = None

_SM_COUNT = 132  # H100 SXM
_TILE_ROWS = 64  # kTM of the kernels
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` and back to fp32: a product of two such values
    is exact in fp32, so an fp32 matmul over them gives the bf16-operand,
    fp32-accumulate result that the JAX package computes."""
    x = x.to(torch.float32)
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


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


def _tiles(n_out: int, cout: int) -> int:
    """Row x channel tiles of the kernels' grid (64 x 64, or 64 x 32 for
    fewer than 64 output channels)."""
    return max(1, -(-n_out // _TILE_ROWS)) * -(-cout // (64 if cout >= 64
                                                         else 32))


def _segments(n_out: int, cout: int, k_vol: int) -> int:
    """Tap segments for about two blocks per SM: at least 2 (where there
    are 2 taps), none of them empty."""
    want = min(k_vol, max(2, -(-2 * _SM_COUNT // _tiles(n_out, cout))))
    return -(-k_vol // -(-k_vol // want))


def choose_kernel(n_out: int, cout: int, k_vol: int) -> Tuple[str, int]:
    """("rowtile", 1) when the output tiles alone fill the SMs, else
    ("tapsplit", S) with S tap segments."""
    if _tiles(n_out, cout) >= _SM_COUNT or k_vol == 1:
        return "rowtile", 1
    return "tapsplit", _segments(n_out, cout, k_vol)


def _checked(feats, weights, nbr_map, compute_dtype, name):
    """Validate the kernels' inputs; returns (lib, dims)."""
    dev = feats.device
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {dev}")
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"{name}: compute_dtype fp32 or bf16, got "
                         f"{compute_dtype}")
    if nbr_map.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"nbr_map: expected int32 or int64, got "
                         f"{nbr_map.dtype}")
    K, Cin, Cout = weights.shape
    _build.require(feats, "feats", torch.float32, (None, Cin), dev)
    _build.require(weights, "weights", torch.float32, (K, Cin, Cout), dev)
    _build.require(nbr_map, "nbr_map", nbr_map.dtype, (K, None), dev)
    N_in, N_out = feats.shape[0], nbr_map.shape[1]
    if min(K, Cin, Cout) < 1 or K * Cin >= 2 ** 31 - 32 or Cout > 65535 * 32 \
            or max(N_in, N_out) >= 2 ** 31 - 64:
        raise ValueError(f"{name}: unsupported shape K={K} Cin={Cin} "
                         f"Cout={Cout} N_in={N_in} N_out={N_out}")
    return lib, (N_in, N_out, Cin, Cout, K)


def _note(kernel: str, dims, S: int) -> None:
    LAUNCHES[kernel] += 1
    if TRACE is not None:
        TRACE.append((kernel, *dims, S))


def sparse_conv_rowtile(feats: torch.Tensor, weights: torch.Tensor,
                        nbr_map: torch.Tensor,
                        compute_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """feats (N_in, Cin) f32 with invalid rows zero, weights (K, Cin, Cout)
    f32, nbr_map (K, N_out) int32/int64 (-1 absent) -> (N_out, Cout) f32."""
    if feats.device.type == "cpu":
        return sparse_conv_plain(feats, weights, nbr_map, compute_dtype)
    lib, dims = _checked(feats, weights, nbr_map, compute_dtype,
                         "sparse_conv_rowtile")
    N_in, N_out, Cin, Cout, K = dims
    out = torch.empty((N_out, Cout), dtype=torch.float32, device=feats.device)
    if N_out == 0:
        return out
    code = lib.umr_sparse_conv_rowtile(
        feats.data_ptr(), weights.data_ptr(), nbr_map.data_ptr(),
        out.data_ptr(), N_in, N_out, Cin, Cout, K,
        int(nbr_map.dtype == torch.int64),
        int(compute_dtype == torch.bfloat16), _build.stream_of(feats.device))
    _build.check(lib, code, "sparse_conv_rowtile")
    _note("sparse_conv_rowtile", dims, 1)
    return out


def sparse_conv_tapsplit(feats: torch.Tensor, weights: torch.Tensor,
                         nbr_map: torch.Tensor,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """The same function with the taps split into segments (enough for
    about two blocks per SM) whose partial sums are added in segment
    order."""
    if feats.device.type == "cpu":
        return sparse_conv_plain(feats, weights, nbr_map, compute_dtype)
    lib, dims = _checked(feats, weights, nbr_map, compute_dtype,
                         "sparse_conv_tapsplit")
    N_in, N_out, Cin, Cout, K = dims
    S = _segments(N_out, Cout, K)
    per_seg = -(-K // S)
    out = torch.empty((N_out, Cout), dtype=torch.float32, device=feats.device)
    if N_out == 0:
        return out
    partial = torch.empty((S, N_out, Cout), dtype=torch.float32,
                          device=feats.device)
    code = lib.umr_sparse_conv_tapsplit(
        feats.data_ptr(), weights.data_ptr(), nbr_map.data_ptr(),
        partial.data_ptr(), out.data_ptr(), N_in, N_out, Cin, Cout, K, S,
        per_seg, int(nbr_map.dtype == torch.int64),
        int(compute_dtype == torch.bfloat16), _build.stream_of(feats.device))
    _build.check(lib, code, "sparse_conv_tapsplit")
    _note("sparse_conv_tapsplit", dims, S)
    return out
