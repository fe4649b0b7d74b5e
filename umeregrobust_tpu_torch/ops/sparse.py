"""Sparse 3D convolution pieces of the ResUNetSmall2 path (port of the
parts of umeregrobust_tpu/ops/sparse.py that the fast geometry and the
grouped conv use).

A level is (coords (N, 4) int32 [b, x, y, z], mask (N,)) in canonical
code-sorted order with a valid prefix. A k=3 kernel map is kept in the
grouped-window form (`GroupedMap`): levels are sorted with z fastest, so
the <= 3 z-candidates of a (dx, dy) offset group are consecutive rows of
the input level, and one wide gather of a centred 3-row window per group
replaces 3 per-tap gathers. Tap order is lexicographic over (dx, dy, dz)
in {-1, 0, 1}^3 with dz fastest, as in the checkpoints.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from umeregrobust_tpu_torch.ops.sortmaps import (
    KEY_SENTINEL, QUERY_SENTINEL, pack_code)

__all__ = ["Level", "GroupedMap", "WINDOW_PAD", "sort_level",
           "downsample_coords", "code_window_table", "window_probe",
           "group_kernel_map", "ungroup_kernel_map", "sparse_conv_grouped",
           "masked_batch_norm", "round_to"]

# window-table pad word: above every valid code, distinct from both
# sentinels and their +-stride neighbourhoods
WINDOW_PAD = 0x7F000001


class Level(NamedTuple):
    coords: torch.Tensor  # (N, 4) int32
    mask: torch.Tensor  # (N,) bool


def sort_level(coords: torch.Tensor, mask: torch.Tensor
               ) -> Tuple[Level, torch.Tensor, torch.Tensor]:
    """Canonical code-sorted level; returns (level, order, inv) with
    order[p] = input row at sorted position p and inv its inverse."""
    code = pack_code(coords, mask, KEY_SENTINEL)
    order = torch.argsort(code, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return Level(coords=coords[order], mask=mask[order]), order, inv


def downsample_coords(coords: torch.Tensor, mask: torch.Tensor,
                      out_stride: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """unique(floor(c / s) * s) in code-sorted order with a valid prefix,
    padded to `capacity` (overflow beyond it is dropped)."""
    s = int(out_stride)
    q = torch.cat([coords[:, :1], torch.div(coords[:, 1:], s,
                                            rounding_mode="floor") * s], -1)
    code = pack_code(q, mask, KEY_SENTINEL)
    code_s, row_s = torch.sort(code, stable=True)
    valid_s = code_s < QUERY_SENTINEL
    first = torch.ones_like(valid_s)
    first[1:] = code_s[1:] != code_s[:-1]
    first = first & valid_s
    pos = torch.cumsum(first.to(torch.int64), 0) - 1
    n_unique = int(first.sum())
    take = first & (pos < capacity)
    out = torch.zeros((capacity, 4), dtype=coords.dtype, device=coords.device)
    out[pos[take]] = q[row_s[take]]
    out_mask = torch.arange(capacity, device=coords.device) < min(n_unique,
                                                                  capacity)
    return out, out_mask


def code_window_table(key_code: torch.Tensor) -> torch.Tensor:
    """(N + 1, 3): row j = (code[j-2], code[j-1], code[j]), WINDOW_PAD
    outside the array; indexing at rank + 1 gives rows rank-1..rank+1."""
    pad = torch.full((1,), WINDOW_PAD, dtype=key_code.dtype,
                     device=key_code.device)
    km1 = torch.cat([pad, pad, key_code[:-1]])
    k0 = torch.cat([pad, key_code])
    kp1 = torch.cat([key_code, pad])
    return torch.stack([km1, k0, kp1], dim=1)


def window_probe(rank: torch.Tensor, c: torch.Tensor, wtab: torch.Tensor,
                 step: int):
    """Presence (v0, v1, v2) of the candidates c-step, c, c+step given the
    rank join of c. The z-field guards keep code arithmetic from wrapping
    into the y field at the +-256-unit z boundary."""
    j = torch.clamp(rank + 1, 0, wtab.shape[0] - 1)
    w = wtab[j]
    kprev, kc, knext = w[..., 0], w[..., 1], w[..., 2]
    zf = c & 511
    v1 = kc == c
    v0 = (torch.where(v1, kprev, kc) == c - step) & (zf >= step)
    v2 = (knext == c + step) & (zf < 512 - step)
    return v0, v1, v2


class GroupedMap(NamedTuple):
    """Centred-window form of a k=3 kernel map (see the JAX package's
    ops/sparse.GroupedMap).

    center: (9, N_out) int64 row + 1 into the centred window table
    masks:  (9, 3, N_out) bool slot validity
    patho:  (9, N_out) bool rows whose dz=+1 candidate sits at slot 1
    worder: (3,) int64 tap of each ascending-row slot ([2, 1, 0] for
            transposed convs, whose rows descend with dz)
    """

    center: torch.Tensor
    masks: torch.Tensor
    patho: torch.Tensor
    worder: torch.Tensor


def group_kernel_map(nbr: torch.Tensor, z_reversed: bool = False) -> GroupedMap:
    """(27, N_out) tap map -> GroupedMap (the map must come from a
    code-sorted level)."""
    K, n = nbr.shape
    if K != 27:
        raise ValueError(f"grouped maps are k=3 only, got {K} taps")
    g = nbr.reshape(9, 3, n)
    if z_reversed:
        g = g.flip(1)
    v0, v1, v2 = g[:, 0] >= 0, g[:, 1] >= 0, g[:, 2] >= 0
    c = torch.where(v1, g[:, 1], torch.where(
        v0, g[:, 0] + 1, torch.where(v2, g[:, 2] - 1,
                                     torch.full_like(g[:, 1], n + 1))))
    masks = torch.stack([v0, v1, v2 & (v1 | ~v0)], dim=1)
    patho = v0 & ~v1 & v2
    worder = torch.tensor([2, 1, 0] if z_reversed else [0, 1, 2],
                          device=nbr.device)
    return GroupedMap(center=(c + 1).to(torch.int64), masks=masks,
                      patho=patho, worder=worder)


def ungroup_kernel_map(gmap: GroupedMap) -> torch.Tensor:
    """GroupedMap -> (27, N_out) per-tap map (-1 where absent)."""
    c = gmap.center - 1
    m0, m1, m2 = gmap.masks[:, 0], gmap.masks[:, 1], gmap.masks[:, 2]
    neg = torch.full_like(c, -1)
    r0 = torch.where(m0, c - 1, neg)
    r1 = torch.where(m1, c, neg)
    r2 = torch.where(m2, c + 1, torch.where(gmap.patho, c, neg))
    g = torch.stack([r0, r1, r2], dim=1)[:, gmap.worder]
    return g.reshape(27, g.shape[-1])


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` and back to fp32: a product of two such values
    is exact in fp32, so an fp32 matmul over them gives the bf16-operand,
    fp32-accumulate result that the JAX package computes."""
    x = x.to(torch.float32)
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def sparse_conv_grouped(feats: torch.Tensor, weights: torch.Tensor,
                        gmap: GroupedMap,
                        compute_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Sparse k=3 conv with grouped window gathers. feats (N_in, Cin),
    invalid rows zero; weights (27, Cin, Cout). Returns (N_out, Cout) fp32.
    Operands are rounded to compute_dtype, products summed in fp32."""
    _, Cin, Cout = weights.shape
    G, _, N_out = gmap.masks.shape
    N_in = feats.shape[0]
    f = round_to(feats, compute_dtype)
    z = torch.zeros((1, Cin), dtype=f.dtype, device=f.device)
    F3c = torch.cat([torch.cat([z, z, f, z]), torch.cat([z, f, z, z]),
                     torch.cat([f, z, z, z])], dim=1)  # (N_in + 3, 3 Cin)
    w3 = round_to(weights, compute_dtype).reshape(G, 3, Cin, Cout)[
        :, gmap.worder]
    # "no candidate" centres of maps whose N_out > N_in point past the
    # table: clamp onto the all-zero last row (JAX clamps gathers the same)
    center = torch.clamp(gmap.center, max=N_in + 2)
    out = torch.zeros((N_out, Cout), dtype=torch.float32, device=f.device)
    for g in range(G):
        wide = F3c[center[g]].reshape(N_out, 3, Cin)
        masked = wide * gmap.masks[g].T[:, :, None].to(f.dtype)
        mid = masked[:, 2] + wide[:, 1] * gmap.patho[g][:, None].to(f.dtype)
        x3 = torch.cat([masked[:, 0], masked[:, 1], mid], dim=1)
        out = out + x3 @ w3[g].reshape(3 * Cin, Cout)
    return out


def masked_batch_norm(feats: torch.Tensor, mask: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor,
                      running_mean: torch.Tensor, running_var: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm with running statistics; invalid rows re-zeroed."""
    inv = torch.rsqrt(running_var + eps)
    out = (feats - running_mean[None, :]) * (inv * scale)[None, :] \
        + bias[None, :]
    return out * mask.to(torch.float32)[:, None]
