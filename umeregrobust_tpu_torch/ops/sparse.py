"""Static-shape sparse 3D convolution: kernel maps and the two conv forms
(port of umeregrobust_tpu/ops/sparse.py).

A level is (coords (N, 4) int32 [b, x, y, z], mask (N,)) in canonical
code-sorted order with a valid prefix. A k=3 kernel map is kept in the
grouped-window form (`GroupedMap`): levels are sorted with z fastest, so
the <= 3 z-candidates of a (dx, dy) offset group are consecutive rows of
the input level, and one centred 3-row window per group replaces 3
per-tap rows: on the card one hand-written kernel a conv reads the
windows into its tensor-core products (ops/cuda_grouped.py), on the CPU
the plain version gathers them. Tap order is lexicographic over (dx, dy, dz)
in {-1, 0, 1}^3 with dz fastest, as in the checkpoints. Larger kernels
(k5, k7) and `conv_impl="scan"` keep the plain (K, N_out) per-tap map
(-1 = absent) and go through `sparse_conv`, whose CUDA path is the
hand-written kernels of ops/cuda_conv.py.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from umeregrobust_tpu_torch.ops.cuda_conv import (
    choose_kernel, round_to, sparse_conv_rowtile, sparse_conv_tapsplit,
    sparse_conv_wgrad)
from umeregrobust_tpu_torch.ops.cuda_grouped import (
    sparse_conv_grouped_dx, sparse_conv_grouped_kernel,
    sparse_conv_grouped_wgrad)
from umeregrobust_tpu_torch.ops.neighbors import gather_padded
from umeregrobust_tpu_torch.ops.sortmaps import (
    KEY_SENTINEL, QUERY_SENTINEL, SENTINEL_HIGH, batched_sorted_lookup,
    pack_code, sorted_join_code)

__all__ = ["Level", "GroupedMap", "InterfaceCandidates", "WINDOW_PAD",
           "sort_level", "downsample_coords", "kernel_offsets",
           "build_self_map", "build_conv_map", "build_transpose_map",
           "build_level_maps", "interface_candidates", "invert_map_batch",
           "code_window_table", "window_probe", "group_kernel_map",
           "ungroup_kernel_map", "sparse_conv", "sparse_conv_grouped",
           "sparse_conv_grouped_plain", "sparse_conv_grouped_wgrad_plain",
           "GroupedConv", "cloud_order",
           "masked_batch_norm", "round_to", "matmul_by_pair", "PerTapConv"]

# window-table pad word: above every valid code, distinct from both
# sentinels and their +-stride neighbourhoods
WINDOW_PAD = SENTINEL_HIGH | 0x7F000001


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
                      out_stride: int, capacity: int, pairs: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """unique(floor(c / s) * s) in code-sorted order with a valid prefix,
    padded to `capacity` (overflow beyond it is dropped). pairs=B > 1: the
    rows hold the 2B clouds of B pairs (batch index b of pair b // 2), each
    pair keeps at most `capacity` voxels (its lowest codes, as alone), and
    the level has B x capacity rows with one valid prefix."""
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
    if pairs == 1:
        take = first & (pos < capacity)
        n_keep = torch.clamp(torch.sum(first), max=capacity)
    else:  # rank within the pair; pairs are contiguous in code order
        pair = torch.clamp(q[row_s, 0].to(torch.int64) // 2, 0, pairs - 1)
        n_pair = torch.zeros(pairs, dtype=torch.int64,
                             device=coords.device).index_add_(
            0, pair, first.to(torch.int64))
        rank = pos - (torch.cumsum(n_pair, 0) - n_pair)[pair]
        keep = torch.clamp(n_pair, max=capacity)
        pos = (torch.cumsum(keep, 0) - keep)[pair] + rank
        take = first & (rank < capacity)
        n_keep = torch.sum(keep)
    out = torch.zeros((pairs * capacity, 4), dtype=coords.dtype,
                      device=coords.device)
    out[pos[take]] = q[row_s[take]]
    out_mask = torch.arange(pairs * capacity, device=coords.device) < n_keep
    return out, out_mask


def kernel_offsets(kernel_size: int, t: int) -> np.ndarray:
    """(K_vol, 4) int32 offsets (0, dx, dy, dz) * t, centred, dz fastest."""
    if kernel_size % 2 != 1:
        raise ValueError(f"only odd kernels, got {kernel_size}")
    r = kernel_size // 2
    rng = range(-r, r + 1)
    return np.asarray([(0, dx * t, dy * t, dz * t) for dx in rng for dy in rng
                       for dz in rng], dtype=np.int32)


def _build_map(in_level: Level, out_coords: torch.Tensor,
               out_mask: torch.Tensor, offsets: np.ndarray, sign: int
               ) -> torch.Tensor:
    """(K_vol, N_out) table of lookup(out + sign * offset_k) in in_level
    (any row order), by the generic join."""
    offs = torch.as_tensor(offsets, device=out_coords.device).to(torch.int64)
    K, N_out = offs.shape[0], out_coords.shape[0]
    q = (out_coords.to(torch.int64)[None] + sign * offs[:, None]).reshape(-1, 4)
    qm = out_mask[None].expand(K, N_out).reshape(-1)
    return batched_sorted_lookup(in_level.coords, in_level.mask, q, qm
                                 ).reshape(K, N_out)


def build_self_map(level: Level, kernel_size: int, t: int) -> torch.Tensor:
    """Stride-1 conv map at tensor stride t."""
    return _build_map(level, level.coords, level.mask,
                      kernel_offsets(kernel_size, t), +1)


def build_conv_map(in_level: Level, out_level: Level, kernel_size: int,
                   t_in: int) -> torch.Tensor:
    """Strided conv map: out voxel b gathers in voxels b + delta."""
    return _build_map(in_level, out_level.coords, out_level.mask,
                      kernel_offsets(kernel_size, t_in), +1)


def build_transpose_map(coarse_level: Level, fine_level: Level,
                        kernel_size: int, t_out: int) -> torch.Tensor:
    """Transposed conv map: fine out voxel a gathers coarse voxel
    a - delta_k (true-transpose weight indexing)."""
    return _build_map(coarse_level, fine_level.coords, fine_level.mask,
                      kernel_offsets(kernel_size, t_out), -1)


def build_level_maps(key_level: Level, requests: Sequence[tuple]
                     ) -> List[torch.Tensor]:
    """Several kernel maps against ONE code-sorted key level in one join.
    requests: (out_coords, out_mask, offsets, sign) per map, or (queries
    (..., 4), query_mask (...), None, _) for a ready query set, whose
    leading shape the result keeps. Returns one int64 lookup per request
    ((K_vol, N_out) for offset requests), -1 where absent."""
    codes, shapes = [], []
    for out_coords, out_mask, offsets, sign in requests:
        if offsets is None:
            q, qm = out_coords, out_mask
        else:
            offs = torch.as_tensor(offsets, device=out_coords.device
                                   ).to(torch.int64)
            q = out_coords.to(torch.int64)[None] + sign * offs[:, None]
            qm = out_mask[None].expand(offs.shape[0], out_coords.shape[0])
        shapes.append(tuple(qm.shape))
        codes.append(pack_code(q, qm, QUERY_SENTINEL).reshape(-1))
    k_code = pack_code(key_level.coords, key_level.mask, KEY_SENTINEL)
    res = sorted_join_code(k_code, torch.cat(codes))
    out, ofs = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(res[ofs: ofs + n].reshape(shape))
        ofs += n
    return out


class InterfaceCandidates(NamedTuple):
    coords: torch.Tensor  # (J^3, N_fine, 4) candidate coarse coordinates
    valid: torch.Tensor  # (J^3, N_fine)
    kidx: torch.Tensor  # (J^3, N_fine) kernel-offset index of each candidate


def interface_candidates(fine_level: Level, kernel: int, t: int, stride: int
                         ) -> InterfaceCandidates:
    """Candidate coarse parents of every fine voxel at a strided
    interface: per dimension only the deltas congruent to a mod (stride *
    t) can reach the coarse lattice, at most J = floor(2r / stride) + 1 of
    them, so a fine voxel has at most J^3 parents. One lookup of these
    gives both the encoder map and its adjoint decoder map."""
    r = kernel // 2
    st = stride * t
    J = (2 * r) // stride + 1
    dev = fine_level.coords.device
    a_sp = fine_level.coords[:, 1:].to(torch.int64)
    m = torch.remainder(a_sp, st)
    dmin = m - st * torch.div(m + r * t, st, rounding_mode="floor")
    jj = torch.as_tensor(np.stack(np.meshgrid(*([np.arange(J)] * 3),
                                              indexing="ij"),
                                  axis=-1).reshape(-1, 3), device=dev)
    delta = dmin[None] + jj[:, None] * st
    valid = torch.all(delta <= r * t, dim=-1) & fine_level.mask[None]
    b_sp = a_sp[None] - delta
    b = torch.cat([fine_level.coords[None, :, :1].to(torch.int64).expand(
        b_sp.shape[0], -1, -1), b_sp], dim=-1)
    k1d = torch.div(delta, t, rounding_mode="floor") + r
    kidx = (k1d[..., 0] * kernel + k1d[..., 1]) * kernel + k1d[..., 2]
    return InterfaceCandidates(coords=b, valid=valid, kidx=kidx)


def invert_map_batch(fwd: torch.Tensor, n_out: int) -> torch.Tensor:
    """Invert K injective lookup maps at once: inv[k][fwd[k][i]] = i, else
    -1. fwd (K, N_in) rows into [0, n_out), -1 absent."""
    K, N_in = fwd.shape
    dst = torch.where(
        fwd >= 0, torch.arange(K, device=fwd.device)[:, None] * n_out + fwd,
        K * n_out)  # misses write a spare last slot
    src = torch.arange(N_in, device=fwd.device)[None].expand(K, N_in)
    inv = torch.full((K * n_out + 1,), -1, dtype=torch.int64,
                     device=fwd.device)
    inv[dst.reshape(-1)] = src.reshape(-1)
    inv = inv[:-1]
    return inv.reshape(K, n_out)


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


def matmul_by_pair(x: torch.Tensor, w: torch.Tensor,
                   pairs: int = 1) -> torch.Tensor:
    """x (N, K) @ w (K, C) as `pairs` matmuls over equal row blocks: each
    block is the call a one-pair run makes (the same shapes), so its rows
    get that run's bits, where one matmul over all rows may take another
    cuBLAS kernel and round otherwise. The blocks' products are
    concatenated (autograd refuses products written in place)."""
    if pairs == 1:
        return x @ w
    return torch.cat([xb @ w for xb in x.chunk(pairs)])


def _per_tap(feats, weights, nbr_map, compute_dtype, pairs):
    """One of the two per-tap conv kernels (or their plain version on the
    CPU), picked by `choose_kernel` from one pair's shapes."""
    kernel, _ = choose_kernel(nbr_map.shape[1] // pairs, weights.shape[2],
                              weights.shape[0])
    conv = sparse_conv_rowtile if kernel == "rowtile" else sparse_conv_tapsplit
    return conv(feats.to(torch.float32).contiguous(), weights.contiguous(),
                nbr_map.contiguous(), compute_dtype)


class PerTapConv(torch.autograd.Function):
    """The per-tap conv with its backward: dX is the forward conv of dY
    over the inverted map (`invert_map_batch`; every map the port builds
    is injective per tap: an input row is one output row's neighbour at a
    given offset) with the weights transposed to (K, Cout, Cin), so it
    runs the same two kernels; dW is `sparse_conv_wgrad`. Both round their
    operands to compute_dtype and sum in fp32, as the forward does."""

    @staticmethod
    def forward(ctx, feats, weights, nbr_map, compute_dtype, pairs):
        ctx.save_for_backward(feats, weights, nbr_map)
        ctx.compute_dtype, ctx.pairs = compute_dtype, pairs
        return _per_tap(feats, weights, nbr_map, compute_dtype, pairs)

    @staticmethod
    def backward(ctx, g):
        feats, weights, nbr_map = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        cd, pairs = ctx.compute_dtype, ctx.pairs
        dx = dw = None
        if ctx.needs_input_grad[0]:
            n_in = feats.shape[0]
            ok = (nbr_map >= 0) & (nbr_map < n_in)
            inv = invert_map_batch(torch.where(ok, nbr_map, -1), n_in)
            dx = _per_tap(g, weights.transpose(1, 2), inv, cd, pairs)
        if ctx.needs_input_grad[1]:
            dw = sparse_conv_wgrad(feats.to(torch.float32).contiguous(), g,
                                   nbr_map.contiguous(), cd)
        return dx, dw, None, None, None


def sparse_conv(feats: torch.Tensor, weights: torch.Tensor,
                nbr_map: torch.Tensor, bias: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.float32,
                pairs: int = 1) -> torch.Tensor:
    """Sparse conv over a per-tap map. feats (N_in, Cin), invalid rows
    zero; weights (K_vol, Cin, Cout); nbr_map (K_vol, N_out) rows into
    feats, -1 absent; optional bias (Cout,). Returns (N_out, Cout) fp32.
    Operands are rounded to compute_dtype, products summed in fp32. A CUDA
    tensor goes to one of the two hand-written kernels, picked by
    `choose_kernel` from the shapes alone; a CPU tensor takes their plain
    per-tap loop. pairs=B: the rows are B pairs' levels, and the kernel is
    the one a pair's level alone takes (with bf16 operands a row's sums
    then do not depend on the batch; the fp32 FMA tile's tap segments do,
    in the last bits). Differentiable in feats and weights (`PerTapConv`:
    the backward kernels on the card, their plain versions on the CPU)."""
    out = PerTapConv.apply(feats, weights, nbr_map, compute_dtype, pairs)
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return out


def _window_table(f: torch.Tensor, gmap: GroupedMap):
    """(F3c, center): the centred window table of f (N_in + 3, 3 Cin),
    row r = [f[r - 2] | f[r - 1] | f[r]] zero-extended, and the map's
    centres into it, -1 (a zero row) for a window whose slots are all
    masked off (a "no candidate" centre: the all-zero last row N_in + 2,
    past the table where N_out > N_in, or a real row when N_out < N_in):
    it contributes nothing, and a gather of -1 adds no cotangent (a
    backward that adds rows sharing an index one after another would add
    them all into a single row)."""
    N_in, Cin = f.shape
    z = torch.zeros((1, Cin), dtype=f.dtype, device=f.device)
    F3c = torch.cat([torch.cat([z, z, f, z]), torch.cat([z, f, z, z]),
                     torch.cat([f, z, z, z])], dim=1)
    used = torch.any(gmap.masks, dim=1) | gmap.patho
    center = torch.where(used & (gmap.center < N_in + 2), gmap.center,
                         torch.full_like(gmap.center, -1))
    return F3c, center


def _group_windows(F3c: torch.Tensor, center: torch.Tensor, gmap: GroupedMap,
                   g: int) -> torch.Tensor:
    """x3 (N_out, 3 Cin): group g's windows [slot 0 | slot 1 | slot 2]
    with masked slots zero and a patho row's slot-1 row in slot 2 (the
    gather is gather_padded's: the gather_rows kernel on the card)."""
    N_out, Cin = center.shape[1], F3c.shape[1] // 3
    wide = gather_padded(F3c, center[g]).reshape(N_out, 3, Cin)
    masked = wide * gmap.masks[g].T[:, :, None].to(F3c.dtype)
    mid = masked[:, 2] + wide[:, 1] * gmap.patho[g][:, None].to(F3c.dtype)
    return torch.cat([masked[:, 0], masked[:, 1], mid], dim=1)


def sparse_conv_grouped_plain(feats: torch.Tensor, weights: torch.Tensor,
                              gmap: GroupedMap,
                              bias: Optional[torch.Tensor] = None,
                              compute_dtype: torch.dtype = torch.float32,
                              pairs: int = 1) -> torch.Tensor:
    """The plain version of the grouped k=3 conv: per group a window
    gather (`gather_padded`: the gather_rows kernel on the card) and the
    group's product. feats (N_in, Cin), invalid rows zero; weights (27,
    Cin, Cout); optional bias (Cout,). Returns (N_out, Cout) fp32.
    Operands are rounded to compute_dtype, products summed in fp32.
    pairs=B: the output rows are B equal blocks (pairs' levels), each
    block's products one matmul (`matmul_by_pair`). The CPU's path (in
    training differentiated by autograd) and the card's yardstick."""
    _, Cin, Cout = weights.shape
    G, _, N_out = gmap.masks.shape
    F3c, center = _window_table(round_to(feats, compute_dtype), gmap)
    w3 = round_to(weights, compute_dtype).reshape(G, 3, Cin, Cout)[
        :, gmap.worder]
    out = torch.zeros((N_out, Cout), dtype=torch.float32, device=F3c.device)
    for g in range(G):
        out = out + matmul_by_pair(_group_windows(F3c, center, gmap, g),
                                   w3[g].reshape(3 * Cin, Cout), pairs)
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return out


def sparse_conv_grouped_wgrad_plain(feats: torch.Tensor, dout: torch.Tensor,
                                    gmap: GroupedMap,
                                    compute_dtype: torch.dtype = torch.float32
                                    ) -> torch.Tensor:
    """The plain version of the grouped conv's weight gradient (the
    sparse_conv_grouped_wgrad kernel's arithmetic): groups in order, dW3[g]
    = x3_g^T @ dY, one fp32 product over operands rounded to
    compute_dtype (X as the forward rounds it, dY the backward's own
    rounding), then dW (27, Cin, Cout) in lexicographic tap order
    (dW[3 g + worder[s]] = dW3[g] slot s) rounded to compute_dtype and
    held in fp32."""
    Cin, Cout = feats.shape[1], dout.shape[1]
    G = gmap.masks.shape[0]
    F3c, center = _window_table(round_to(feats, compute_dtype), gmap)
    dy = round_to(dout, compute_dtype)
    dw3 = torch.stack([_group_windows(F3c, center, gmap, g).T @ dy
                       for g in range(G)]).reshape(G, 3, Cin, Cout)
    dw = torch.empty_like(dw3)
    dw[:, gmap.worder] = dw3
    return round_to(dw.reshape(3 * G, Cin, Cout), compute_dtype)


class GroupedConv(torch.autograd.Function):
    """The grouped k=3 conv on the card, forward and backward on
    hand-written kernels; it keeps only feats, weights and the maps (no
    window tensor). Forward: `sparse_conv_grouped_kernel`. Backward, with
    `adjoint` = (the adjoint map, reverse_taps) from the caller (the
    pyramid builds every map beside its adjoint; see
    models/resunet.build_unet_geometry): dX = dY's conv over the adjoint
    map with W[k]^T (W[26 - k]^T where reverse_taps: a self map is its
    own adjoint with its taps reversed) by the same kernel; dW by
    `sparse_conv_grouped_wgrad`; db = sum of dY over rows. dY enters the
    products rounded to compute_dtype (the one rounding the backward adds),
    products are summed in fp32, and dX and dW are rounded to
    compute_dtype and held in fp32, as autograd through the forward's
    rounding of its operands gives them. A backward that needs dX and was
    given no adjoint raises. On CPU tensors the kernels' plain versions
    run."""

    @staticmethod
    def forward(ctx, feats, weights, bias, gmap, adjoint, compute_dtype):
        ctx.save_for_backward(feats, weights)
        ctx.gmap, ctx.adjoint = gmap, adjoint
        ctx.compute_dtype = compute_dtype
        return sparse_conv_grouped_kernel(
            feats.to(torch.float32).contiguous(), weights.contiguous(), gmap,
            bias, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        feats, weights = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        cd = ctx.compute_dtype
        g = g.to(torch.float32).contiguous()
        dx = dw = db = None
        if need_x:
            if ctx.adjoint is None:
                raise ValueError(
                    "GroupedConv: the input's gradient needs the adjoint map "
                    "(adjoint=(GroupedMap, reverse_taps)); none was given")
            adj, reverse = ctx.adjoint
            dx = sparse_conv_grouped_dx(g, weights.contiguous(), adj,
                                        reverse, cd)
        if need_w:
            dw = sparse_conv_grouped_wgrad(
                feats.to(torch.float32).contiguous(), g, ctx.gmap, cd)
        if need_b:
            db = torch.sum(g, dim=0)
        return dx, dw, db, None, None, None


def sparse_conv_grouped(feats: torch.Tensor, weights: torch.Tensor,
                        gmap: GroupedMap,
                        bias: Optional[torch.Tensor] = None,
                        compute_dtype: torch.dtype = torch.float32,
                        pairs: int = 1,
                        adjoint: Optional[Tuple[GroupedMap, bool]] = None
                        ) -> torch.Tensor:
    """Sparse k=3 conv over a grouped-window map. feats (N_in, Cin),
    invalid rows zero; weights (27, Cin, Cout); optional bias (Cout,).
    Returns (N_out, Cout) fp32; operands rounded to compute_dtype,
    products summed in fp32. A CPU tensor takes the plain version
    (`sparse_conv_grouped_plain`, differentiated by autograd), a CUDA
    tensor the kernels through `GroupedConv` (differentiable in feats,
    weights and bias; the input's gradient needs `adjoint` = (the map's
    adjoint, whether its taps run reversed)), which sums a row's products
    in an order set by the row alone, so pairs=B (the output rows are B
    pairs' levels) gives each pair its one-pair bits on the card; on the
    CPU each pair-sized block is one matmul."""
    if feats.device.type == "cpu":
        return sparse_conv_grouped_plain(feats, weights, gmap, bias,
                                         compute_dtype, pairs)
    return GroupedConv.apply(feats, weights, bias, gmap, adjoint,
                             compute_dtype)


def _block_sums(x: torch.Tensor) -> torch.Tensor:
    """x (G, cap, C) -> (G, 1, C): each block's sum over its rows, one
    reduction a block: the call a one-block run makes, whatever the other
    blocks (one reduction over all blocks may split its sums by their
    count)."""
    return torch.stack([torch.sum(xb, dim=0, keepdim=True) for xb in x])


def cloud_order(cloud: torch.Tensor, valid: torch.Tensor, n_clouds: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, n_valid): src (N,) int64, a permutation of the rows that lays
    them out as n_clouds equal blocks of cap = N / n_clouds slots, block c
    first cloud c's valid rows in row order, then rows that are not valid
    (those fill the blocks' remaining slots in row order); n_valid
    (n_clouds,) the valid rows of each block. A cloud's rows need not sit
    in its block of the level: the pyramid's levels keep one valid
    prefix. A cloud with more than cap valid rows raises (an index out of
    range)."""
    N, G = valid.shape[0], int(n_clouds)
    if N % G:
        raise ValueError(f"{N} rows do not split into {G} equal blocks")
    cap, dev = N // G, cloud.device
    rank = torch.cumsum(((cloud[None, :] == torch.arange(G, device=dev)[
        :, None]) & valid[None, :]).to(torch.int64), 1) - 1
    c = torch.where(valid, cloud, torch.zeros_like(cloud))
    r = torch.gather(rank, 0, c[None]).squeeze(0)
    rows = torch.arange(N, device=dev)
    table = torch.full((G + 1, cap), -1, dtype=torch.int64, device=dev)
    table[torch.where(valid, c, G), torch.where(valid, r, 0)] = rows
    src = table[:G].reshape(-1)  # invalid rows went to the spare block G
    free = src < 0
    # the k-th free slot takes the k-th row that is not valid
    by_rank = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    by_rank[torch.where(valid, N, torch.cumsum(~valid, 0) - 1)] = rows
    src = torch.where(free, by_rank[torch.cumsum(free, 0) - 1], src)
    return src, rank[:, -1] + 1


def masked_batch_norm(feats: torch.Tensor, mask: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor,
                      running_mean: torch.Tensor, running_var: torch.Tensor,
                      train: bool = False, momentum: float = 0.1,
                      eps: float = 1e-5, cloud: Optional[torch.Tensor] = None,
                      n_clouds: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm over valid rows only; invalid rows re-zeroed (in training
    also rows whose cloud lies outside [0, n_clouds)). Returns (out,
    new_mean, new_var).

    Eval: the running statistics normalize, and come back unchanged.
    Train (torch / MinkowskiEngine semantics, as the JAX package): each
    cloud's valid rows take their own statistics (cloud (N,) int64 in [0,
    n_clouds) on valid rows; None: one cloud), the biased variance
    normalizes, and each cloud's running estimate new = (1 - momentum) old
    + momentum batch (unbiased variance) is averaged over the clouds, as
    the JAX trainer averages the per-cloud states of its vmapped forwards.
    The buffers are not written: the caller commits the returned state.
    The rows split into n_clouds equal blocks, and a cloud holds at most
    a block's rows (a pyramid of build_unet_geometry(pairs=n_clouds)).
    Each cloud's valid rows are laid out in row order in a block of their
    own (`cloud_order`, a permutation, so the backward of each gather adds
    one value a row), its sums are one reduction over that block, as a
    one-cloud run takes them, and the block is normalized where it lies:
    a cloud's statistics and output do not depend on where its rows sit
    or on the other clouds (no atomics)."""
    if train:
        N, C = feats.shape
        G = int(n_clouds)
        if cloud is None:
            cloud = torch.zeros(N, dtype=torch.int64, device=feats.device)
        src, n_valid = cloud_order(cloud, mask & (cloud >= 0) & (cloud < G),
                                   G)
        cap = N // G
        x = feats.index_select(0, src).reshape(G, cap, C)
        v = (torch.arange(cap, device=feats.device)[None, :]
             < n_valid[:, None]).to(torch.float32)[..., None]
        n = torch.clamp(n_valid.to(torch.float32), min=1.0)[:, None, None]
        mean = _block_sums(x * v) / n  # (G, 1, C)
        diff = (x - mean) * v
        var = _block_sums(diff * diff) / n
        unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
        new_mean = torch.mean((1.0 - momentum) * running_mean[None]
                              + momentum * mean[:, 0], dim=0)
        new_var = torch.mean((1.0 - momentum) * running_var[None]
                             + momentum * unbiased[:, 0], dim=0)
        out = ((x - mean) * (torch.rsqrt(var + eps) * scale) + bias) * v
        dst = torch.empty_like(src)
        dst[src] = torch.arange(N, device=feats.device)
        return out.reshape(N, C).index_select(0, dst), new_mean, new_var
    m = mask.to(torch.float32)[:, None]
    inv = torch.rsqrt(running_var[None, :] + eps)
    out = (feats - running_mean[None, :]) * (inv * scale) + bias[None, :]
    return out * m, running_mean, running_var
