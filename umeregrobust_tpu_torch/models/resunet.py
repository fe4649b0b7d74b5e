"""The sparse ResUNet "coloring" backbone family (port of
umeregrobust_tpu/models/resunet.py): ResUNet, ResUNet2..5 (6 levels) and
ResUNetSmall, ResUNetSmall2 (5 levels), in eval mode and, for training,
with batch statistics and gradients (`forward(..., train=True)`).

Architecture: encoder level i = conv (k_i, stride s_i) -> BN -> residual
block -> skip -> relu; decoder level = transposed conv -> BN -> block ->
relu -> cat(skip); head = 1x1 mlp -> relu -> 1x1 final (+bias) -> row
L2 normalisation. The geometry (coordinate pyramid + kernel maps) is built
once per forward input by `build_unet_geometry`: all-k3 archs take the
rank-join fast path, the others the generic exact-match join. k=3 layers
run the grouped-window conv (`ops.sparse.sparse_conv_grouped`, the CUDA
kernels of ops/cuda_grouped.py on the card; each conv is handed the
adjoint of its map, over which its backward's dX runs), k5/k7 layers and
`conv_impl="scan"` the per-tap conv (`ops.sparse.sparse_conv`, the CUDA
kernels of ops/cuda_conv.py on the card).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from umeregrobust_tpu_torch.devices import resolve_device
from umeregrobust_tpu_torch.utils.profiling import host_read
from umeregrobust_tpu_torch.ops.cuda_grouped import with_row_orders
from umeregrobust_tpu_torch.ops.sortmaps import (
    KEY_SENTINEL, QUERY_SENTINEL, pack_code, sorted_join_rank)
from umeregrobust_tpu_torch.ops.sparse import (
    WINDOW_PAD, GroupedMap, Level, build_level_maps, code_window_table,
    downsample_coords, group_kernel_map, interface_candidates,
    invert_map_batch, kernel_offsets, masked_batch_norm, matmul_by_pair,
    round_to, sort_level, sparse_conv, sparse_conv_grouped,
    ungroup_kernel_map, window_probe)

__all__ = ["ArchSpec", "ARCHS", "CONV_IMPLS", "default_level_capacities",
           "build_unet_geometry", "ResUNet", "init_resunet"]

CONV_IMPLS = ("grouped", "scan")


class ArchSpec(NamedTuple):
    channels: Tuple[int, ...]
    tr_channels: Tuple[int, ...]
    kernel_sizes: Tuple[int, ...]
    strides: Tuple[int, ...]
    block: str  # 'BN' (2-conv residual) or 'BN2' (1-conv residual)


ARCHS: Dict[str, ArchSpec] = {
    "ResUNet": ArchSpec((32, 64, 128, 256, 512, 1024),
                        (128, 128, 256, 256, 512, 512),
                        (7, 5, 5, 5, 5, 5), (1, 4, 2, 2, 2, 3), "BN"),
    "ResUNet2": ArchSpec((32, 64, 128, 256, 512, 1024),
                         (128, 128, 256, 256, 512, 512),
                         (5, 5, 5, 5, 5, 5), (1, 2, 2, 2, 2, 3), "BN"),
    "ResUNet3": ArchSpec((32, 64, 64, 128, 256, 512),
                         (64, 64, 128, 128, 256, 256),
                         (5, 5, 5, 5, 5, 5), (1, 2, 2, 2, 2, 3), "BN"),
    "ResUNet4": ArchSpec((32, 64, 64, 128, 256, 512),
                         (64, 64, 64, 128, 256, 256),
                         (3, 3, 3, 5, 5, 5), (1, 2, 2, 2, 2, 3), "BN"),
    "ResUNet5": ArchSpec((32, 64, 64, 128, 256, 512),
                         (64, 64, 64, 128, 128, 256),
                         (3, 3, 3, 5, 5, 5), (1, 2, 2, 2, 2, 3), "BN2"),
    "ResUNetSmall": ArchSpec((32, 64, 128, 256, 512),
                             (128, 128, 256, 256, 512),
                             (3, 3, 3, 3, 3), (1, 2, 2, 2, 3), "BN"),
    "ResUNetSmall2": ArchSpec((32, 64, 64, 128, 256), (64, 64, 64, 128, 128),
                              (3, 3, 3, 3, 3), (1, 2, 2, 2, 3), "BN2"),
}


def default_level_capacities(n0: int, arch: ArchSpec) -> Tuple[int, ...]:
    """Static per-level voxel capacities: a stride-s downsample of a lidar
    cloud (a surface) shrinks counts by about s^2; budget s^1.5 and round
    up to a multiple of 128."""
    caps = [n0]
    n = float(n0)
    for s in arch.strides[1:]:
        n = n / (s ** 1.5)
        caps.append(int(-(-int(n + 1) // 128) * 128))
    return tuple(caps)

_GROUPS8 = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            if (dx, dy) != (0, 0)]


def _tensor_strides(arch: ArchSpec) -> List[int]:
    ts = [1]
    for s in arch.strides[1:]:
        ts.append(ts[-1] * s)
    return ts


def _geometry_fast(levels: List[Level], arch: ArchSpec, ts: List[int]):
    """Rank-join geometry: one rank query per (dx, dy) z-column against
    each level's sorted codes; the <= 3 candidates of a column are
    consecutive key rows, resolved by one window probe."""
    L = len(levels)
    enc_maps: List[Any] = [None] * L
    block_maps: List[Any] = [None] * L
    dec_maps: List[Any] = [None] * (L - 1)
    enc_g: List[Any] = [None] * L
    block_g: List[Any] = [None] * L
    dec_g: List[Any] = [None] * (L - 1)
    for lv in range(L):
        level = levels[lv]
        t = ts[lv]
        N = level.coords.shape[0]
        dev = level.coords.device
        key_code = pack_code(level.coords, level.mask, KEY_SENTINEL)
        wtab = code_window_table(key_code)
        offs = torch.tensor([[0, dx * t, dy * t, 0] for dx, dy in _GROUPS8],
                            dtype=torch.int64, device=dev)
        host_read("resunet.geometry", device=dev)  # a copy to the card
        q_self = pack_code(level.coords.to(torch.int64)[None] + offs[:, None],
                           level.mask[None].expand(8, N), QUERY_SENTINEL)
        parts = [q_self.reshape(-1)]
        iface = None
        if lv > 0:
            s = arch.strides[lv]
            fine = levels[lv - 1]
            tf = ts[lv - 1]
            st = s * tf
            Nf = fine.coords.shape[0]
            a_sp = fine.coords[:, 1:].to(torch.int64)
            mres = torch.remainder(a_sp, st)
            dmin = mres - st * torch.div(mres + tf, st, rounding_mode="floor")
            k1d = torch.div(dmin, tf, rounding_mode="floor") + 1
            J = 2 if s == 2 else 1
            lane0_ok = dmin <= tf
            lane1_ok = dmin == -tf
            qi = []
            for jx in range(J):
                for jy in range(J):
                    sh = torch.tensor([jx * st, jy * st, 0], dtype=torch.int64,
                                      device=dev)
                    host_read("resunet.geometry", device=dev)
                    b_sp = a_sp - dmin - sh[None]
                    okx = lane0_ok[:, 0] if jx == 0 else lane1_ok[:, 0]
                    oky = lane0_ok[:, 1] if jy == 0 else lane1_ok[:, 1]
                    gm = fine.mask & okx & oky & lane0_ok[:, 2]
                    qi.append(pack_code(
                        torch.cat([fine.coords[:, :1].to(torch.int64), b_sp],
                                  -1), gm, QUERY_SENTINEL))
            q_if = torch.stack(qi)
            parts.append(q_if.reshape(-1))
            iface = (s, st, Nf, k1d, lane1_ok, q_if, J)

        ranks = sorted_join_rank(key_code, torch.cat(parts))
        r_self = ranks[: 8 * N].reshape(8, N)

        # self map, grouped form straight from the ranks
        v0, v1, v2 = window_probe(r_self, q_self, wtab, t)
        center8 = r_self + (v0 & ~v1).to(torch.int64)
        center8 = torch.where(v0 | v1 | v2, center8,
                              torch.full_like(center8, N + 1))
        masks8 = torch.stack([v0, v1, v2 & (v1 | ~v0)], dim=1)
        patho8 = v0 & ~v1 & v2
        # column (0, 0): own row is the centre tap; z-neighbours are the
        # sorted neighbours (unique coords on the t-lattice)
        pad = torch.full((1,), WINDOW_PAD, dtype=key_code.dtype, device=dev)
        kprev = torch.cat([pad, key_code[:-1]])
        knext = torch.cat([key_code[1:], pad])
        zf = key_code & 511
        c0v0 = (kprev == key_code - t) & (zf >= t) & level.mask
        c0v2 = (knext == key_code + t) & (zf < 512 - t) & level.mask
        rows = torch.arange(N, device=dev)
        c0center = torch.where(level.mask, rows, torch.full_like(rows, N + 1))
        c0masks = torch.stack([c0v0, level.mask, c0v2])
        center = torch.cat([center8[:4], c0center[None], center8[4:]])
        masks = torch.cat([masks8[:4], c0masks[None], masks8[4:]])
        patho = torch.cat([patho8[:4], torch.zeros((1, N), dtype=torch.bool,
                                                   device=dev), patho8[4:]])
        gmap = GroupedMap(center=center + 1, masks=masks, patho=patho,
                          worder=torch.tensor([0, 1, 2], device=dev))
        host_read("resunet.geometry", device=dev)
        block_g[lv] = gmap
        block_maps[lv] = ungroup_kernel_map(gmap)
        if lv == 0:
            enc_g[0] = gmap
            enc_maps[0] = block_maps[0]

        # interface: candidate rows from the ranks, then the adjoint pair
        # (the encoder gathers fine rows, the decoder coarse rows)
        if iface is not None:
            s, st, Nf, k1d, lane1_ok, q_if, J = iface
            r_if = ranks[8 * N:].reshape(J * J, Nf)
            iv0, iv1, _ = window_probe(r_if, q_if, wtab, st)
            if J == 2:
                vlo = iv0 & lane1_ok[None, :, 2]
                neg = torch.full_like(r_if, -1)
                brow_hi = torch.where(iv1, r_if, neg)
                brow_lo = torch.where(vlo, r_if - iv1.to(torch.int64), neg)
                brow = torch.stack([brow_hi, brow_lo], dim=1).reshape(8, Nf)
            else:
                brow = torch.where(iv1, r_if, torch.full_like(r_if, -1))
            kidx = torch.stack([
                (k1d[:, 0] + jx * s) * 9 + (k1d[:, 1] + jy * s) * 3
                + (k1d[:, 2] + jz * s)
                for jx in range(J) for jy in range(J) for jz in range(J)])
            a_rows = torch.arange(Nf, device=dev)[None].expand(brow.shape)
            hit = brow >= 0
            enc = torch.full((27 * N,), -1, dtype=torch.int64, device=dev)
            enc[(kidx * N + brow)[hit]] = a_rows[hit]
            host_read("resunet.geometry", 2)  # two boolean-mask selections
            enc_maps[lv] = enc.reshape(27, N)
            # decoder map is fine-indexed: lanes hit disjoint taps
            dec = torch.full((27, Nf), -1, dtype=torch.int64, device=dev)
            taps = torch.arange(27, device=dev)[:, None]
            for lane in range(brow.shape[0]):
                dec = torch.where((kidx[lane][None] == taps) & hit[lane][None],
                                  brow[lane][None], dec)
            dec_maps[L - 1 - lv] = dec
            enc_g[lv] = group_kernel_map(enc_maps[lv])
            dec_g[L - 1 - lv] = group_kernel_map(dec_maps[L - 1 - lv],
                                                 z_reversed=True)
    return enc_maps, block_maps, dec_maps, enc_g, block_g, dec_g


def _geometry_generic(levels: List[Level], arch: ArchSpec, ts: List[int]):
    """Exact-match-join geometry for archs with k5/k7 layers. Every lookup
    against a level joins that level's sorted codes once. Self maps look
    up only the first half of their centred offset set (the centre tap is
    the identity and map[K-1-k] is the scatter-inverse of map[k]); strided
    interfaces are resolved from the fine side, and one lookup yields both
    the encoder map and its adjoint decoder map. k=3 maps also get the
    grouped form; k5/k7 maps stay per-tap."""
    L = len(levels)

    def assemble_self_map(half, level):
        N = level.coords.shape[0]
        rows = torch.arange(N, device=half.device)
        center = torch.where(level.mask, rows, torch.full_like(rows, -1))[None]
        inv = invert_map_batch(half, N).flip(0)
        return torch.cat([half, center, inv], dim=0)

    enc_maps: List[Any] = [None] * L
    block_maps: List[Any] = [None] * L
    dec_maps: List[Any] = [None] * (L - 1)
    for lv in range(L):
        requests, tags = [], []
        if lv == 0:
            offs = kernel_offsets(arch.kernel_sizes[0], ts[0])
            requests.append((levels[0].coords, levels[0].mask,
                             offs[: len(offs) // 2], +1))
            tags.append("stem_half")
        if not (lv == 0 and arch.kernel_sizes[0] == 3):
            offs = kernel_offsets(3, ts[lv])
            requests.append((levels[lv].coords, levels[lv].mask,
                             offs[: len(offs) // 2], +1))
            tags.append("block_half")
        cand = None
        if lv > 0:
            cand = interface_candidates(
                levels[lv - 1], kernel=arch.kernel_sizes[lv], t=ts[lv - 1],
                stride=arch.strides[lv])
            requests.append((cand.coords, cand.valid, None, +1))
            tags.append("iface")
        for kind, res in zip(tags, build_level_maps(levels[lv], requests)):
            if kind == "stem_half":
                enc_maps[0] = assemble_self_map(res, levels[0])
            elif kind == "block_half":
                block_maps[lv] = assemble_self_map(res, levels[lv])
            else:
                K_vol = arch.kernel_sizes[lv] ** 3
                n_coarse = levels[lv].coords.shape[0]
                n_fine = levels[lv - 1].coords.shape[0]
                brow = res  # (J^3, N_fine) coarse rows, -1 absent
                dev = brow.device
                a_rows = torch.arange(n_fine, device=dev)[None].expand(
                    brow.shape)
                hit = brow >= 0
                # enc[k][coarse b] = fine a;  dec[k][fine a] = coarse b;
                # misses write a spare last slot (no host round trip)
                enc = torch.full((K_vol * n_coarse + 1,), -1,
                                 dtype=torch.int64, device=dev)
                enc[torch.where(hit, cand.kidx * n_coarse + brow,
                                K_vol * n_coarse).reshape(-1)] = \
                    a_rows.reshape(-1)
                enc_maps[lv] = enc[:-1].reshape(K_vol, n_coarse)
                dec = torch.full((K_vol * n_fine + 1,), -1,
                                 dtype=torch.int64, device=dev)
                dec[torch.where(hit, cand.kidx * n_fine + a_rows,
                                K_vol * n_fine).reshape(-1)] = brow.reshape(-1)
                dec_maps[L - 1 - lv] = dec[:-1].reshape(K_vol, n_fine)
    if arch.kernel_sizes[0] == 3:
        block_maps[0] = enc_maps[0]
    enc_g = [group_kernel_map(enc_maps[i]) if arch.kernel_sizes[i] == 3
             else enc_maps[i] for i in range(L)]
    block_g = [group_kernel_map(block_maps[i]) for i in range(L)]
    dec_g = [group_kernel_map(dec_maps[d], z_reversed=True)
             if arch.kernel_sizes[L - 1 - d] == 3 else dec_maps[d]
             for d in range(L - 1)]
    return enc_maps, block_maps, dec_maps, enc_g, block_g, dec_g


def build_unet_geometry(coords: torch.Tensor, mask: torch.Tensor,
                        arch: ArchSpec, capacities: Tuple[int, ...],
                        pairs: int = 1) -> Dict[str, Any]:
    """Coordinate pyramid and every kernel map of the UNet: dict with
    levels; enc_maps (per level, the encoder conv map into it; level 0:
    the stem's self map), block_maps (k=3 self maps) and dec_maps (per
    decoder step, the transposed conv map) as (K, N_out) int64 per-tap
    tables; enc_g / block_g / dec_g, the same maps in the form the default
    forward takes (GroupedMap for k=3 layers, the per-tap table for k5/k7
    layers); order0 / inv0 between the caller's row order and level 0's
    sorted order. Voxels beyond |x|, |y| < 512 or |z| < 256 fine units
    drop out of the neighbour maps (ops/sortmaps.pack_code). pairs=B > 1:
    the rows hold the 2B clouds of B pairs (batch index b of pair b // 2)
    and `capacities` hold per pair: each pair's levels keep the voxels its
    own pyramid keeps, and level i has B x capacities[i] rows. Every
    GroupedMap carries its row order (ops/cuda_grouped.with_row_orders:
    on the card one launch for all the maps, 13 for ResUNetSmall2)."""
    L = len(arch.channels)
    if len(capacities) != L:
        raise ValueError(f"{L} levels need {L} capacities, got "
                         f"{len(capacities)}")
    ts = _tensor_strides(arch)
    level0, order0, inv0 = sort_level(coords, mask)
    levels = [level0]
    for i in range(1, L):
        c, m = downsample_coords(levels[i - 1].coords, levels[i - 1].mask,
                                 out_stride=ts[i], capacity=int(capacities[i]),
                                 pairs=pairs)
        levels.append(Level(c, m))
    fast = (all(k == 3 for k in arch.kernel_sizes)
            and all(s in (2, 3) for s in arch.strides[1:]))
    enc_maps, block_maps, dec_maps, enc_g, block_g, dec_g = (
        _geometry_fast if fast else _geometry_generic)(levels, arch, ts)
    # each grouped map once (the stem's map is also level 0's block map)
    # with the row order the grouped conv kernel reads it in, all in one
    # call; a map's adjoint is another of these maps
    grouped = {id(m): m for maps in (enc_g, block_g, dec_g) for m in maps
               if isinstance(m, GroupedMap)}
    ordered = dict(zip(grouped, with_row_orders(list(grouped.values()))))
    enc_g, block_g, dec_g = ([ordered.get(id(m), m) for m in maps]
                             for maps in (enc_g, block_g, dec_g))
    return {"levels": levels, "enc_maps": enc_maps, "block_maps": block_maps,
            "dec_maps": dec_maps, "enc_g": enc_g, "block_g": block_g,
            "dec_g": dec_g, "order0": order0, "inv0": inv0, "pairs": pairs}


def _conv(feats: torch.Tensor, w: torch.Tensor, nbr,
          compute_dtype: torch.dtype, pairs: int = 1, adjoint=None
          ) -> torch.Tensor:
    """Dispatch on the map's form: GroupedMap -> grouped-window conv (with
    `adjoint` = (the map's adjoint, reverse_taps), which its backward on
    the card runs dX over), a plain (K, N_out) table -> per-tap conv.
    pairs=B: every call is made as for one pair's level (a pyramid of B
    pairs)."""
    if isinstance(nbr, GroupedMap):
        return sparse_conv_grouped(feats, w, nbr, compute_dtype=compute_dtype,
                                   pairs=pairs, adjoint=adjoint)
    return sparse_conv(feats, w, nbr, compute_dtype=compute_dtype,
                       pairs=pairs)


class _Conv(nn.Module):
    def __init__(self, k_vol: int, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(k_vol, cin, cout))


class _Dense(nn.Module):
    """1x1 head layer: w (cin, cout), optional bias b."""

    def __init__(self, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cin, cout))
        if bias:
            self.b = nn.Parameter(torch.zeros(cout))


class _BN(NamedTuple):
    """What a forward's BN layers need: train mode, the cloud of each row
    of every level (None in eval), the clouds' count, and the dict that
    collects each layer's new running state ("block1.norm1" -> (mean,
    var))."""

    train: bool
    clouds: Optional[List[torch.Tensor]]
    n_clouds: int
    new_state: Dict[str, Tuple[torch.Tensor, torch.Tensor]]


class _Norm(nn.Module):
    """Masked BatchNorm parameters (scale, bias) and running stats."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.key = ""  # the module's path, set by ResUNet

    def forward(self, x: torch.Tensor, mask: torch.Tensor, bn: _BN,
                level: int) -> torch.Tensor:
        out, nm, nv = masked_batch_norm(
            x, mask, self.scale, self.bias, self.mean, self.var,
            train=bn.train, cloud=bn.clouds[level] if bn.train else None,
            n_clouds=bn.n_clouds)
        bn.new_state[self.key] = (nm, nv)
        return out


class _Block(nn.Module):
    """Residual block. 'BN2': conv-BN-add-relu; 'BN': conv-BN-relu-conv-
    BN-add-relu."""

    def __init__(self, c: int, block: str):
        super().__init__()
        self.conv1 = _Conv(27, c, c)
        self.norm1 = _Norm(c)
        if block == "BN":
            self.conv2 = _Conv(27, c, c)
            self.norm2 = _Norm(c)

    def forward(self, x, mask, nbr, compute_dtype, pairs, bn, level):
        adj = (nbr, True)  # a self map: its own adjoint, taps reversed
        out = self.norm1(_conv(x, self.conv1.w, nbr, compute_dtype, pairs,
                               adj), mask, bn, level)
        if hasattr(self, "conv2"):
            out = self.norm2(_conv(torch.relu(out), self.conv2.w, nbr,
                                   compute_dtype, pairs, adj), mask, bn,
                             level)
        return torch.relu(out + x) * mask.to(torch.float32)[:, None]


class ResUNet(nn.Module):
    """The sparse ResUNet. Parameter names mirror the JAX package's pytree
    (`conv1.w`, `block1.norm1.scale`, `norm1_tr.mean`, ...), so
    `models.weights.params_from_jax` maps checkpoints one to one.
    conv_impl: 'grouped' (default: grouped-window conv on k=3 layers,
    per-tap conv on k5/k7 layers) or 'scan' (per-tap conv on every layer,
    the same function)."""

    def __init__(self, arch: ArchSpec, in_channels: int = 1,
                 out_channels: int = 32, conv_impl: str = "grouped"):
        super().__init__()
        if arch.block not in ("BN", "BN2"):
            raise ValueError(f"unknown residual block {arch.block!r}")
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got "
                             f"{conv_impl!r}")
        self.arch = arch
        self.conv_impl = conv_impl
        L = len(arch.channels)
        C, TR = arch.channels, arch.tr_channels
        prev = in_channels
        for i in range(L):
            setattr(self, f"conv{i+1}",
                    _Conv(arch.kernel_sizes[i] ** 3, prev, C[i]))
            setattr(self, f"norm{i+1}", _Norm(C[i]))
            setattr(self, f"block{i+1}", _Block(C[i], arch.block))
            prev = C[i]
        prev = C[L - 1]
        for d in range(L - 1):
            lvl = L - 2 - d
            cout = TR[L - 1 - d]
            setattr(self, f"conv{lvl+1}_tr",
                    _Conv(arch.kernel_sizes[L - 1 - d] ** 3, prev, cout))
            setattr(self, f"norm{lvl+1}_tr", _Norm(cout))
            setattr(self, f"block{lvl+1}_tr", _Block(cout, arch.block))
            prev = cout + C[lvl]
        self.mlp1 = _Dense(prev, TR[0])
        self.final = _Dense(TR[0], out_channels, bias=True)
        for name, mod in self.named_modules():
            if isinstance(mod, _Norm):
                mod.key = name

    def forward(self, geom: Dict[str, Any], in_feats: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                train: bool = False):
        """in_feats (N0, Cin), invalid rows zero -> (N0, out) fp32 unit-
        norm features in the caller's row order (zero on invalid rows).
        A geometry of B pairs (build_unet_geometry pairs=B) runs as one
        forward whose every dense product is made as for one pair's level,
        so each pair gets the features its own forward gives it.

        train=False: the eval forward, with no graph and running BN
        statistics. train=True: the graph is kept and each block of the
        pyramid (a pair of build_unet_geometry, the block of batch indices
        2b and 2b + 1) takes its own BN statistics; returns (features,
        new_bn_state), the state a dict of buffer name -> tensor (the
        average of the blocks' new running estimates) that the caller
        commits, or not (`load_bn_state`)."""
        if not train:
            with torch.no_grad():
                return self._forward(geom, in_feats, compute_dtype,
                                     _BN(False, None, 1, {}))
        pairs = geom.get("pairs", 1)
        clouds = [torch.div(lv.coords[:, 0].to(torch.int64), 2,
                            rounding_mode="floor") for lv in geom["levels"]]
        bn = _BN(True, clouds, pairs, {})
        out = self._forward(geom, in_feats, compute_dtype, bn)
        state = {}
        for key, (m, v) in bn.new_state.items():
            state[f"{key}.mean"] = m.detach()
            state[f"{key}.var"] = v.detach()
        return out, state

    @torch.no_grad()
    def load_bn_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Write running BN statistics (as forward(train=True) returns
        them) into the buffers."""
        bufs = dict(self.named_buffers())
        for k, v in state.items():
            bufs[k].copy_(v)

    def _forward(self, geom, in_feats, compute_dtype, bn: _BN):
        L = len(self.arch.channels)
        levels = geom["levels"]
        pairs = geom.get("pairs", 1)
        if self.conv_impl == "grouped":
            enc_m, block_m, dec_m = (geom["enc_g"], geom["block_g"],
                                     geom["dec_g"])
        else:
            enc_m, block_m, dec_m = (geom["enc_maps"], geom["block_maps"],
                                     geom["dec_maps"])
        # each conv's adjoint map (its backward's dX runs over it): the
        # stem's self map reversed, the encoder map into level i the
        # decoder map out of it, a decoder map the encoder map it undoes
        skips = []
        out = in_feats[geom["order0"]]
        for i in range(L):
            mask = levels[i].mask
            adj = (enc_m[0], True) if i == 0 else (dec_m[L - 1 - i], False)
            out = _conv(out, getattr(self, f"conv{i+1}").w, enc_m[i],
                        compute_dtype, pairs, adj)
            out = getattr(self, f"norm{i+1}")(out, mask, bn, i)
            out = getattr(self, f"block{i+1}")(out, mask, block_m[i],
                                               compute_dtype, pairs, bn, i)
            skips.append(out)
            out = torch.relu(out)
        for d in range(L - 1):
            lvl = L - 2 - d
            mask = levels[lvl].mask
            out = _conv(out, getattr(self, f"conv{lvl+1}_tr").w, dec_m[d],
                        compute_dtype, pairs, (enc_m[L - 1 - d], False))
            out = getattr(self, f"norm{lvl+1}_tr")(out, mask, bn, lvl)
            out = getattr(self, f"block{lvl+1}_tr")(out, mask, block_m[lvl],
                                                    compute_dtype, pairs, bn,
                                                    lvl)
            out = torch.cat([torch.relu(out), skips[lvl]], dim=-1)
        mask0 = levels[0].mask.to(torch.float32)[:, None]
        out = matmul_by_pair(round_to(out, compute_dtype),
                             round_to(self.mlp1.w, compute_dtype), pairs)
        out = torch.relu(out)
        out = matmul_by_pair(round_to(out, compute_dtype),
                             round_to(self.final.w, compute_dtype), pairs)
        out = out + self.final.b[None, :]
        out = out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True)
                     + 1e-12)
        return (out * mask0)[geom["inv0"]]


def init_resunet(arch: ArchSpec, in_channels: int = 1, out_channels: int = 32,
                 generator: Optional[torch.Generator] = None,
                 conv_impl: str = "grouped", device="cuda") -> ResUNet:
    """A ResUNet in eval mode with fresh parameters on `device` (the card
    unless `device="cpu"`; raises without CUDA): He-normal conv and head
    weights (std = sqrt(2 / (k_vol * cin))) drawn from `generator` (on
    `device`; default: seed 0), unit scales, zero biases, running mean 0
    and variance 1."""
    device = resolve_device(device)
    with torch.device(device):
        model = ResUNet(arch, in_channels, out_channels, conv_impl)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".w"):
                fan_in = math.prod(p.shape[:-1])  # k_vol * cin
                p.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
    return model.eval()
