"""The sparse ResUNet "coloring" backbone (port of
umeregrobust_tpu/models/resunet.py, eval mode, all-k3 archs).

Architecture: encoder level i = conv (k3, stride s_i) -> BN -> residual
block -> skip -> relu; decoder level = transposed conv -> BN -> block ->
relu -> cat(skip); head = 1x1 mlp -> relu -> 1x1 final (+bias) -> row
L2 normalisation. The geometry (coordinate pyramid + grouped kernel maps)
is built once per forward input by `build_unet_geometry` with the rank-
join fast path of the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch import nn

from umeregrobust_tpu_torch.ops.sortmaps import (
    KEY_SENTINEL, QUERY_SENTINEL, pack_code, sorted_join_rank)
from umeregrobust_tpu_torch.ops.sparse import (
    WINDOW_PAD, GroupedMap, Level, code_window_table, downsample_coords,
    group_kernel_map, masked_batch_norm, round_to, sort_level,
    sparse_conv_grouped, ungroup_kernel_map, window_probe)

__all__ = ["ArchSpec", "ARCHS", "build_unet_geometry", "ResUNet"]


class ArchSpec(NamedTuple):
    channels: Tuple[int, ...]
    tr_channels: Tuple[int, ...]
    kernel_sizes: Tuple[int, ...]
    strides: Tuple[int, ...]
    block: str  # residual block: 'BN2' (conv-BN-add-relu) is ported


ARCHS: Dict[str, ArchSpec] = {
    "ResUNetSmall2": ArchSpec((32, 64, 64, 128, 256), (64, 64, 64, 128, 128),
                              (3, 3, 3, 3, 3), (1, 2, 2, 2, 3), "BN2"),
}

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


def build_unet_geometry(coords: torch.Tensor, mask: torch.Tensor,
                        arch: ArchSpec, capacities: Tuple[int, ...]
                        ) -> Dict[str, Any]:
    """Coordinate pyramid and every kernel map of the UNet (dict with
    levels, enc/block/dec maps in per-tap and grouped form, order0/inv0
    between the caller's row order and level 0's sorted order)."""
    if not (all(k == 3 for k in arch.kernel_sizes)
            and all(s in (2, 3) for s in arch.strides[1:])):
        raise NotImplementedError(
            "only all-k3 archs with strides 2/3 (the rank-join geometry)")
    L = len(arch.channels)
    ts = _tensor_strides(arch)
    level0, order0, inv0 = sort_level(coords, mask)
    levels = [level0]
    for i in range(1, L):
        c, m = downsample_coords(levels[i - 1].coords, levels[i - 1].mask,
                                 out_stride=ts[i], capacity=int(capacities[i]))
        levels.append(Level(c, m))
    enc_maps, block_maps, dec_maps, enc_g, block_g, dec_g = _geometry_fast(
        levels, arch, ts)
    return {"levels": levels, "enc_maps": enc_maps, "block_maps": block_maps,
            "dec_maps": dec_maps, "enc_g": enc_g, "block_g": block_g,
            "dec_g": dec_g, "order0": order0, "inv0": inv0}


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


class _Norm(nn.Module):
    """Masked BatchNorm parameters (scale, bias) and running stats."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return masked_batch_norm(x, mask, self.scale, self.bias, self.mean,
                                 self.var)


class _Block(nn.Module):
    """Residual block 'BN2': conv-BN-add-relu."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = _Conv(27, c, c)
        self.norm1 = _Norm(c)

    def forward(self, x, mask, gmap, compute_dtype):
        out = self.norm1(sparse_conv_grouped(x, self.conv1.w, gmap,
                                             compute_dtype), mask)
        return torch.relu(out + x) * mask.to(torch.float32)[:, None]


class ResUNet(nn.Module):
    """The sparse ResUNet in eval mode. Parameter names mirror the JAX
    package's pytree (`conv1.w`, `block1.norm1.scale`, `norm1_tr.mean`,
    ...), so `models.weights.params_from_jax` maps checkpoints one to
    one."""

    def __init__(self, arch: ArchSpec, in_channels: int = 1,
                 out_channels: int = 32):
        super().__init__()
        if arch.block != "BN2":
            raise NotImplementedError(f"block {arch.block!r} is not ported")
        self.arch = arch
        L = len(arch.channels)
        C, TR = arch.channels, arch.tr_channels
        prev = in_channels
        for i in range(L):
            setattr(self, f"conv{i+1}", _Conv(27, prev, C[i]))
            setattr(self, f"norm{i+1}", _Norm(C[i]))
            setattr(self, f"block{i+1}", _Block(C[i]))
            prev = C[i]
        prev = C[L - 1]
        for d in range(L - 1):
            lvl = L - 2 - d
            cout = TR[L - 1 - d]
            setattr(self, f"conv{lvl+1}_tr", _Conv(27, prev, cout))
            setattr(self, f"norm{lvl+1}_tr", _Norm(cout))
            setattr(self, f"block{lvl+1}_tr", _Block(cout))
            prev = cout + C[lvl]
        self.mlp1 = _Dense(prev, TR[0])
        self.final = _Dense(TR[0], out_channels, bias=True)

    @torch.no_grad()
    def forward(self, geom: Dict[str, Any], in_feats: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """in_feats (N0, Cin), invalid rows zero -> (N0, out) fp32 unit-
        norm features in the caller's row order (zero on invalid rows)."""
        L = len(self.arch.channels)
        levels = geom["levels"]
        enc_m, block_m, dec_m = geom["enc_g"], geom["block_g"], geom["dec_g"]
        skips = []
        out = in_feats[geom["order0"]]
        for i in range(L):
            mask = levels[i].mask
            out = sparse_conv_grouped(out, getattr(self, f"conv{i+1}").w,
                                      enc_m[i], compute_dtype)
            out = getattr(self, f"norm{i+1}")(out, mask)
            out = getattr(self, f"block{i+1}")(out, mask, block_m[i],
                                               compute_dtype)
            skips.append(out)
            out = torch.relu(out)
        for d in range(L - 1):
            lvl = L - 2 - d
            mask = levels[lvl].mask
            out = sparse_conv_grouped(out, getattr(self, f"conv{lvl+1}_tr").w,
                                      dec_m[d], compute_dtype)
            out = getattr(self, f"norm{lvl+1}_tr")(out, mask)
            out = getattr(self, f"block{lvl+1}_tr")(out, mask, block_m[lvl],
                                                    compute_dtype)
            out = torch.cat([torch.relu(out), skips[lvl]], dim=-1)
        mask0 = levels[0].mask.to(torch.float32)[:, None]
        out = round_to(out, compute_dtype) @ round_to(self.mlp1.w,
                                                      compute_dtype)
        out = torch.relu(out)
        out = round_to(out, compute_dtype) @ round_to(self.final.w,
                                                      compute_dtype)
        out = out + self.final.b[None, :]
        out = out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True)
                     + 1e-12)
        return (out * mask0)[geom["inv0"]]
