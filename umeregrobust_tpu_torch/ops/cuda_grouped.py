"""Grouped-window k=3 sparse convolution: the wrapper of the CUDA kernel in
csrc/sparse_conv_grouped.cu (which takes the window gathers of
tools/exp_gather2.py `pg` and the per-group products of
ops/sparse.sparse_conv_grouped, the port of
umeregrobust_tpu/ops/sparse.py:sparse_conv_grouped, into one launch a
layer), the row order it reads a map through (csrc/grouped_row_order.cu),
its cached bf16 weight tiles, and the plan it runs by.

    out[i] = bias + sum_g [f[c-1] | f[c] | f[c+1] or f[c] (patho)] @ w3[g]

with each slot a zero row where its mask is off or its row lies outside
[0, N_in) (ops/sparse.GroupedMap). bf16 operands: the map's rows in the
order of their used-group masks (`grouped_row_orders`: the pyramid
builds every map's in one launch, this wrapper a map's own where it has
none), 64-row tiles that
stage and multiply only the groups their mask names, the groups split
over a cluster of 1-4 CTAs fixed by Cin, each CTA one warpgroup on
wgmma with a producer warp staging windows by cp.async and weight tiles
by TMA bulk copies; the weights tiled to bf16 once a parameter version
(`weight_tiles`: cached on the tensor's storage and version counter, so
an in-place update such as the optimizer's makes a new copy) and the
features rounded by one small launch a call. fp32 operands: an FMA tile
in code order. On a CPU tensor the wrapper runs the plain version
(ops/sparse.sparse_conv_grouped_plain); on a CUDA tensor it launches the
kernel or raises.

The backward (ops/sparse.GroupedConv) runs on two kernels: the input's
gradient is this kernel on dY over the adjoint map
(`sparse_conv_grouped_dx`: each tap's weights transposed, for a self map
the taps reversed, read so by its own cached weight tiles); the weights'
gradient is `sparse_conv_grouped_wgrad`
(csrc/sparse_conv_grouped_wgrad.cu: dW3[g] = sum_o x3_g[o]^T dY[o] on
wgmma, group g walking only the 64-row tiles of the map's order whose
mask names it, dY unrounded as hi + lo bf16 parts, the units cut into
runs fixed by the shapes and the runs' partials summed in order by a
second launch; Cin <= 2 a packed stem; `wgrad_plan` mirrors it).
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import torch

from umeregrobust_tpu_torch.ops import _build

__all__ = ["sparse_conv_grouped_kernel", "sparse_conv_grouped_dx",
           "sparse_conv_grouped_wgrad", "grouped_row_order",
           "grouped_row_order_plain", "grouped_row_orders",
           "grouped_row_orders_plain", "row_keys_plain", "tiles_of_order",
           "with_row_order", "with_row_orders", "weight_tiles",
           "weight_tiles_plain", "clear_weight_tiles",
           "grouped_plan", "GroupedPlan", "wgrad_plan", "WgradPlan",
           "wgrad_units_plain",
           "LAUNCHES", "WEIGHT_TILE_BUILDS"]

# kernel launches by each wrapper (not by the plain versions)
LAUNCHES = {"sparse_conv_grouped": 0, "sparse_conv_grouped_wgrad": 0,
            "grouped_row_order": 0}
# launches that made bf16 weight tiles (cache misses), by dx_taps
WEIGHT_TILE_BUILDS = {0: 0, 1: 0, 2: 0}

_GROUPS = 9
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's tiles (csrc kBM, kKC, kStages, kMaxCluster; the channel
# tile is the least of 32, 64 and 128 that holds round8(Cout), 128 past
# it; kFM, kFN, kFK) and the cluster rule: a tile's work, 9 k_steps
# ceil(Cout / 64) steps of 64 x 64 x 64, split over about one CTA a
# _STEPS_PER_CTA of it
_MMA_ROWS, _MMA_K, _MMA_STAGES = 64, 64, 4
_MAX_CLUSTER, _STEPS_PER_CTA = 4, 128
_FMA_ROWS, _FMA_COLS, _FMA_K = 64, 64, 16
# the row order's kernel (grouped_row_order.cu kTileRows, kKeys,
# kMaxMaps, kMaxCluster, kMaxRows) and the cluster size it runs with (16
# was the fastest of 4, 8 and 16 at every pyramid on the H100:
# grouped_sweep.py --order)
_ORDER_TILE, _ORDER_KEYS, _ORDER_MAX_MAPS = 64, 512, 16
_ORDER_MAX_CLUSTER, _ORDER_MAX_ROWS = 16, 2 ** 31 - 1024
_ORDER_CLUSTER = 16
# the weight gradient's fp32 FMA tiles (csrc kWM, kWN, kWR, kWSteps) and
# its bf16 plan (kUnitRows, kAtom, kMaxAtoms1 / 2, kMaxStages, kStemCin,
# kStemCtas, kListChunk, kYPad, kSumThreads, kMaxSmem)
_WG_ROWS, _WG_COLS, _WG_STEP, _WG_STEPS = 64, 64, 32, 256
_WG_UNIT, _WG_ATOM, _WG_ATOMS, _WG_STAGES = 64, 64, (3, 2), 4
_WG_STEM_CIN, _WG_STEM_CTAS, _WG_LIST, _WG_YPAD = 2, 2, 512, 4
_WG_SUM_THREADS, _MAX_SMEM = 1 << 20, 232448
_SM_COUNT = 132  # H100 SXM
# weight tiles kept at most (each holds its weight tensor, so no other
# tensor takes its address while the entry lives)
_TILE_CACHE_SIZE = 64


def _round8(x: int) -> int:
    return -(-x // 8) * 8


class GroupedPlan(NamedTuple):
    """How the kernel runs a shape. kind "mma" (bf16 operands) or "fma"
    (fp32); tile rows x cols of output a CTA (mma: 64 rows of the map's
    order x 32, 64 or 128 channels); k_chunk K entries a step and k_steps
    steps a group (over 3 round8(Cin) with bf16, 3 Cin with fp32); cluster
    the CTAs a tile's groups are split over (fixed by Cin and Cout: a
    tile's work over _STEPS_PER_CTA; 1 for fp32); grid (tiles x cluster,
    channel tiles); smem_bytes of shared memory a CTA (dynamic for mma:
    the stages, the barriers and 1 KB to align; static for fma); xb_elems
    / wt_elems the bf16 feature copy's and the weight tiles' sizes (0 for
    fp32); split: the input rows enter as two bf16 parts, hi and lo (a
    dX: dY is not rounded; twice the A stages and xb)."""

    kind: str
    tile_rows: int
    tile_cols: int
    k_chunk: int
    k_steps: int
    cluster: int
    grid: tuple
    smem_bytes: int
    xb_elems: int
    wt_elems: int
    split: bool = False


class WgradPlan(NamedTuple):
    """How the weight-gradient kernel runs a shape. kind "mma" (bf16
    operands), "stem" (bf16, Cin <= 2: the 27 taps packed into one
    64-column atom, rows in code order) or "fma" (fp32). bf16:
    warpgroups (1 or 2 consumer warpgroups of 64 output channels a CTA),
    atoms (64-column blocks of window columns a CTA), col_blocks /
    cout_blocks (CTAs over the 3 round8(Cin) window columns / the
    channels), ranges (runs the units are cut into, fixed by the shapes:
    about one CTA an SM; the stem: two), stages (the ring), smem_bytes (a
    CTA's dynamic shared memory), part_elems (the partials: a slot a run
    and group it touches, cout_blocks warpgroups 64 x col_blocks atoms 64
    each), xb_cols (the bf16 feature copy's row; 0 for the stem and
    fp32), code_elems (int32: 16 counts, the 9 groups' tile lists, the
    window codes of every (group, row); 0 for the stem and fp32),
    sum_lanes (threads an output of the sum launch). fp32: split_rows
    output rows a split (a multiple of 32), splits, grid (splits, 64 x 64
    tiles of the (3 round8(Cin), round8(Cout)) product, 9 groups) and its
    partials; the bf16 fields 0."""

    kind: str
    grid: tuple
    part_elems: int
    warpgroups: int = 0
    atoms: int = 0
    col_blocks: int = 0
    cout_blocks: int = 0
    ranges: int = 0
    stages: int = 0
    smem_bytes: int = 0
    xb_cols: int = 0
    code_elems: int = 0
    sum_lanes: int = 0
    split_rows: int = 0
    splits: int = 0


def _tile_cols(cout: int) -> int:
    c8 = _round8(cout)
    return 32 if c8 <= 32 else 64 if c8 <= 64 else 128


def grouped_plan(n_in: int, n_out: int, cin: int, cout: int,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 split: bool = False) -> GroupedPlan:
    """The kernel's plan from the shapes alone (no host read); split: a
    dX's (its input dY in hi and lo bf16 parts)."""
    if compute_dtype == torch.float32:
        k3 = 3 * cin
        return GroupedPlan(
            "fma", _FMA_ROWS, _FMA_COLS, _FMA_K, -(-k3 // _FMA_K), 1,
            (-(-n_out // _FMA_ROWS), -(-cout // _FMA_COLS)),
            4 * (_FMA_K * (_FMA_ROWS + 4) + _FMA_K * _FMA_COLS
                 + 3 * _FMA_ROWS) + 4, 0, 0)
    cin8 = _round8(cin)
    cols = _tile_cols(cout)
    steps = -(-3 * cin8 // _MMA_K)
    cluster = min(_MAX_CLUSTER, max(1, -(-_GROUPS * steps * -(-cout // 64)
                                         // _STEPS_PER_CTA)))
    col_tiles = -(-cout // cols)
    parts = 2 if split else 1
    smem = 1024 + _MMA_STAGES * (2 * parts * _MMA_ROWS * _MMA_K
                                 + 2 * cols * _MMA_K + 16)
    return GroupedPlan("mma", _MMA_ROWS, cols, _MMA_K, steps, cluster,
                       (-(-n_out // _MMA_ROWS) * cluster, col_tiles), smem,
                       max(n_in, 1) * cin8 * parts,
                       _GROUPS * steps * col_tiles * cols * _MMA_K, split)


def wgrad_plan(n_out: int, cin: int, cout: int,
               compute_dtype: torch.dtype = torch.bfloat16) -> WgradPlan:
    """The weight-gradient kernel's plan from the shapes alone (no host
    read; csrc make_plan). bf16: a CTA takes 64 or 128 output channels
    (one or two consumer warpgroups, beside two producer warpgroups) and
    up to 3 (one consumer warpgroup) or 2 (two) atoms of 64 window
    columns, the fewest column blocks that hold 3 round8(Cin) columns;
    the units are cut into 132 / (column blocks x channel blocks) runs;
    the ring as deep as 227 KB allows (at most 4).
    The stem (Cin <= 2): one atom, runs of 64-row tiles in code order,
    two CTAs an SM. fp32: splits of output rows (steps of 32, at most 256
    a split), the fewest that give about two blocks an SM. The order of
    every sum, and so the bits, follow from the shapes and the map."""
    cin8, cout8 = _round8(cin), _round8(cout)
    k3 = 3 * cin8
    if compute_dtype == torch.float32:
        tiles = -(-k3 // _WG_ROWS) * -(-cout8 // _WG_COLS)
        steps = max(1, -(-n_out // _WG_STEP))
        want = -(-2 * _SM_COUNT // (_GROUPS * tiles))
        splits = max(-(-steps // _WG_STEPS), min(steps, want))
        per = -(-steps // splits)  # steps a split
        splits = -(-steps // per)
        return WgradPlan("fma", (splits, tiles, _GROUPS),
                         splits * _GROUPS * k3 * cout8,
                         split_rows=per * _WG_STEP, splits=splits)
    n_tiles = -(-n_out // _WG_UNIT)
    stem = cin <= _WG_STEM_CIN
    mw = 1 if cout8 <= _WG_ATOM else 2
    mblk = -(-cout8 // (_WG_ATOM * mw))
    ctas = 1
    if stem:
        nb = nblk = 1
        ctas = _WG_STEM_CTAS if mw == 1 else 1
        ranges = max(1, min(n_tiles, ctas * _SM_COUNT // mblk))
    else:
        atoms = -(-k3 // _WG_ATOM)
        nblk = -(-atoms // _WG_ATOMS[mw - 1])
        nb = -(-atoms // nblk)
        ranges = max(1, _SM_COUNT // (nblk * mblk))
    stage = -(-(nb * _WG_UNIT * _WG_ATOM * 2
                + _WG_UNIT * (mw * _WG_ATOM + _WG_YPAD) * 4) // 1024) * 1024
    room = _MAX_SMEM // ctas - 4 * _WG_LIST - 1024 - 16 * _WG_STAGES
    stages = min(_WG_STAGES, room // stage)
    slots = ranges if stem else ranges + _GROUPS - 1
    lanes = 32 if stem else 1
    while lanes > 1 and 27 * cin * cout * lanes > _WG_SUM_THREADS:
        lanes //= 2
    return WgradPlan(
        "stem" if stem else "mma", (ranges * nblk, mblk),
        slots * mblk * mw * _WG_ATOM * nblk * nb * _WG_ATOM, mw, nb, nblk,
        mblk, ranges, stages, 1024 + stages * stage + 16 * stages,
        0 if stem else cin8,
        0 if stem else (16 + -(-_GROUPS * n_tiles // 4) * 4
                        + _GROUPS * n_out),
        lanes)


def wgrad_units_plain(gmap) -> list:
    """The (group, tile) units the bf16 weight-gradient kernel stages, as
    its prep launch lists them, in plain PyTorch: lists[g] (int64) the
    64-row tiles of the map's order (`gmap.order`, or
    `grouped_row_order`'s where the map has none) whose mask has bit g,
    ascending. Group g's gradient sums over the rows of those tiles
    alone; a row of such a tile that does not use g adds a zero window."""
    _, tiles = ((gmap.order, gmap.tiles) if gmap.order is not None
                else grouped_row_order(gmap))
    t = tiles.to(torch.int64)
    return [torch.nonzero(torch.bitwise_and(t, 1 << g) != 0).reshape(-1)
            for g in range(_GROUPS)]


def _checked(feats, weights, gmap, bias, compute_dtype, transpose=False):
    """Validate the kernel's inputs (shapes and types first, then the
    library and the device); returns (lib, N_in, N_out, Cin, Cout) of the
    conv the launch runs (with `transpose`, a dX: Cin and Cout of the
    weights (27, Cin, Cout) swapped)."""
    dev = feats.device
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"sparse_conv_grouped: compute_dtype fp32 or bf16, "
                         f"got {compute_dtype}")
    if weights.dim() != 3 or weights.shape[0] != 3 * _GROUPS:
        raise ValueError(f"weights: expected (27, Cin, Cout), got "
                         f"{tuple(weights.shape)}")
    _, Cin, Cout = weights.shape
    if transpose:
        Cin, Cout = Cout, Cin
    _build.require(feats, "feats", torch.float32, (None, Cin), dev)
    _build.require(weights, "weights", torch.float32,
                   tuple(weights.shape), dev)
    N_out = _check_map(gmap, dev)
    _check_order(gmap, dev, N_out)
    if bias is not None:
        _build.require(bias, "bias", torch.float32, (Cout,), dev)
    N_in = feats.shape[0]
    if min(Cin, Cout) < 1 or max(N_in, N_out) >= 2 ** 31 - 128 \
            or 3 * _round8(Cin) >= 2 ** 31 - 32 or -(-Cout // 64) > 65535:
        raise ValueError(f"sparse_conv_grouped: unsupported shape Cin={Cin} "
                         f"Cout={Cout} N_in={N_in} N_out={N_out}")
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"sparse_conv_grouped runs on CUDA or CPU tensors, "
                         f"not {dev}")
    return lib, N_in, N_out, Cin, Cout


def _check_map(gmap, dev) -> int:
    """Validate a GroupedMap on `dev`; returns N_out."""
    if gmap.center.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"center: expected int32 or int64, got "
                         f"{gmap.center.dtype}")
    _build.require(gmap.center, "center", gmap.center.dtype, (_GROUPS, None),
                   dev)
    N_out = gmap.center.shape[1]
    _build.require(gmap.masks, "masks", torch.bool, (_GROUPS, 3, N_out), dev)
    _build.require(gmap.patho, "patho", torch.bool, (_GROUPS, N_out), dev)
    _build.require(gmap.worder, "worder", torch.int64, (3,), dev)
    return N_out


def _check_order(gmap, dev, N_out: int) -> None:
    """Validate a map's row order and tiles where it carries them."""
    if (gmap.order is None) != (gmap.tiles is None):
        raise ValueError("a GroupedMap carries both order and tiles, or "
                         "neither")
    if gmap.order is not None:
        _build.require(gmap.order, "order", torch.int32, (N_out,), dev)
        _build.require(gmap.tiles, "tiles", torch.int32,
                       (-(-N_out // _ORDER_TILE),), dev)


def row_keys_plain(gmap) -> torch.Tensor:
    """(N_out,) int64: each row's used-group mask, bit g set where window
    (g, row) has a slot that reads (a mask or patho bit)."""
    used = torch.any(gmap.masks, dim=1) | gmap.patho  # (9, N_out)
    bits = torch.bitwise_left_shift(
        torch.ones(_GROUPS, dtype=torch.int64, device=used.device),
        torch.arange(_GROUPS, device=used.device))
    return torch.sum(used.to(torch.int64) * bits[:, None], dim=0)


def tiles_of_order(gmap, order: torch.Tensor) -> torch.Tensor:
    """(ceil(N_out / 64),) int32: each 64-row tile of `order` (a
    permutation of the map's rows)'s groups, the OR of its rows' used-group
    masks (`row_keys_plain`), in plain PyTorch."""
    key = row_keys_plain(gmap)
    n, dev = key.shape[0], key.device
    n_tiles = -(-n // _ORDER_TILE)
    kt = torch.zeros(n_tiles * _ORDER_TILE, dtype=torch.int64, device=dev)
    kt[:n] = key[order.to(torch.int64)]
    kt = kt.reshape(n_tiles, _ORDER_TILE)
    tiles = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    for g in range(_GROUPS):
        tiles |= torch.any(torch.bitwise_and(kt, 1 << g) != 0,
                           dim=1).to(torch.int64) << g
    return tiles.to(torch.int32)


def grouped_row_order_plain(gmap) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `grouped_row_order`: (order (N_out,) int32,
    the rows sorted by their used-group mask (`row_keys_plain`), rows of
    one mask in ascending order; tiles (ceil(N_out / 64),) int32, each
    64-row tile of the order's OR of its rows' masks)."""
    order = torch.argsort(row_keys_plain(gmap), stable=True).to(torch.int32)
    return order, tiles_of_order(gmap, order)


def grouped_row_orders_plain(maps) -> List[Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """The plain version of `grouped_row_orders`: each map's
    `grouped_row_order_plain`, map by map."""
    return [grouped_row_order_plain(m) for m in maps]


def grouped_row_orders(maps) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The row orders of a list of grouped maps, one (order, tiles) a map
    as `grouped_row_order_plain` gives it. On CUDA maps ONE launch of
    csrc/grouped_row_order.cu for the whole list (a thread-block cluster
    of _ORDER_CLUSTER CTAs a map, the maps' descriptors in the kernel's
    parameters), counted once in LAUNCHES["grouped_row_order"]; every
    order is a view into one int32 buffer and every tiles into another.
    At most _ORDER_MAX_MAPS maps a call on any device (every arch's
    pyramid fits): more raise. A map given twice gets its result twice.
    CPU maps take the plain version and count nothing."""
    maps = list(maps)
    if len(maps) > _ORDER_MAX_MAPS:
        raise ValueError(f"grouped_row_orders takes at most "
                         f"{_ORDER_MAX_MAPS} maps a call, got {len(maps)}")
    if not maps:
        return []
    dev = maps[0].masks.device
    if dev.type == "cpu":
        return grouped_row_orders_plain(maps)
    ns = []
    for m in maps:
        N_out = m.masks.shape[-1]
        _build.require(m.masks, "masks", torch.bool, (_GROUPS, 3, N_out),
                       dev)
        _build.require(m.patho, "patho", torch.bool, (_GROUPS, N_out), dev)
        if N_out >= _ORDER_MAX_ROWS:
            raise ValueError(f"grouped_row_order: {N_out} rows")
        ns.append(N_out)
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"grouped_row_order runs on CUDA or CPU tensors, "
                         f"not {dev}")
    n_tiles = [-(-n // _ORDER_TILE) for n in ns]
    order = torch.empty(sum(ns), dtype=torch.int32, device=dev)
    tiles = torch.empty(sum(n_tiles), dtype=torch.int32, device=dev)
    out, o, t = [], 0, 0
    for n, nt in zip(ns, n_tiles):
        out.append((order[o:o + n], tiles[t:t + nt]))
        o, t = o + n, t + nt
    live = [(m, n) for m, n in zip(maps, ns) if n > 0]  # empty: no rows
    if not live:
        return out
    k = len(live)
    code = lib.umr_grouped_row_order(
        (ctypes.c_void_p * k)(*(m.masks.data_ptr() for m, _ in live)),
        (ctypes.c_void_p * k)(*(m.patho.data_ptr() for m, _ in live)),
        (ctypes.c_longlong * k)(*(n for _, n in live)), k,
        order.data_ptr(), tiles.data_ptr(), _ORDER_CLUSTER,
        _build.stream_of(dev))
    _build.check(lib, code, "grouped_row_order")
    LAUNCHES["grouped_row_order"] += 1
    return out


def grouped_row_order(gmap) -> Tuple[torch.Tensor, torch.Tensor]:
    """The order the bf16 kernel reads a map's output rows in: (order
    (N_out,) int32, the rows sorted by their 9-bit used-group mask,
    stable; tiles (ceil(N_out / 64),) int32, each 64-row tile's groups).
    `grouped_row_orders` of the one map: on a CUDA map one launch,
    counted in LAUNCHES["grouped_row_order"]; a CPU map takes the plain
    version and counts nothing."""
    return grouped_row_orders([gmap])[0]


def with_row_order(gmap):
    """The map with its row order and tiles (`grouped_row_order`), made
    once; a map that carries them comes back as it is."""
    return with_row_orders([gmap])[0]


def with_row_orders(maps) -> list:
    """Each map with its row order and tiles, those it lacks made by one
    `grouped_row_orders` call (one launch on the card); a map that
    carries them comes back as it is."""
    maps = list(maps)
    todo = [i for i, m in enumerate(maps) if m.order is None]
    for i, (order, tiles) in zip(todo, grouped_row_orders(
            [maps[i] for i in todo])):
        maps[i] = maps[i]._replace(order=order, tiles=tiles)
    return maps


def weight_tiles_plain(weights: torch.Tensor, dx_taps: int = 0
                       ) -> torch.Tensor:
    """The plain version of the bf16 weight tiles the kernel reads
    (csrc grouped_weight_tiles_kernel): weights (27, Cin, Cout) f32 of the
    conv (dx_taps 0), or of the forward whose dX the conv is (dx_taps 1:
    tap k reads weights[k]^T; 2: weights[26 - k]^T) -> a flat bf16 tensor
    of 9 x k_steps x channel tiles blocks for the plan's channel tiles of
    BN (`grouped_plan`'s tile_cols), block (g, kc, nt) BN x 64 with
    row n the K entries kc 64 + [0, 64) of channel nt BN + n (K entry
    p round8(Cin) + c of group g: tap 3 g + p, input channel c), each
    row's 16-byte pieces swizzled (piece j at place j ^ (n % 8))."""
    w = weights
    if dx_taps == 2:
        w = w.flip(0)
    if dx_taps:
        w = w.transpose(1, 2)
    _, cin, cout = w.shape
    cin8, cols = _round8(cin), grouped_plan(1, 1, cin, cout).tile_cols
    steps = -(-3 * cin8 // _MMA_K)
    nt = -(-cout // cols)
    full = torch.zeros((_GROUPS, 3, cin8, nt * cols), dtype=torch.float32,
                       device=w.device)
    full[:, :, :cin, :cout] = w.reshape(_GROUPS, 3, cin, cout)
    k = torch.zeros((_GROUPS, steps * _MMA_K, nt * cols),
                    dtype=torch.float32, device=w.device)
    k[:, :3 * cin8] = full.reshape(_GROUPS, 3 * cin8, nt * cols)
    # (g, kc, nt, n, j, e): K entry kc 64 + 8 j + e of channel nt cols + n
    blocks = k.reshape(_GROUPS, steps, 8, 8, nt, cols).permute(0, 1, 4, 5,
                                                               2, 3)
    n = torch.arange(cols, device=w.device)[:, None]
    place = torch.bitwise_xor(torch.arange(8, device=w.device)[None, :],
                              n % 8)  # (cols, 8): piece j's place
    out = torch.empty_like(blocks)
    out[:, :, :, n, place] = blocks[:, :, :, n, torch.arange(8,
                                                             device=w.device)]
    return out.to(torch.bfloat16).reshape(-1)


_TILE_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()


def _tile_key(weights: torch.Tensor, dx_taps: int, cols: int) -> tuple:
    return (weights.device, weights.untyped_storage().data_ptr(),
            weights.storage_offset(), tuple(weights.shape),
            tuple(weights.stride()), weights.dtype, dx_taps, cols)


def weight_tiles(weights: torch.Tensor, dx_taps: int = 0) -> torch.Tensor:
    """The bf16 weight tiles of `weight_tiles_plain`'s layout, made once a
    parameter version: cached on the tensor's storage, offset, shape,
    strides, dx_taps and the plan's channel tile, and held to the version
    counter it was made at (any in-place update of the tensor or a view of
    it, the optimizer's included, bumps the counter, and the next call
    makes them anew). An
    entry keeps its weight tensor, so no other tensor takes its address
    while the entry lives; at most _TILE_CACHE_SIZE entries, the least
    recently used dropped first. Inference tensors, which keep no version
    counter, and calls made while a CUDA graph is captured are not
    cached. On the card one launch of umr_grouped_weight_tiles on the
    current stream a miss (WEIGHT_TILE_BUILDS); a CPU tensor takes the
    plain version."""
    _, cin, cout = weights.shape
    if dx_taps:
        cin, cout = cout, cin
    cols = grouped_plan(1, 1, cin, cout).tile_cols
    key = _tile_key(weights, dx_taps, cols)
    cacheable = not weights.is_inference() and not (
        weights.is_cuda and torch.cuda.is_current_stream_capturing())
    if cacheable:
        hit = _TILE_CACHE.get(key)
        if hit is not None and hit[1] == weights._version:
            _TILE_CACHE.move_to_end(key)
            return hit[2]
    if weights.device.type == "cpu":
        tiles = weight_tiles_plain(weights, dx_taps)
    else:
        lib = _build.load_library()  # raises if it cannot be built
        if weights.device.type != "cuda":
            raise ValueError(f"weight_tiles runs on CUDA or CPU tensors, "
                             f"not {weights.device}")
        steps = -(-3 * _round8(cin) // _MMA_K)
        tiles = torch.empty(_GROUPS * steps * -(-cout // cols) * cols
                            * _MMA_K, dtype=torch.bfloat16,
                            device=weights.device)
        code = lib.umr_grouped_weight_tiles(
            weights.data_ptr(), tiles.data_ptr(), cin, cout, cols, dx_taps,
            _build.stream_of(weights.device))
        _build.check(lib, code, "grouped_weight_tiles")
        WEIGHT_TILE_BUILDS[dx_taps] += 1
    if cacheable:
        _TILE_CACHE[key] = (weights, weights._version, tiles)
        _TILE_CACHE.move_to_end(key)
        while len(_TILE_CACHE) > _TILE_CACHE_SIZE:
            _TILE_CACHE.popitem(last=False)
    return tiles


def clear_weight_tiles() -> None:
    """Drop every cached weight tile (and the tensors the entries hold)."""
    _TILE_CACHE.clear()


def sparse_conv_grouped_kernel(feats: torch.Tensor, weights: torch.Tensor,
                               gmap, bias: Optional[torch.Tensor] = None,
                               compute_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """feats (N_in, Cin) f32 with invalid rows zero, weights (27, Cin,
    Cout) f32, gmap an ops.sparse.GroupedMap (center (9, N_out) int32 or
    int64, masks (9, 3, N_out) and patho (9, N_out) bool, worder (3,)
    int64), optional bias (Cout,) f32 -> (N_out, Cout) f32, operands
    rounded to compute_dtype, fp32 sums. One launch a call (two kernels
    with bf16 operands: the bf16 feature copy, then the conv; and where
    the map carries no row order, `grouped_row_order` first, counted on
    its own; where the weights' tiles are not cached, their launch), on
    the current stream, counted in LAUNCHES. No float atomics: a row's
    sums run in an order its own data and the shapes set, so two launches
    give the same bits and a row's bits depend neither on the batch nor
    on the row order. A CPU tensor takes the plain version and counts
    nothing."""
    if feats.device.type == "cpu":
        # the plain version sits beside the dispatch, which imports this
        from umeregrobust_tpu_torch.ops.sparse import sparse_conv_grouped_plain

        return sparse_conv_grouped_plain(feats, weights, gmap, bias,
                                         compute_dtype)
    return _launch(feats, weights, gmap, bias, compute_dtype, 0)


def sparse_conv_grouped_dx(dout: torch.Tensor, weights: torch.Tensor,
                           adjoint, reverse_taps: bool,
                           compute_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """The input's gradient of the grouped conv with `weights` (27, Cin,
    Cout): dout (N_out, Cout) f32 (dY), `adjoint` the GroupedMap of the
    forward map's adjoint (N_in output rows reading dY's rows) ->
    (N_in, Cin) f32 = dY's conv over the adjoint map with each tap's
    weights transposed, tap k taking W[k]^T, or W[26 - k]^T where
    reverse_taps (a self map is its own adjoint with its taps reversed).
    The same kernel as the forward, the weight view read by its own cached
    bf16 weight tiles (`weight_tiles(weights, 1 or 2)`); the weights
    rounded to compute_dtype, dY not rounded (with bf16 the kernel
    multiplies its hi and lo bf16 parts: JAX's autodiff of the forward's
    casts takes the cotangent as it is), fp32 sums, the result rounded to
    compute_dtype and held in fp32 (as autograd through the forward's
    rounding of its operands gives it). Counted in LAUNCHES as the
    forward; a CPU tensor takes the plain version
    (ops/sparse.sparse_conv_grouped_dx_plain)."""
    if dout.device.type == "cpu":
        from umeregrobust_tpu_torch.ops.sparse import (
            sparse_conv_grouped_dx_plain)

        return sparse_conv_grouped_dx_plain(dout, weights, adjoint,
                                            reverse_taps, compute_dtype)
    return _launch(dout, weights, adjoint, None, compute_dtype,
                   2 if reverse_taps else 1)


def _launch(feats, weights, gmap, bias, compute_dtype, dx_taps):
    """One call of umr_sparse_conv_grouped (dx_taps 0: the conv; 1 / 2:
    a dX, the weights read as each tap transposed, 2 also reversed)."""
    lib, N_in, N_out, Cin, Cout = _checked(feats, weights, gmap, bias,
                                           compute_dtype, dx_taps != 0)
    dev = feats.device
    out = torch.empty((N_out, Cout), dtype=torch.float32, device=dev)
    if N_out == 0:
        return out
    plan = grouped_plan(N_in, N_out, Cin, Cout, compute_dtype, dx_taps != 0)
    order = tiles = xb = wt = None
    if plan.kind == "mma":
        order, tiles = (gmap.order, gmap.tiles) if gmap.order is not None \
            else grouped_row_order(gmap)
        wt = weight_tiles(weights, dx_taps)
        xb = torch.empty(plan.xb_elems, dtype=torch.bfloat16, device=dev)
    code = lib.umr_sparse_conv_grouped(
        feats.data_ptr(), weights.data_ptr(), gmap.center.data_ptr(),
        gmap.masks.data_ptr(), gmap.patho.data_ptr(), gmap.worder.data_ptr(),
        0 if order is None else order.data_ptr(),
        0 if tiles is None else tiles.data_ptr(),
        0 if bias is None else bias.data_ptr(),
        0 if xb is None else xb.data_ptr(), 0 if wt is None else wt.data_ptr(),
        out.data_ptr(), N_in, N_out, Cin, Cout,
        int(gmap.center.dtype == torch.int64), int(plan.kind == "mma"),
        plan.tile_cols, plan.cluster, dx_taps, _build.stream_of(dev))
    _build.check(lib, code, "sparse_conv_grouped")
    LAUNCHES["sparse_conv_grouped"] += 1
    return out


def sparse_conv_grouped_wgrad(feats: torch.Tensor, dout: torch.Tensor,
                              gmap,
                              compute_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """The grouped conv's weight gradient: feats (N_in, Cin) f32 (the
    forward's input), dout (N_out, Cout) f32 (dY), gmap the forward's
    GroupedMap -> dW (27, Cin, Cout) f32 in lexicographic tap order,
    dW3[g] = sum over rows o of x3_g[o]^T dY[o] with x3_g[o] the window
    the forward reads. X is rounded to compute_dtype as the forward
    rounds it; dY is not rounded (with bf16 the kernel multiplies its hi
    and lo bf16 parts: JAX's autodiff of the forward's casts takes the
    cotangent as it is); products are summed in fp32 and the result is
    rounded to compute_dtype and held in fp32. One call, counted once in
    LAUNCHES: with bf16 three kernels (the prep: bf16 X, the window
    codes and each group's tiles of the map's order; the wgmma runs; the
    sum of their partials), where the map carries no row order
    `grouped_row_order` first (counted on its own); the stem (Cin <= 2)
    two (the packed runs in code order, the sum); with fp32 two (an FMA
    tile over splits, the sum). No atomics: two launches give the same
    bits. A CPU tensor takes the plain version
    (ops/sparse.sparse_conv_grouped_wgrad_plain) and counts nothing; a
    CUDA tensor launches the kernels or raises."""
    if feats.device.type == "cpu":
        from umeregrobust_tpu_torch.ops.sparse import (
            sparse_conv_grouped_wgrad_plain)

        return sparse_conv_grouped_wgrad_plain(feats, dout, gmap,
                                               compute_dtype)
    dev = feats.device
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"sparse_conv_grouped_wgrad: compute_dtype fp32 or "
                         f"bf16, got {compute_dtype}")
    if feats.dim() != 2 or dout.dim() != 2:
        raise ValueError(f"sparse_conv_grouped_wgrad: feats (N_in, Cin) and "
                         f"dout (N_out, Cout), got {tuple(feats.shape)} and "
                         f"{tuple(dout.shape)}")
    (N_in, Cin), (N_out, Cout) = feats.shape, dout.shape
    _build.require(feats, "feats", torch.float32, (N_in, Cin), dev)
    if _check_map(gmap, dev) != N_out:
        raise ValueError(f"dout: {N_out} rows, the map has "
                         f"{gmap.center.shape[1]}")
    _build.require(dout, "dout", torch.float32, (N_out, Cout), dev)
    if min(Cin, Cout) < 1 or max(N_in, N_out) >= 2 ** 31 - 8192 \
            or 3 * _round8(Cin) >= 2 ** 31 - 64 \
            or 27 * Cin * Cout >= 2 ** 26 or (
                compute_dtype == torch.bfloat16 and Cin > _WG_STEM_CIN
                and N_in >= 2 ** 27 - 4):
        raise ValueError(f"sparse_conv_grouped_wgrad: unsupported shape "
                         f"Cin={Cin} Cout={Cout} N_in={N_in} N_out={N_out}")
    _check_order(gmap, dev, N_out)
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"sparse_conv_grouped_wgrad runs on CUDA or CPU "
                         f"tensors, not {dev}")
    if N_out == 0:
        return torch.zeros((27, Cin, Cout), dtype=torch.float32, device=dev)
    plan = wgrad_plan(N_out, Cin, Cout, compute_dtype)
    dw = torch.empty((27, Cin, Cout), dtype=torch.float32, device=dev)
    part = torch.empty(plan.part_elems, dtype=torch.float32, device=dev)
    order = tiles = xb = codes = None
    if plan.kind == "mma":
        order, tiles = (gmap.order, gmap.tiles) if gmap.order is not None \
            else grouped_row_order(gmap)
        xb = torch.empty(max(N_in, 1) * plan.xb_cols, dtype=torch.bfloat16,
                         device=dev)
        codes = torch.empty(plan.code_elems, dtype=torch.int32, device=dev)
    code = lib.umr_sparse_conv_grouped_wgrad(
        feats.data_ptr(), dout.data_ptr(), gmap.center.data_ptr(),
        gmap.masks.data_ptr(), gmap.patho.data_ptr(), gmap.worder.data_ptr(),
        *(0 if x is None else x.data_ptr() for x in (order, tiles, xb, codes)),
        part.data_ptr(), dw.data_ptr(), N_in, N_out, Cin, Cout,
        int(gmap.center.dtype == torch.int64), int(plan.kind != "fma"),
        plan.split_rows, _build.stream_of(dev))
    _build.check(lib, code, "sparse_conv_grouped_wgrad")
    LAUNCHES["sparse_conv_grouped_wgrad"] += 1
    return dw
