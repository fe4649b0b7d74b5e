"""Grouped-window k=3 sparse convolution: the wrapper of the CUDA kernel in
csrc/sparse_conv_grouped.cu (which takes the window gathers of
tools/exp_gather2.py `pg` and the per-group products of
ops/sparse.sparse_conv_grouped, the port of
umeregrobust_tpu/ops/sparse.py:sparse_conv_grouped, into one launch a
layer), and the plan it runs by.

    out[i] = bias + sum_g [f[c-1] | f[c] | f[c+1] or f[c] (patho)] @ w3[g]

with each slot a zero row where its mask is off or its row lies outside
[0, N_in) (ops/sparse.GroupedMap). bf16 operands: one small launch rounds
the features and the slot-ordered weights to bf16, made per call (a
trained parameter is read anew each time), then output tiles of 128 rows
x 64 channels (64 or 32 rows where the grid would not fill the SMs)
stage their windows with cp.async, four steps of 64 K entries in flight,
and multiply on the tensor cores, groups in order, K chunks ascending.
fp32 operands: an FMA tile of the same order. On a CPU tensor the
wrapper runs the plain version
(ops/sparse.sparse_conv_grouped_plain); on a CUDA tensor it launches the
kernel or raises.

The backward (ops/sparse.GroupedConv) runs on two kernels: the input's
gradient is this kernel on dY over the adjoint map
(`sparse_conv_grouped_dx`: each tap's weights transposed, for a self map
the taps reversed, read so by the launch that makes the bf16 weight
copy); the weights' gradient is `sparse_conv_grouped_wgrad`
(csrc/sparse_conv_grouped_wgrad.cu: dW3[g] = sum_o x3_g[o]^T dY[o] on the
tensor cores, a block a (64 window columns x 64 channels) tile of one
group and a split of the output rows, the partials summed in split order
by a second launch; `wgrad_plan` mirrors it).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from umeregrobust_tpu_torch.ops import _build

__all__ = ["sparse_conv_grouped_kernel", "sparse_conv_grouped_dx",
           "sparse_conv_grouped_wgrad",
           "grouped_plan", "GroupedPlan", "wgrad_plan", "WgradPlan",
           "LAUNCHES"]

# kernel launches by each wrapper (not by the plain versions)
LAUNCHES = {"sparse_conv_grouped": 0, "sparse_conv_grouped_wgrad": 0}

_GROUPS = 9
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
# the kernels' tiles (csrc kBM (and 64, 32), kBN, kKC, kStages; kFM, kFN,
# kFK)
_MMA_ROWS, _MMA_COLS, _MMA_K, _MMA_STAGES = (128, 64, 32), 64, 64, 4
_FMA_ROWS, _FMA_COLS, _FMA_K = 64, 64, 16
# the weight gradient's tiles (csrc kWM, kWN, kWR, kWSteps)
_WG_ROWS, _WG_COLS, _WG_STEP, _WG_STEPS = 64, 64, 32, 256
_SM_COUNT = 132  # H100 SXM


def _round8(x: int) -> int:
    return -(-x // 8) * 8


class GroupedPlan(NamedTuple):
    """How the kernel runs a shape. kind "mma" (bf16 operands) or "fma"
    (fp32); tile rows x cols of output a block (mma: 128 rows, or 64 or
    32 where 128-row tiles would give fewer blocks than the card has SMs:
    the order of a row's sums does not depend on its tile, so neither do
    its bits); k_chunk K entries a step and k_steps steps a group (over
    3 Cin, or 3 round8(Cin) with bf16); grid (row tiles, channel tiles);
    smem_bytes of shared memory a block
    (the mma kernel's stages are dynamic shared memory, static for the fma
    kernel); xb_elems / wb_elems the bf16 copies' sizes (0 for fp32)."""

    kind: str
    tile_rows: int
    tile_cols: int
    k_chunk: int
    k_steps: int
    grid: tuple
    smem_bytes: int
    xb_elems: int
    wb_elems: int


class WgradPlan(NamedTuple):
    """How the weight-gradient kernel runs a shape: kind "mma" (bf16
    operands) or "fma" (fp32); split_rows output rows a split (a multiple
    of 32); splits; grid (splits, 64 x 64 tiles of the (3 round8(Cin),
    round8(Cout)) product, 9 groups); part_elems the fp32 scratch of the
    splits' partials; xb_cols / yb_cols the bf16 copies' row widths (0
    for fp32)."""

    kind: str
    split_rows: int
    splits: int
    grid: tuple
    part_elems: int
    xb_cols: int
    yb_cols: int


def grouped_plan(n_in: int, n_out: int, cin: int, cout: int,
                 compute_dtype: torch.dtype = torch.bfloat16) -> GroupedPlan:
    """The kernel's plan from the shapes alone (no host read)."""
    if compute_dtype == torch.float32:
        k3 = 3 * cin
        return GroupedPlan(
            "fma", _FMA_ROWS, _FMA_COLS, _FMA_K, -(-k3 // _FMA_K),
            (-(-n_out // _FMA_ROWS), -(-cout // _FMA_COLS)),
            4 * (_FMA_K * (_FMA_ROWS + 4) + _FMA_K * _FMA_COLS
                 + 3 * _FMA_ROWS) + 4, 0, 0)
    cin8, cout8 = _round8(cin), _round8(cout)
    k3 = 3 * cin8
    cols = -(-cout // _MMA_COLS)
    rows = next((r for r in _MMA_ROWS if -(-n_out // r) * cols >= _SM_COUNT),
                _MMA_ROWS[-1])
    smem = 2 * _MMA_STAGES * (rows * (_MMA_K + 8) + _MMA_K * (_MMA_COLS + 8))
    return GroupedPlan("mma", rows, _MMA_COLS, _MMA_K, -(-k3 // _MMA_K),
                       (-(-n_out // rows), cols), smem, max(n_in, 1) * cin8,
                       _GROUPS * k3 * cout8)


def wgrad_plan(n_out: int, cin: int, cout: int,
               compute_dtype: torch.dtype = torch.bfloat16) -> WgradPlan:
    """The weight-gradient kernel's plan from the shapes alone (no host
    read): tiles of 64 window columns (3 round8(Cin) in all) x 64
    channels (round8(Cout)) per group, and the output rows cut into
    splits of `split_rows` (steps of 32 rows, at most 256 a split): the
    fewest splits that give about two blocks an SM, at least one step a
    split. The splits' order of sums, and so the bits, follow from the
    shapes."""
    cin8, cout8 = _round8(cin), _round8(cout)
    k3 = 3 * cin8
    tiles = -(-k3 // _WG_ROWS) * -(-cout8 // _WG_COLS)
    steps = max(1, -(-n_out // _WG_STEP))
    want = -(-2 * _SM_COUNT // (_GROUPS * tiles))
    splits = max(-(-steps // _WG_STEPS), min(steps, want))
    per = -(-steps // splits)  # steps a split
    splits = -(-steps // per)
    return WgradPlan(
        "mma" if compute_dtype == torch.bfloat16 else "fma",
        per * _WG_STEP, splits, (splits, tiles, _GROUPS),
        splits * _GROUPS * k3 * cout8,
        cin8 if compute_dtype == torch.bfloat16 else 0,
        cout8 if compute_dtype == torch.bfloat16 else 0)


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


def sparse_conv_grouped_kernel(feats: torch.Tensor, weights: torch.Tensor,
                               gmap, bias: Optional[torch.Tensor] = None,
                               compute_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """feats (N_in, Cin) f32 with invalid rows zero, weights (27, Cin,
    Cout) f32, gmap an ops.sparse.GroupedMap (center (9, N_out) int32 or
    int64, masks (9, 3, N_out) and patho (9, N_out) bool, worder (3,)
    int64), optional bias (Cout,) f32 -> (N_out, Cout) f32, operands
    rounded to compute_dtype, fp32 sums. One launch a call (two kernels
    with bf16 operands: the bf16 copies, then the conv), on the current
    stream, counted in LAUNCHES. No atomics: a row's sums run in an order
    its own data sets, so two launches give the same bits and a row's
    bits do not depend on the batch. A CPU tensor takes the plain version
    and counts nothing."""
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
    The same kernel as the forward, the weight view read by its own bf16
    weight copy; dY rounded to compute_dtype, fp32 sums, the result
    rounded to compute_dtype and held in fp32 (as autograd through the
    forward's rounding of its operands gives it). Counted in LAUNCHES as
    the forward; a CPU tensor takes the plain version (the plain forward
    over the adjoint map)."""
    if dout.device.type == "cpu":
        from umeregrobust_tpu_torch.ops.sparse import (
            round_to, sparse_conv_grouped_plain)

        w = weights.flip(0) if reverse_taps else weights
        return round_to(sparse_conv_grouped_plain(
            dout, w.transpose(1, 2), adjoint, None, compute_dtype),
            compute_dtype)
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
    plan = grouped_plan(N_in, N_out, Cin, Cout, compute_dtype)
    xb = wb = None
    if plan.kind == "mma":
        xb = torch.empty(plan.xb_elems, dtype=torch.bfloat16, device=dev)
        wb = torch.empty(plan.wb_elems, dtype=torch.bfloat16, device=dev)
    code = lib.umr_sparse_conv_grouped(
        feats.data_ptr(), weights.data_ptr(), gmap.center.data_ptr(),
        gmap.masks.data_ptr(), gmap.patho.data_ptr(), gmap.worder.data_ptr(),
        0 if bias is None else bias.data_ptr(),
        0 if xb is None else xb.data_ptr(), 0 if wb is None else wb.data_ptr(),
        out.data_ptr(), N_in, N_out, Cin, Cout,
        int(gmap.center.dtype == torch.int64), int(plan.kind == "mma"),
        plan.tile_rows, dx_taps, _build.stream_of(dev))
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
    the forward reads. X and dY are rounded to compute_dtype (the
    forward rounds X; dY's rounding is the backward's one rounding of its
    own), products summed in fp32, the result rounded to compute_dtype
    and held in fp32. One call: with bf16 three kernels (the bf16
    copies, the tiles, the sum of the splits' partials in split order),
    with fp32 two (an FMA tile, the sum); counted once in LAUNCHES. No
    atomics: two launches give the same bits. A CPU tensor takes the
    plain version (ops/sparse.sparse_conv_grouped_wgrad_plain) and counts
    nothing; a CUDA tensor launches the kernels or raises."""
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
            or 3 * _round8(Cin) >= 2 ** 31 - 64:
        raise ValueError(f"sparse_conv_grouped_wgrad: unsupported shape "
                         f"Cin={Cin} Cout={Cout} N_in={N_in} N_out={N_out}")
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"sparse_conv_grouped_wgrad runs on CUDA or CPU "
                         f"tensors, not {dev}")
    if N_out == 0:
        return torch.zeros((27, Cin, Cout), dtype=torch.float32, device=dev)
    plan = wgrad_plan(N_out, Cin, Cout, compute_dtype)
    dw = torch.empty((27, Cin, Cout), dtype=torch.float32, device=dev)
    part = torch.empty(plan.part_elems, dtype=torch.float32, device=dev)
    xb = yb = None
    if plan.kind == "mma":
        xb = torch.empty(max(N_in, 1) * plan.xb_cols, dtype=torch.bfloat16,
                         device=dev)
        yb = torch.empty(N_out * plan.yb_cols, dtype=torch.bfloat16,
                         device=dev)
    code = lib.umr_sparse_conv_grouped_wgrad(
        feats.data_ptr(), dout.data_ptr(), gmap.center.data_ptr(),
        gmap.masks.data_ptr(), gmap.patho.data_ptr(), gmap.worder.data_ptr(),
        0 if xb is None else xb.data_ptr(), 0 if yb is None else yb.data_ptr(),
        part.data_ptr(), dw.data_ptr(), N_in, N_out, Cin, Cout,
        int(gmap.center.dtype == torch.int64), int(plan.kind == "mma"),
        plan.split_rows, _build.stream_of(dev))
    _build.check(lib, code, "sparse_conv_grouped_wgrad")
    LAUNCHES["sparse_conv_grouped_wgrad"] += 1
    return dw
