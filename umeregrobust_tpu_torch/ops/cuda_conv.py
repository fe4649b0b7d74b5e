"""Per-tap sparse convolution: wrappers of the CUDA kernels in
csrc/sparse_conv_taps.cu and their plain PyTorch version (port of the
Pallas gather-conv experiments conv_pallas_unroll and conv_pallas_taps in
tools/exp_pallas_gather.py, which compute
umeregrobust_tpu/ops/sparse.py:sparse_conv).

    out[i] = sum_k feats[nbr[k, i]] @ w[k]   (index < 0 or >= N_in: zero row)

Operands are rounded to `compute_dtype` and the products summed in fp32
(no TF32). With bf16 operands (the main path) both wrappers first build
the map's per-tap entry lists (`conv_entries`: the valid (out_row,
in_row) pairs of each tap in row order) and multiply on the tensor cores:
`sparse_conv_tapsplit` is tap-stationary (each tap with entries reads its
weights once and multiplies its gathered rows; the per-entry rows are
then added per output row in tap order), `sparse_conv_rowtile` is
output-stationary (a 128 x 64 output tile walks the taps that have an
entry in it), and with one input channel it is a map-streaming kernel.
fp32 operands take the FMA tile of the first port (`sparse_conv_fma`).
`choose_kernel` picks the wrapper from the shapes alone. The backward:
`sparse_conv_wgrad` (kernels in the same source: bf16 tensor-core tap
products, a one-input-channel row-tile kernel, the fp32 CUDA-core tile;
`wgrad_plan` picks) gives the weights' gradient,
dW[k] = sum over tap k's entries (o, i) of X[i]^T dY[o]; the
input's gradient is the forward conv of dY over the inverted map with
the weights transposed, so it launches the two forward kernels again
(ops/sparse.py `sparse_conv`). On a CPU tensor the wrappers run the
plain version; on a CUDA tensor they launch their kernels or raise.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from umeregrobust_tpu_torch.ops import _build
from umeregrobust_tpu_torch.ops.cuda_gather import gather_rows_plain

__all__ = ["sparse_conv_rowtile", "sparse_conv_tapsplit", "sparse_conv_plain",
           "sparse_conv_fma", "choose_kernel", "conv_entries",
           "conv_entries_plain", "ConvEntries", "round_to",
           "sparse_conv_wgrad", "sparse_conv_wgrad_plain",
           "sparse_conv_wgrad_fma", "wgrad_split", "wgrad_plan", "WgradPlan",
           "LAUNCHES", "TRACE"]

# kernel launches by each wrapper (not by the plain version)
LAUNCHES = {"sparse_conv_rowtile": 0, "sparse_conv_tapsplit": 0,
            "sparse_conv_wgrad": 0}
# when a list: one (kernel, N_in, N_out, Cin, Cout, K, S) per launch
TRACE: Optional[List[tuple]] = None

_SM_COUNT = 132  # H100 SXM
_TILE_ROWS = 64  # kTM of the FMA tile
_ROWTILE_ROWS = 128  # kRTM of the tensor-core row-tile kernel
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
_MAX_CIN16 = 1104  # tensor-core tap kernel: weights + one entry tile in smem
_MAX_K_SUM = 1536  # taps whose positions the sum kernel stages
_CIN1_MAX_SMEM = 232448  # bytes of shared memory a block may have
# tapsplit's scratch: one fp32 row of Cout per entry, at most this many
# bytes (entries past it are computed by the sum kernel itself)
SCRATCH_BYTES = 1 << 30


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
    """("rowtile", 1) or ("tapsplit", S), from the shapes alone (no host
    read; S: the tap segments of the FMA tile, the fp32 path). Rowtile
    takes the layers whose 64-row tiles are many and dense with entries:
    k3 layers on levels of >= 256 tiles, and the stems (one input channel
    and 32 output channels in every arch, >= 132 tiles: the map-streaming
    kernel). Every other layer, the k5 / k7 layers above all (a 64-row
    tile holds entries of most of their 125 taps but few entries of
    each), is tap-stationary. Thresholds from the per-layer device times
    of both kernels on the ResUNet and ResUNetSmall2 conv_impl="scan"
    forwards (chip_smoke.py phase 3)."""
    tiles = -(-n_out // _TILE_ROWS)
    if k_vol == 1 or (cout <= 32 and tiles >= _SM_COUNT) \
            or (k_vol <= 27 and tiles >= 256):
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


class ConvEntries(NamedTuple):
    """Per-tap entry lists of a (K, N_out) map (int32 tensors):
    ent (K, N_out, 2): (out_row, in_row) of tap k's e-th valid entry in row
        order at [k, e] for e < cnt[k], -1 after;
    cnt (K,): valid entries a tap;
    tile_start (K, T + 1): first e of row tile t (rows from t * tile_rows),
        T = ceil(N_out / tile_rows); [:, T] = cnt;
    pos (K, N_out): k * N_out + e for row i's entry in tap k, else -1."""

    ent: torch.Tensor
    cnt: torch.Tensor
    tile_start: torch.Tensor
    pos: torch.Tensor


def conv_entries_plain(nbr_map: torch.Tensor, n_in: int,
                       tile_rows: int = _TILE_ROWS) -> ConvEntries:
    """The entry lists by cumulative sums (valid: 0 <= index < n_in)."""
    K, N_out = nbr_map.shape
    dev = nbr_map.device
    valid = (nbr_map >= 0) & (nbr_map < n_in)
    cum = torch.zeros((K, N_out + 1), dtype=torch.int64, device=dev)
    cum[:, 1:] = torch.cumsum(valid.to(torch.int64), 1)
    rank = cum[:, :-1]
    kk, ii = torch.nonzero(valid, as_tuple=True)
    ent = torch.full((K, N_out, 2), -1, dtype=torch.int32, device=dev)
    ent[kk, rank[kk, ii], 0] = ii.to(torch.int32)
    ent[kk, rank[kk, ii], 1] = nbr_map[kk, ii].to(torch.int32)
    base = torch.arange(K, device=dev)[:, None] * N_out
    pos = torch.where(valid, base + rank, -1).to(torch.int32)
    T = -(-N_out // tile_rows)
    edges = torch.clamp(torch.arange(T + 1, device=dev) * tile_rows,
                        max=N_out)
    return ConvEntries(ent=ent, cnt=cum[:, -1].to(torch.int32),
                       tile_start=cum[:, edges].to(torch.int32), pos=pos)


def conv_entries(nbr_map: torch.Tensor, n_in: int,
                 tile_rows: int = _TILE_ROWS) -> ConvEntries:
    """The entry lists; on a CUDA tensor by the kernel both bf16 conv
    paths start with (blocks of a tap's 2048 rows, ballots and a one-warp
    scan, two passes), with the unused tail of `ent` filled with -1 as in
    the plain version. A check of that kernel: the wrappers build their
    lists themselves and this counts no launch."""
    if nbr_map.device.type == "cpu":
        return conv_entries_plain(nbr_map, n_in, tile_rows)
    lib = _build.load_library()
    if nbr_map.dtype not in (torch.int32, torch.int64) or nbr_map.dim() != 2 \
            or not nbr_map.is_contiguous():
        raise ValueError("nbr_map: a contiguous (K, N_out) int32/int64 map")
    if tile_rows not in (32, 64, 128, 256):
        raise ValueError(f"tile_rows 32, 64, 128 or 256, got {tile_rows}")
    K, N_out = nbr_map.shape
    dev = nbr_map.device
    if K * N_out == 0:  # nothing to list, no launch
        return conv_entries_plain(nbr_map, n_in, tile_rows)
    ent = torch.full((K, N_out, 2), -1, dtype=torch.int32, device=dev)
    cnt = torch.empty(K, dtype=torch.int32, device=dev)
    tile_start = torch.empty((K, -(-N_out // tile_rows) + 1),
                             dtype=torch.int32, device=dev)
    pos = torch.empty((K, N_out), dtype=torch.int32, device=dev)
    chunks = torch.empty(K * _ent_chunks(N_out), dtype=torch.int32,
                         device=dev)
    code = lib.umr_conv_entries(
        nbr_map.data_ptr(), ent.data_ptr(), cnt.data_ptr(),
        tile_start.data_ptr(), pos.data_ptr(), chunks.data_ptr(), n_in,
        N_out, K, tile_rows,
        int(nbr_map.dtype == torch.int64), _build.stream_of(dev))
    _build.check(lib, code, "conv_entries")
    return ConvEntries(ent=ent, cnt=cnt, tile_start=tile_start, pos=pos)


def sparse_conv_fma(feats: torch.Tensor, weights: torch.Tensor,
                    nbr_map: torch.Tensor, kind: str,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """The FMA tile of the first port (kind "rowtile": one block walks
    every tap of a 64-row tile; "tapsplit": taps split over grid z,
    partial sums added in segment order): fp32 FMAs over operands rounded
    to compute_dtype. The wrappers' fp32 path, and their bf16 path for
    shapes the tensor-core kernels do not take; with bf16 operands
    otherwise a yardstick only. Counts no launch. CUDA tensors only."""
    lib, dims = _checked(feats, weights, nbr_map, compute_dtype,
                         f"sparse_conv_fma ({kind})")
    N_in, N_out, Cin, Cout, K = dims
    out = torch.empty((N_out, Cout), dtype=torch.float32, device=feats.device)
    if N_out == 0:
        return out
    common = (N_in, N_out, Cin, Cout, K)
    flags = (int(nbr_map.dtype == torch.int64),
             int(compute_dtype == torch.bfloat16),
             _build.stream_of(feats.device))
    if kind == "rowtile":
        code = lib.umr_sparse_conv_rowtile(
            feats.data_ptr(), weights.data_ptr(), nbr_map.data_ptr(),
            out.data_ptr(), *common, *flags)
    else:
        S = _segments(N_out, Cout, K)
        partial = torch.empty((S, N_out, Cout), dtype=torch.float32,
                              device=feats.device)
        code = lib.umr_sparse_conv_tapsplit(
            feats.data_ptr(), weights.data_ptr(), nbr_map.data_ptr(),
            partial.data_ptr(), out.data_ptr(), *common, S, -(-K // S),
            *flags)
    _build.check(lib, code, f"sparse_conv_fma ({kind})")
    return out


def _ent_chunks(n_out: int) -> int:
    """Row chunks of the entry-list kernel (csrc ent_chunks)."""
    return -(-n_out // 2048)


def _cin1_smem(K: int, cout: int) -> int:
    """Shared memory of the one-input-channel kernel (csrc cin1_smem_bytes)."""
    co = 32 if cout <= 32 else 64
    return max(K * co * 4, 8 * 32 * (co + 1) * 4)


def _tap_split(n_in: int, n_out: int, cin: int) -> int:
    """Grid z of the tap kernel. A tap has at most min(N_in, N_out)
    entries on a map the port builds (an input voxel is one output
    voxel's neighbour at a given offset). Each block of a tap stages the
    tap's weights, so wide inputs (more than 128 channels) keep one block
    a tap and channel tile; narrow ones take about 4 tiles of 32 entries
    a block at that bound, at most 16 blocks."""
    if cin > 128:
        return 1
    return min(16, max(1, -(-min(n_in, n_out) // 128)))


def _scratch_rows(K: int, n_in: int, n_out: int, cout: int) -> int:
    """Rows of tapsplit's scratch: K min(N_in, N_out) (every entry of a
    map the port builds), within SCRATCH_BYTES."""
    return max(1, min(K * min(n_in, n_out), SCRATCH_BYTES // (4 * cout)))


def sparse_conv_rowtile(feats: torch.Tensor, weights: torch.Tensor,
                        nbr_map: torch.Tensor,
                        compute_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """feats (N_in, Cin) f32 with invalid rows zero, weights (K, Cin, Cout)
    f32, nbr_map (K, N_out) int32/int64 (-1 absent) -> (N_out, Cout) f32.
    bf16 operands: output-stationary tensor-core row tiles (one input
    channel with Cout <= 64: the map-streaming kernel)."""
    if feats.device.type == "cpu":
        return sparse_conv_plain(feats, weights, nbr_map, compute_dtype)
    lib, dims = _checked(feats, weights, nbr_map, compute_dtype,
                         "sparse_conv_rowtile")
    N_in, N_out, Cin, Cout, K = dims
    if N_out == 0:
        return torch.empty((0, Cout), dtype=torch.float32, device=feats.device)
    if compute_dtype == torch.float32 or K * N_out >= 2 ** 31:
        out = sparse_conv_fma(feats, weights, nbr_map, "rowtile",
                              compute_dtype)
    else:
        dev = feats.device
        out = torch.empty((N_out, Cout), dtype=torch.float32, device=dev)
        idx64 = int(nbr_map.dtype == torch.int64)
        if Cin == 1 and Cout <= 64 and _cin1_smem(K, Cout) <= _CIN1_MAX_SMEM:
            code = lib.umr_sparse_conv_cin1(
                feats.data_ptr(), weights.data_ptr(), nbr_map.data_ptr(),
                out.data_ptr(), N_in, N_out, Cout, K, idx64,
                _build.stream_of(dev))
        else:
            T = -(-N_out // _ROWTILE_ROWS)
            ints = torch.empty(
                2 * K * N_out + K + K * (T + 1) + K * _ent_chunks(N_out),
                dtype=torch.int32, device=dev)
            code = lib.umr_sparse_conv_rowtile_mma(
                feats.data_ptr(), weights.data_ptr(), nbr_map.data_ptr(),
                ints.data_ptr(), out.data_ptr(), N_in, N_out, Cin, Cout, K,
                idx64, _build.stream_of(dev))
        _build.check(lib, code, "sparse_conv_rowtile")
    _note("sparse_conv_rowtile", dims, 1)
    return out


def sparse_conv_tapsplit(feats: torch.Tensor, weights: torch.Tensor,
                         nbr_map: torch.Tensor,
                         compute_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """The same function, tap-stationary with bf16 operands: each tap with
    entries reads its weights once and multiplies its gathered rows on the
    tensor cores into one fp32 scratch row an entry, added per output row
    in tap order by a second kernel (no atomics)."""
    if feats.device.type == "cpu":
        return sparse_conv_plain(feats, weights, nbr_map, compute_dtype)
    lib, dims = _checked(feats, weights, nbr_map, compute_dtype,
                         "sparse_conv_tapsplit")
    N_in, N_out, Cin, Cout, K = dims
    if N_out == 0:
        return torch.empty((0, Cout), dtype=torch.float32, device=feats.device)
    if compute_dtype == torch.float32 or -(-Cin // 16) * 16 > _MAX_CIN16 \
            or K > _MAX_K_SUM or K * N_out >= 2 ** 31:
        out = sparse_conv_fma(feats, weights, nbr_map, "tapsplit",
                              compute_dtype)
        S = _segments(N_out, Cout, K)
    else:
        dev = feats.device
        S = _tap_split(N_in, N_out, Cin)
        rows = _scratch_rows(K, N_in, N_out, Cout)
        out = torch.empty((N_out, Cout), dtype=torch.float32, device=dev)
        ints = torch.empty(3 * K * N_out + K + K * _ent_chunks(N_out),
                           dtype=torch.int32, device=dev)
        scratch = torch.empty(rows * Cout, dtype=torch.float32, device=dev)
        code = lib.umr_sparse_conv_tapsplit_mma(
            feats.data_ptr(), weights.data_ptr(), nbr_map.data_ptr(),
            ints.data_ptr(), scratch.data_ptr(), out.data_ptr(), N_in, N_out,
            Cin, Cout, K, S, rows, int(nbr_map.dtype == torch.int64),
            _build.stream_of(dev))
        _build.check(lib, code, "sparse_conv_tapsplit")
    _note("sparse_conv_tapsplit", dims, S)
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


_WGRAD_TILE = 32  # channels of a tile of the FMA wgrad kernel (csrc kWT)
_WGRAD_SEGMENT = 2048  # rows of N_out a segment covers at most
_WGRAD_SCRATCH = 64 << 20  # bytes of partial tiles at most
_WGRAD_MMA_TILE = 128  # channels of a tensor-core wgrad tile (csrc kGM, kGN)
_WGRAD_MMA_SEGMENT = 128  # rows of N_out a tensor-core segment covers
_WGRAD_CIN1_ROWS = 128  # output rows a tile of the one-channel kernel
_WGRAD_CIN1_MAX_K = 384  # taps it takes (csrc kW1Warps x kW1TapsAWarp)
_GRID_Z = 65535


def wgrad_split(n_out: int, cin: int, cout: int, k_vol: int) -> int:
    """Entry segments a tap of the FMA wgrad kernel: one per 2048 rows of
    N_out (a tap has at most N_out entries, so a block walks at most 2048
    of them), as far as the (S, K, Cin, Cout) partial tiles stay within
    64 MB and grid z within its limit."""
    scratch = _WGRAD_SCRATCH // (4 * k_vol * cin * cout)
    return max(1, min(-(-n_out // _WGRAD_SEGMENT), scratch,
                      _GRID_Z // -(-cout // _WGRAD_TILE)))


class WgradPlan(NamedTuple):
    """How sparse_conv_wgrad runs a shape on the card. kind: "cin1" (one
    input channel: output-row tiles of `rows` rows, their partials added
    in tile order), "mma" (bf16 tensor-core tiles of 128 x 128 channels,
    each tap's entries cut into `S` segments) or "fma" (fp32 operands: the
    CUDA-core kernel, `S` segments). scratch_bytes: the partials'."""

    kind: str
    S: int
    rows: int
    scratch_bytes: int


def wgrad_plan(n_out: int, cin: int, cout: int, k_vol: int,
               compute_dtype: torch.dtype = torch.bfloat16) -> WgradPlan:
    """The wgrad kernel and its split, from the shapes alone (a tap's entry
    count is on the card; N_out bounds it). One input channel with up to
    32 outputs and 384 taps: row tiles of 128 rows, doubled while the (T,
    K, Cout) partials pass 64 MB. bf16 otherwise: one segment where the
    (tap, tile) blocks fill the SMs (the partials' extra pass cost more
    than it saved on ResUNet's layers), else enough for about two blocks
    an SM, at most one per 128 rows of N_out, the (S, K, Cin, Cout)
    partials within 64 MB and grid z within its limit. fp32:
    `wgrad_split`."""
    if cin == 1 and cout <= 32 and k_vol <= _WGRAD_CIN1_MAX_K:
        rows = _WGRAD_CIN1_ROWS
        while -(-n_out // rows) * k_vol * cout * 4 > _WGRAD_SCRATCH:
            rows *= 2
        T = max(1, -(-n_out // rows))
        return WgradPlan("cin1", 1, rows, T * k_vol * cout * 4)
    if compute_dtype == torch.float32:
        S = wgrad_split(n_out, cin, cout, k_vol)
        return WgradPlan("fma", S, 0,
                         S * k_vol * cin * cout * 4 if S > 1 else 0)
    tiles_m = -(-cin // _WGRAD_MMA_TILE)
    tiles_n = -(-cout // _WGRAD_MMA_TILE)
    blocks = k_vol * tiles_m * tiles_n
    want = 1 if blocks >= _SM_COUNT else -(-2 * _SM_COUNT // blocks)
    S = max(1, min(want, -(-n_out // _WGRAD_MMA_SEGMENT),
                   _WGRAD_SCRATCH // (4 * k_vol * cin * cout),
                   _GRID_Z // tiles_n))
    return WgradPlan("mma", S, 0, S * k_vol * cin * cout * 4 if S > 1 else 0)


def _wgrad_checked(feats, dout, nbr_map, compute_dtype, name):
    """Validate sparse_conv_wgrad's inputs; returns (lib, dims)."""
    dev = feats.device
    lib = _build.load_library()  # raises if it cannot be built
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {dev}")
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"{name}: compute_dtype fp32 or bf16, got "
                         f"{compute_dtype}")
    if nbr_map.dtype not in (torch.int32, torch.int64) or nbr_map.dim() != 2:
        raise ValueError("nbr_map: expected a (K, N_out) int32/int64 map")
    K, N_out = nbr_map.shape
    _build.require(nbr_map, "nbr_map", nbr_map.dtype, (K, N_out), dev)
    _build.require(feats, "feats", torch.float32, (None, None), dev)
    _build.require(dout, "dout", torch.float32, (N_out, None), dev)
    N_in, Cin = feats.shape
    Cout = dout.shape[1]
    if min(K, Cin, Cout) < 1 or K > 65535 or 2 * K * N_out >= 2 ** 31 - 64 \
            or max(N_in, N_out) >= 2 ** 31 - 64:
        raise ValueError(f"{name}: unsupported shape K={K} Cin={Cin} "
                         f"Cout={Cout} N_in={N_in} N_out={N_out}")
    return lib, (N_in, N_out, Cin, Cout, K)


def sparse_conv_wgrad_fma(feats: torch.Tensor, dout: torch.Tensor,
                          nbr_map: torch.Tensor,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """The CUDA-core wgrad kernel of the first port (a block a tap x 32 x
    32 channel tile x entry segment, fp32 FMAs, segments added in order):
    sparse_conv_wgrad's fp32 path, and with bf16 operands a yardstick
    only. Counts no launch. CUDA tensors only."""
    lib, dims = _wgrad_checked(feats, dout, nbr_map, compute_dtype,
                               "sparse_conv_wgrad_fma")
    N_in, N_out, Cin, Cout, K = dims
    dev = feats.device
    out = torch.empty((K, Cin, Cout), dtype=torch.float32, device=dev)
    if N_out == 0:
        return out.zero_()
    S = wgrad_split(N_out, Cin, Cout, K)
    ints = torch.empty(2 * K * N_out + K + K * _ent_chunks(N_out),
                       dtype=torch.int32, device=dev)
    partial = (torch.empty((S, K, Cin, Cout), dtype=torch.float32,
                           device=dev) if S > 1 else None)
    code = lib.umr_sparse_conv_wgrad(
        feats.data_ptr(), dout.data_ptr(), nbr_map.data_ptr(),
        ints.data_ptr(), 0 if partial is None else partial.data_ptr(),
        out.data_ptr(), N_in, N_out, Cin, Cout, K, S,
        int(compute_dtype == torch.bfloat16),
        int(nbr_map.dtype == torch.int64), _build.stream_of(dev))
    _build.check(lib, code, "sparse_conv_wgrad_fma")
    return out


def sparse_conv_wgrad(feats: torch.Tensor, dout: torch.Tensor,
                      nbr_map: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """feats (N_in, Cin) f32, dout (N_out, Cout) f32, nbr_map (K, N_out)
    int32/int64 (-1 absent) -> (K, Cin, Cout) f32 weight gradient,
    dW[k] = sum over tap k's valid entries (o, i) of X[i]^T dY[o], operands
    rounded to compute_dtype, fp32 sums. On the card (`wgrad_plan`): one
    input channel -> row tiles that read each dY row and the map once,
    adding into every tap's sums, their partials added in tile order; bf16
    -> the map's entry lists, X and dY rounded to bf16 once, then a block a (tap, 128 x 128 channel tile, entry segment)
    multiplying gathered rows on the tensor cores, segments added in
    order; fp32 -> the CUDA-core kernel (`sparse_conv_wgrad_fma`). No
    atomics: two launches give the same bits."""
    if feats.device.type == "cpu":
        return sparse_conv_wgrad_plain(feats, dout, nbr_map, compute_dtype)
    lib, dims = _wgrad_checked(feats, dout, nbr_map, compute_dtype,
                               "sparse_conv_wgrad")
    N_in, N_out, Cin, Cout, K = dims
    dev = feats.device
    if N_out == 0:
        return torch.zeros((K, Cin, Cout), dtype=torch.float32, device=dev)
    plan = wgrad_plan(N_out, Cin, Cout, K, compute_dtype)
    idx64 = int(nbr_map.dtype == torch.int64)
    if plan.kind == "fma":
        out = sparse_conv_wgrad_fma(feats, dout, nbr_map, compute_dtype)
    else:
        out = torch.empty((K, Cin, Cout), dtype=torch.float32, device=dev)
        partial = (torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                               device=dev) if plan.scratch_bytes else None)
        if plan.kind == "cin1":
            code = lib.umr_sparse_conv_wgrad_cin1(
                feats.data_ptr(), dout.data_ptr(), nbr_map.data_ptr(),
                partial.data_ptr(), out.data_ptr(), N_in, N_out, Cout, K,
                plan.rows, int(compute_dtype == torch.bfloat16), idx64,
                _build.stream_of(dev))
        else:
            ints = torch.empty(2 * K * N_out + K + K * _ent_chunks(N_out),
                               dtype=torch.int32, device=dev)
            xb = torch.empty(N_in * -(-Cin // 8) * 8, dtype=torch.bfloat16,
                             device=dev)
            gb = torch.empty(N_out * -(-Cout // 8) * 8, dtype=torch.bfloat16,
                             device=dev)
            code = lib.umr_sparse_conv_wgrad_mma(
                feats.data_ptr(), dout.data_ptr(), nbr_map.data_ptr(),
                ints.data_ptr(), xb.data_ptr(), gb.data_ptr(),
                0 if partial is None else partial.data_ptr(), out.data_ptr(),
                N_in, N_out, Cin, Cout, K, plan.S, idx64,
                _build.stream_of(dev))
        _build.check(lib, code, "sparse_conv_wgrad")
    LAUNCHES["sparse_conv_wgrad"] += 1
    return out
