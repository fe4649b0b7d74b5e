// Grouped-window sparse k=3 convolution, one kernel a layer:
//   out[i] = bias + sum over groups g = 0..8 of
//            [f[r0] | f[r1] | f[r2]] @ w3[g]     (3 Cin x Cout)
// where, with c = center[g, i] - 1, slot 0 reads row c - 1 if masks[g, 0,
// i], slot 1 row c if masks[g, 1, i], slot 2 row c + 1 if masks[g, 2, i],
// else row c if patho[g, i]; any other slot, and any row outside [0,
// N_in), reads zeros. w3[g] = weights.reshape(9, 3, Cin, Cout)[g,
// worder]. fp32 sums; operands bf16 (the main path) or fp32.
//
// Replaces: the window gathers of tools/exp_gather2.py `pg` (the
// gather_rows kernel, 9 launches a conv) and the per-group products in
// ops/sparse.py sparse_conv_grouped, the port of
// umeregrobust_tpu/ops/sparse.py:480 sparse_conv_grouped (a lax.scan over
// the 9 groups in plain XLA, no Pallas kernel).
//
// Bound on the H100. A window's slots are consecutive code-sorted input
// rows, so a group's A operand is 3 Cin wide and its product suits the
// tensor cores. The work counted is 2 x 3 Cin x Cout a window that some
// slot uses, at 989 TFLOP/s bf16; the bytes are the bf16 input rows, the
// map, the weights once and the fp32 output once, at 3.35 TB/s. On
// ResUNetSmall2's 18 layers at one pair both bounds are a few hundredths
// of a ms a layer (chip_smoke.py's grouped_layer rows compute them from
// the maps): the kernel is set by how many gathered loads it keeps in
// flight and by how long its chains of dependent steps are, not by either
// peak. The first design (csrc/bench/sparse_conv_grouped_parent.cu) walked
// up to 9 groups x 12 K chunks in a row on 16-80 blocks at one pair,
// staged zero windows for every group some row of a 128-row tile used
// (transposed convs use 7-19% of their windows), and remade the bf16
// weight copy every call.
//
// Design (bf16 operands), Hopper:
//  - rows in the map's order (grouped_row_order.cu: output rows sorted by
//    their 9-bit used-group mask, one stable counting sort a map, and each
//    64-row tile's mask), so a tile's rows mostly use the same groups and
//    a tile stages and multiplies only the groups in its mask; a row is
//    read through the order and written to its own place;
//  - a tile's groups split over the CTAs of a thread-block cluster (1-4,
//    fixed by Cin and Cout in the wrapper's plan: about a CTA a 128 K
//    steps of a tile's work), CTA j taking groups
//    [ceil(9 j / CS), ceil(9 (j + 1) / CS)); the partial sums meet in the
//    first CTA with work through distributed shared memory, added in CTA
//    order, and a tile whose groups all fall to one CTA needs no
//    exchange (the sorted tiles of transposed maps mostly);
//  - a CTA is one consumer warpgroup on wgmma.m64nNk16 (N the channel
//    tile: 32, 64 or 128 by Cout; fp32 sums in registers) and one producer
//    warpgroup, over a ring of four stages with full / empty mbarriers:
//    the producers first find every window row of the CTA's groups in one
//    burst of independent map reads (into shared memory), then stage each
//    step's 64 window rows x 64 K entries with 16-byte cp.async pieces,
//    eight lanes a 128-byte row (the rows are a gather, which TMA cannot
//    do; masked slots and rows out of range are zero-fills) whose
//    completion arrives on the stage's barrier, and the step's weight tile
//    by one TMA bulk copy; both land in the 128-byte swizzled K-major
//    layout that wgmma reads;
//  - the weights are tiled once a parameter version (the wrapper caches
//    the bf16 copy, keyed on the tensor's storage and version counter):
//    tap order within a group, (group, K chunk, channel tile) blocks of
//    N x 64 bf16 already swizzled, so one bulk copy a step moves a block;
//    the producer puts slot s of a window at the K place of its tap
//    (worder), so one copy serves maps of either slot order;
//  - the features are rounded to bf16 rows of round8(Cin) columns by one
//    small launch a call (cp.async cannot convert);
//  - a row's sum runs over its CTA's groups ascending, K ascending in 16s,
//    then the CTAs' partials in CTA order, the bias, and for a gradient
//    the bf16 rounding: the same sequence whatever its tile, the order,
//    the batch or the other rows (a group a row does not use adds exact
//    zeros), so a pair of a batch gets its one-pair bits and two launches
//    agree.
// fp32 operands take an FMA tile (64 x 64 outputs a block, 16 K entries a
// step, each output one fmaf chain over g, then k ascending; no TF32) in
// code order, no order or cluster.
// In training the same kernel gives the input's gradient: dX is dY's conv
// over the adjoint map (the pyramid builds it beside the map) with each
// tap's weights transposed, and for a self map the taps reversed; the
// `dx_taps` argument makes the weight tiles read them so, takes dY
// unrounded as JAX's autodiff of the forward's bf16 casts does (dY = hi +
// lo, two bf16 parts, each step's products on both: SPLIT), and rounds dX
// to bf16 in the epilogue. The weights' gradient is
// sparse_conv_grouped_wgrad.cu.
#include "common.cuh"
#include "grouped_window.cuh"

namespace {

constexpr int kBM = 64;        // output rows a tile (wgmma M; the order's)
constexpr int kKC = 64;        // K entries a step (one 128-byte row)
constexpr int kStages = 4;
constexpr int kConsumers = 128;  // a consumer warpgroup
constexpr int kProducers = 128;  // a producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kStageA = kBM * kKC * 2;  // bytes
constexpr int kMaxCluster = 4;  // CTAs a tile's groups are split over
constexpr size_t kMaxSmem = 232448;  // bytes a block may have on the H100
constexpr int kFM = 64;        // FMA tile: output rows a block
constexpr int kFN = 64;        //   output channels a block
constexpr int kFK = 16;        //   K entries a step
constexpr int kFThreads = 256;

// A's bytes a stage: the window rows' bf16 chunk, or for a split A (a dX:
// dY as the sum of two bf16 parts, hi and lo) both parts' chunks
__host__ __device__ constexpr int stage_a(bool split) {
  return (split ? 2 : 1) * kStageA;
}
template <int BN, bool SPLIT>
constexpr size_t wgmma_smem() {  // the stages, the barriers, 1 KB to align
  return 1024 + (size_t)kStages * (stage_a(SPLIT) + BN * kKC * 2) +
         16 * kStages;
}
// blocks an SM holds (shared memory and registers)
__host__ __device__ constexpr int min_blocks(int BN, bool split) {
  return BN == 128 ? (split ? 1 : 2) : (split ? 2 : 3);
}
static_assert(wgmma_smem<128, true>() <= kMaxSmem, "the stages fit a block");

// ---- Hopper pieces: mbarriers, bulk copies, clusters, wgmma

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], "
      "%1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Arrives on `bar` when the thread's earlier cp.async copies have landed
// (counted in the barrier's arrivals: noinc).
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits for the phase of `bar` with this parity to complete. A wait that
// never ends is a fault of the kernel: it traps (the launch fails) rather
// than hold the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2;\nselp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ float ld_cluster_f32(uint32_t local,
                                                uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote)
               : "memory");
  return v;
}

// A shared-memory matrix descriptor: K-major rows of 128 bytes, 128-byte
// swizzle, 8-row groups 1024 bytes apart (the tile's base 1024-aligned).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  static constexpr int kRegs = 32;
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static constexpr int kRegs = 16;
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static constexpr int kRegs = 64;
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
        "1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// Keeps the compiler from moving accumulator reads and writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The first group of CTA j of a cluster of cs: groups [g0(j), g0(j + 1)),
// and those groups as a mask.
__host__ __device__ inline int split_first(int j, int cs) {
  return (kGroups * j + cs - 1) / cs;
}
__device__ __forceinline__ unsigned split_mask(int j, int cs) {
  return ((1u << split_first(j + 1, cs)) - 1u) &
         ~((1u << split_first(j, cs)) - 1u);
}

// Bit g of the result: some row of [row0, row0 + rows) uses group g.
__device__ __forceinline__ unsigned used_groups(
    const unsigned char* __restrict__ masks,
    const unsigned char* __restrict__ patho, int64_t row0, int rows,
    int64_t N_out, unsigned* s_used) {
  if (threadIdx.x == 0) *s_used = 0u;
  __syncthreads();
  unsigned mine = 0u;
  for (int e = threadIdx.x; e < kGroups * rows; e += blockDim.x) {
    const int g = e / rows;
    const int64_t row = row0 + e % rows;
    if (row >= N_out) continue;
    if (window_used(masks, patho, g, row, N_out)) mine |= 1u << g;
  }
  if (mine) atomicOr(s_used, mine);
  __syncthreads();
  return *s_used;
}

// Features -> bf16 rows (N_in, Cin8); split: rows (N_in, 2 Cin8) of hi =
// bf16(x) then lo = bf16(x - hi) (hi + lo carries x to 2^-16 of itself:
// a dX's dY enters the products unrounded, as JAX's autodiff takes the
// cotangent). One thread a 16-byte piece (of hi and lo).
__global__ void grouped_features_kernel(const float* __restrict__ feats,
                                        __nv_bfloat16* __restrict__ xb,
                                        int64_t pieces, int Cin, int split) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pieces) return;
  if (!split) {
    to_bf16_piece(feats, xb, t, Cin);
    return;
  }
  const int C8 = round8(Cin), P = C8 / 8;
  const int64_t r = t / P;
  const int c0 = (int)(t - r * P) * 8;
  float hi[8], lo[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const float v = c0 + u < Cin ? feats[r * Cin + c0 + u] : 0.f;
    hi[u] = __bfloat162float(__float2bfloat16_rn(v));
    lo[u] = v - hi[u];  // exact in fp32
  }
  __nv_bfloat16* dst = xb + r * 2 * C8 + c0;
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3]),
                 pack_bf16(hi[4], hi[5]), pack_bf16(hi[6], hi[7]));
  *reinterpret_cast<uint4*>(dst + C8) =
      make_uint4(pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
                 pack_bf16(lo[4], lo[5]), pack_bf16(lo[6], lo[7]));
}

// The weight tiles: block (g, kc, nt) of BN x 64 bf16 at ((g nK + kc) nNT
// + nt) BN 64, its row n the K entries kc 64 + [0, 64) of channel nt BN +
// n, 16-byte piece j of the row at place j ^ (n % 8) (the 128-byte
// swizzle). K entry p Cin8 + c of group g is W[3 g + p][c] (tap order),
// zero past Cin, past K3 and past Cout; W is w (dx_taps 0), or for a
// backward's dX, w holding (27, Cout, Cin), W[k] = w[k]^T (dx_taps 1) or
// w[26 - k]^T (dx_taps 2). One thread a 16-byte piece.
__global__ void grouped_weight_tiles_kernel(const float* __restrict__ w,
                                            __nv_bfloat16* __restrict__ wt,
                                            int64_t pieces, int Cin,
                                            int Cout, int nK, int BN,
                                            int nNT, int dx_taps) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pieces) return;
  const int per_block = BN * (kKC / 8);
  const int64_t b = t / per_block;
  const int in = (int)(t - b * per_block), n = in >> 3, j = in & 7;
  const int nt = (int)(b % nNT), kc = (int)((b / nNT) % nK);
  const int g = (int)(b / ((int64_t)nNT * nK));
  const int Cin8 = round8(Cin), ng = nt * BN + n;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = kc * kKC + 8 * j + e, p = k / Cin8, c = k - p * Cin8;
    int tap = 3 * g + p;
    if (dx_taps == 2) tap = 26 - tap;
    const bool ok = p < 3 && c < Cin && ng < Cout;
    v[e] = !ok ? 0.f
           : dx_taps != 0 ? w[((int64_t)tap * Cout + ng) * Cin + c]
                          : w[((int64_t)tap * Cin + c) * Cout + ng];
  }
  *reinterpret_cast<uint4*>(wt + b * per_block * 8 + n * kKC +
                            ((j ^ (n & 7)) * 8)) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// The bf16 kernel on tiles of 64 rows x BN channels. blockIdx.x = tile cs
// + CTA rank, blockIdx.y = channel tile; clusters of cs CTAs along x.
// SPLIT: the input rows are hi | lo bf16 parts (grouped_features_kernel),
// each step's products hi's then lo's on the same weight tile.
template <typename IdxT, int BN, bool SPLIT>
__global__ void __launch_bounds__(kThreads, min_blocks(BN, SPLIT))
    grouped_wgmma_kernel(const __nv_bfloat16* __restrict__ xb,
                         const __nv_bfloat16* __restrict__ wt,
                         const IdxT* __restrict__ center,
                         const unsigned char* __restrict__ masks,
                         const unsigned char* __restrict__ patho,
                         const long long* __restrict__ worder,
                         const int* __restrict__ order,
                         const int* __restrict__ tiles,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int64_t N_in, int64_t N_out,
                         int Cin8, int Cout, int nK, int nNT, int cs,
                         int round_out) {
  constexpr int kA = stage_a(SPLIT);  // bytes
  constexpr int kStage = kA + BN * kKC * 2;
  constexpr int R = Wgmma<BN>::kRegs;
  const int xrow = SPLIT ? 2 * Cin8 : Cin8;  // bf16 an input row
  __shared__ int s_win[kGroups][3][kBM];  // window rows at K place p
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStage;  // full, then empty
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster_rank();
  const int64_t tile = blockIdx.x / cs;
  const int nt = blockIdx.y;
  const int64_t row0 = tile * kBM;
  const unsigned tmask = (unsigned)tiles[tile];
  const unsigned mine = tmask & split_mask(rank, cs);
  const int nsteps = __popc(mine) * nK;
  unsigned workers = 0u;  // the cluster's CTAs with groups of this tile
  for (int j = 0; j < cs; ++j)
    if (tmask & split_mask(j, cs)) workers |= 1u << j;
  const int writer = workers ? __ffs(workers) - 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, kProducers + 1);  // the producers' copies
                                                // + the bulk copy's tx
      mbar_init(bars + 8 * (kStages + s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;

  if (tid >= kConsumers) {
    // ---- producers: thread pt stages 16-byte piece j = pt % 8 of tile
    // rows pt / 8 + 16 i, i < 4 (a warp's copies are 4 whole 128-byte
    // rows). First every window row of this CTA's groups is found, in one
    // burst of independent loads, into s_win[gi] (gi: the group's place
    // in `mine`), so no group waits on its map reads.
    const int pt = tid - kConsumers, j = pt & 7, rb = pt >> 3;
    const int w0 = (int)worder[0], w1 = (int)worder[1];
    for (int e = pt; e < __popc(mine) * kBM; e += kProducers) {
      const int gi = e / kBM, r = e % kBM;
      unsigned m = mine;
      for (int q = 0; q < gi; ++q) m &= m - 1u;
      const int g = __ffs(m) - 1;
      int win[3] = {-1, -1, -1};
      if (row0 + r < N_out)
        window_rows(center, masks, patho, g, (int64_t)order[row0 + r], N_in,
                    N_out, win);
#pragma unroll
      for (int p = 0; p < 3; ++p) {  // the slot of tap 3 g + p
        const int sl = w0 == p ? 0 : w1 == p ? 1 : 2;
        s_win[gi][p][r] = sl == 0 ? win[0] : sl == 1 ? win[1] : win[2];
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
    unsigned left = mine;
    int g = -1, gi = -1, kc = nK;
    for (int step = 0; step < nsteps; ++step) {
      if (kc == nK) {  // the next group of this CTA's share
        g = __ffs(left) - 1;
        left &= left - 1u;
        ++gi;
        kc = 0;
      }
      const int s = step % kStages;
      const uint32_t full = bars + 8 * s, empty = bars + 8 * (kStages + s);
      mbar_wait(empty, ((step / kStages) & 1) ^ 1);
      const uint32_t sa = base + s * kStage;
      const int k = kc * kKC + 8 * j, p = k / Cin8, c = k - p * Cin8;
#pragma unroll
      for (int i = 0; i < kBM / 16; ++i) {
        const int r = rb + 16 * i;
        const int src = p < 3 ? s_win[gi][p][r] : -1;
        const __nv_bfloat16* x = xb + (int64_t)(src >= 0 ? src : 0) * xrow + c;
        const uint32_t dst = sa + r * 128 + ((j ^ (r & 7)) * 16);
        cp_async16(dst, src >= 0 ? (const void*)x : (const void*)xb,
                   src >= 0 ? 16 : 0);
        if (SPLIT)  // the lo part, one chunk further
          cp_async16(dst + kStageA,
                     src >= 0 ? (const void*)(x + Cin8) : (const void*)xb,
                     src >= 0 ? 16 : 0);
      }
      if (pt == 0) {
        constexpr uint32_t kBytes = BN * kKC * 2;
        mbar_arrive_expect_tx(full, kBytes);
        bulk_copy(sa + kA,
                  wt + (((int64_t)g * nK + kc) * nNT + nt) * (BN * kKC),
                  kBytes, full);
      }
      cp_async_arrive_noinc(full);
      ++kc;
    }
  } else {
    // ---- consumers: one warpgroup, 16 rows a warp
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % kStages;
      mbar_wait(bars + 8 * s, (step / kStages) & 1);
      __syncwarp();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t sa = base + s * kStage;
      const uint64_t da = sw128_desc(sa), db = sw128_desc(sa + kA);
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk)  // 32 bytes a k16 step
        Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
      if (SPLIT) {
        const uint64_t dl = sw128_desc(sa + kStageA);
#pragma unroll
        for (int kk = 0; kk < kKC / 16; ++kk)
          Wgmma<BN>::mma(acc, dl + 2 * kk, db + 2 * kk);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kStages + s));
    }
  }

  // ---- the partials meet in the first CTA with work (the writer), added
  // in CTA order; a CTA without groups of the tile adds exact zeros and is
  // left out, and where one CTA has them all it writes alone (every CTA
  // of the cluster reads the same tile mask, so all take the same branch)
  if (__popc(workers) > 1) {
    float* red = reinterpret_cast<float*>(smem_raw +
                                          (base - smem_u32(smem_raw)));
    if (rank != writer && nsteps > 0 && tid < kConsumers) {
#pragma unroll
      for (int i = 0; i < R; ++i) red[i * kConsumers + tid] = acc[i];
    }
    cluster_sync();
    if (rank == writer && tid < kConsumers) {
      for (int j = writer + 1; j < cs; ++j) {
        if (!((workers >> j) & 1u)) continue;
#pragma unroll
        for (int i = 0; i < R; ++i)
          acc[i] += ld_cluster_f32(base + 4u * (i * kConsumers + tid), j);
      }
    }
    cluster_sync();  // no CTA leaves while its partial is read
  }
  if (rank != writer || tid >= kConsumers) return;

  // ---- epilogue: D fragment i of thread (warp, lane): row 16 warp + lane
  // / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + warp * 16 + (lane >> 2) + 8 * h;
    if (r >= N_out) continue;
    float* dst = out + (int64_t)order[r] * Cout;
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const int col = nt * BN + 8 * q + 2 * (lane & 3);
      float v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
      if (bias != nullptr) {
        if (col < Cout) v0 += bias[col];
        if (col + 1 < Cout) v1 += bias[col + 1];
      }
      if (round_out) {  // a gradient, held in fp32 at bf16 precision
        v0 = __bfloat162float(__float2bfloat16_rn(v0));
        v1 = __bfloat162float(__float2bfloat16_rn(v1));
      }
      if (pairs && col + 1 < Cout) {
        *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
      } else {
        if (col < Cout) dst[col] = v0;
        if (col + 1 < Cout) dst[col + 1] = v1;
      }
    }
  }
}

// fp32 operands: 64 x 64 outputs a block, 4 x 4 a thread, steps of 16 K
// entries over (group, slot, input channel) in that order.
template <typename IdxT>
__global__ void __launch_bounds__(kFThreads)
    grouped_fma_kernel(const float* __restrict__ feats,
                       const float* __restrict__ w,
                       const IdxT* __restrict__ center,
                       const unsigned char* __restrict__ masks,
                       const unsigned char* __restrict__ patho,
                       const long long* __restrict__ worder,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int64_t N_in, int64_t N_out,
                       int Cin, int Cout, int dx_taps) {
  __shared__ float sA[kFK][kFM + 4];
  __shared__ __align__(16) float sB[kFK][kFN];
  __shared__ int s_win[3][kFM];
  __shared__ unsigned s_used;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t row0 = (int64_t)blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  const int K3 = 3 * Cin;
  const int w0 = (int)worder[0], w1 = (int)worder[1], w2 = (int)worder[2];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const unsigned used = used_groups(masks, patho, row0, kFM, N_out, &s_used);
  for (int g = 0; g < kGroups; ++g) {
    if (!((used >> g) & 1u)) continue;  // block-uniform
    __syncthreads();  // the previous group's windows are read
    if (tid < kFM) {
      int src[3] = {-1, -1, -1};
      if (row0 + tid < N_out)
        window_rows(center, masks, patho, g, row0 + tid, N_in, N_out, src);
#pragma unroll
      for (int s = 0; s < 3; ++s) s_win[s][tid] = src[s];
    }
    for (int k0 = 0; k0 < K3; k0 += kFK) {
      __syncthreads();  // windows written; the previous step is read
      for (int e = tid; e < kFM * kFK; e += kFThreads) {
        const int r = e >> 4, j = e & 15, k = k0 + j;
        const int s = k / Cin, c = k - s * Cin;
        const int src = k < K3 ? s_win[s][r] : -1;
        sA[j][r] = src >= 0 ? feats[(int64_t)src * Cin + c] : 0.f;
      }
      for (int e = tid; e < kFK * kFN; e += kFThreads) {
        const int j = e >> 6, n = e & 63, k = k0 + j;
        const int s = k / Cin, c = k - s * Cin;
        int tap = 3 * g + (s == 0 ? w0 : s == 1 ? w1 : w2);
        if (dx_taps == 2) tap = 26 - tap;
        sB[j][n] = (k < K3 && n0 + n < Cout)
                       ? w[dx_taps != 0
                               ? ((int64_t)tap * Cout + n0 + n) * Cin + c
                               : ((int64_t)tap * Cin + c) * Cout + n0 + n]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kFK; ++j) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sA[j][ty * 4 + i];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = sB[j][tx * 4 + q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], bv[q], acc[i][q]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + ty * 4 + i;
    if (row >= N_out) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + tx * 4 + q;
      if (col < Cout)
        out[row * Cout + col] = bias != nullptr ? acc[i][q] + bias[col]
                                                : acc[i][q];
    }
  }
}

inline int k_steps(int Cin) { return (3 * round8(Cin) + kKC - 1) / kKC; }

template <typename IdxT, int BN, bool SPLIT>
int launch_wgmma(const __nv_bfloat16* xb, const __nv_bfloat16* wt,
                 const IdxT* ctr, const unsigned char* masks,
                 const unsigned char* patho, const long long* worder,
                 const int* order, const int* tiles, const float* bias,
                 float* out, int64_t N_in, int64_t N_out, int Cin, int Cout,
                 int cs, int round_out, cudaStream_t st) {
  const size_t smem = wgmma_smem<BN, SPLIT>();
  auto kernel = grouped_wgmma_kernel<IdxT, BN, SPLIT>;
  int code = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (code != 0) return code;
  const int nK = k_steps(Cin);
  const int nNT = (Cout + BN - 1) / BN;
  const int64_t n_tiles = (N_out + kBM - 1) / kBM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_tiles * cs), (unsigned)nNT, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, xb, wt, ctr, masks, patho,
                                 worder, order, tiles, bias, out, N_in, N_out,
                                 round8(Cin), Cout, nK, nNT, cs, round_out);
}

template <typename IdxT, bool SPLIT>
int launch_cols(int tile_cols, const __nv_bfloat16* xb,
                const __nv_bfloat16* wt, const IdxT* ctr,
                const unsigned char* masks, const unsigned char* patho,
                const long long* worder, const int* order, const int* tiles,
                const float* bias, float* out, int64_t N_in, int64_t N_out,
                int Cin, int Cout, int cs, int round_out, cudaStream_t st) {
  if (tile_cols == 32)
    return launch_wgmma<IdxT, 32, SPLIT>(xb, wt, ctr, masks, patho, worder,
                                         order, tiles, bias, out, N_in, N_out,
                                         Cin, Cout, cs, round_out, st);
  if (tile_cols == 64)
    return launch_wgmma<IdxT, 64, SPLIT>(xb, wt, ctr, masks, patho, worder,
                                         order, tiles, bias, out, N_in, N_out,
                                         Cin, Cout, cs, round_out, st);
  return launch_wgmma<IdxT, 128, SPLIT>(xb, wt, ctr, masks, patho, worder,
                                        order, tiles, bias, out, N_in, N_out,
                                        Cin, Cout, cs, round_out, st);
}

template <typename IdxT>
int launch_grouped(const float* feats, const float* w, const void* center,
                   const unsigned char* masks, const unsigned char* patho,
                   const long long* worder, const int* order,
                   const int* tiles, const float* bias, void* xb,
                   const void* wt, float* out, int64_t N_in, int64_t N_out,
                   int Cin, int Cout, bool bf16, int tile_cols, int cluster,
                   int dx_taps, cudaStream_t st) {
  const IdxT* ctr = static_cast<const IdxT*>(center);
  if (!bf16) {
    dim3 grid((unsigned)((N_out + kFM - 1) / kFM), (Cout + kFN - 1) / kFN);
    grouped_fma_kernel<IdxT><<<grid, kFThreads, 0, st>>>(
        feats, w, ctr, masks, patho, worder, bias, out, N_in, N_out, Cin,
        Cout, dx_taps);
    return static_cast<int>(cudaGetLastError());
  }
  __nv_bfloat16* xh = static_cast<__nv_bfloat16*>(xb);
  const __nv_bfloat16* wh = static_cast<const __nv_bfloat16*>(wt);
  // a gradient: dY unrounded (hi + lo parts), the result rounded as
  // autograd through the operands' rounding gives it
  const int grad = dx_taps != 0;
  const int64_t px = N_in * (round8(Cin) / 8);
  if (px > 0)
    grouped_features_kernel<<<(unsigned)((px + 255) / 256), 256, 0, st>>>(
        feats, xh, px, Cin, grad);
  const int code =
      grad ? launch_cols<IdxT, true>(tile_cols, xh, wh, ctr, masks, patho,
                                     worder, order, tiles, bias, out, N_in,
                                     N_out, Cin, Cout, cluster, grad, st)
           : launch_cols<IdxT, false>(tile_cols, xh, wh, ctr, masks, patho,
                                      worder, order, tiles, bias, out, N_in,
                                      N_out, Cin, Cout, cluster, grad, st);
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 weight tiles of the grouped conv (see grouped_weight_tiles_kernel)
// from weights (27, Cin, Cout) f32 (dx_taps 0; 1 or 2: the weights (27,
// Cout, Cin) of the forward whose dX this conv is, each tap transposed,
// 2 also the taps reversed) into wt, 9 k_steps(Cin) ceil(Cout / BN) blocks
// of BN x 64 bf16 for channel tiles of BN (32, 64 or 128). One launch.
UMR_EXPORT int umr_grouped_weight_tiles(const float* w, void* wt, int Cin,
                                        int Cout, int BN, int dx_taps,
                                        void* stream) {
  if (Cin < 1 || Cout < 1 || dx_taps < 0 || dx_taps > 2 ||
      (BN != 32 && BN != 64 && BN != 128) ||
      3ll * round8(Cin) >= (1ll << 31) - kKC)
    return (int)cudaErrorInvalidValue;
  const int nK = k_steps(Cin);
  const int nNT = (Cout + BN - 1) / BN;
  const int64_t pieces = (int64_t)kGroups * nK * nNT * BN * (kKC / 8);
  grouped_weight_tiles_kernel<<<(unsigned)((pieces + 255) / 256), 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<__nv_bfloat16*>(wt), pieces, Cin, Cout, nK, BN, nNT,
      dx_taps);
  return static_cast<int>(cudaGetLastError());
}

// The grouped k=3 conv (see above). feats (N_in, Cin) f32, weights (27,
// Cin, Cout) f32, center (9, N_out) int32 (idx64 0) or int64 (idx64 1),
// masks (9, 3, N_out) and patho (9, N_out) bool bytes, worder (3,) int64,
// bias (Cout,) f32 or null -> out (N_out, Cout) f32. bf16 1: operands
// rounded to bf16: order (N_out,) int32 the rows in the map's order and
// tiles (ceil(N_out / 64),) int32 each 64-row tile's used groups
// (grouped_row_order.cu), wt the weight tiles (umr_grouped_weight_tiles,
// the same dx_taps and tile_cols), scratch xb (max(N_in, 1), round8(Cin))
// bf16 (twice as wide for a dX: dY's hi and lo parts), tiles of 64 rows x
// tile_cols (32, 64 or 128) channels, a tile's groups split over clusters
// of `cluster` CTAs (1 to 4; the wrapper's plan fixes both from Cin and
// Cout; the cluster sets the order of a row's sums); bf16 0: fp32
// operands (order, tiles, xb, wt, tile_cols, cluster unused). dx_taps 0:
// the conv; 1 or 2: a backward's dX, dY's conv over the adjoint map, with
// weights (27, Cout, Cin) of the forward read as each tap transposed (2:
// also the taps reversed, a self map's adjoint), and with bf16 dY not
// rounded (its hi and lo bf16 parts both multiplied) and the output
// rounded to bf16 (held in fp32).
UMR_EXPORT int umr_sparse_conv_grouped(
    const float* feats, const float* w, const void* center,
    const unsigned char* masks, const unsigned char* patho,
    const long long* worder, const int* order, const int* tiles,
    const float* bias, void* xb, const void* wt, float* out, long long N_in,
    long long N_out, int Cin, int Cout, int idx64, int bf16, int tile_cols,
    int cluster, int dx_taps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_in < 0 || N_out < 1 || N_in >= (1ll << 31) - 8 ||
      N_out >= (1ll << 31) - kBM || Cin < 1 || Cout < 1 ||
      3ll * round8(Cin) >= (1ll << 31) - kKC ||
      (Cout + kFN - 1) / kFN > 65535 || dx_taps < 0 || dx_taps > 2 ||
      (bf16 && (xb == nullptr || wt == nullptr || order == nullptr ||
                tiles == nullptr || cluster < 1 || cluster > kMaxCluster ||
                (tile_cols != 32 && tile_cols != 64 && tile_cols != 128) ||
                (N_out + kBM - 1) / kBM * kMaxCluster >= (1ll << 31))))
    return (int)cudaErrorInvalidValue;
  if (idx64)
    return launch_grouped<int64_t>(feats, w, center, masks, patho, worder,
                                   order, tiles, bias, xb, wt, out, N_in,
                                   N_out, Cin, Cout, bf16 != 0, tile_cols,
                                   cluster, dx_taps, st);
  return launch_grouped<int32_t>(feats, w, center, masks, patho, worder,
                                 order, tiles, bias, xb, wt, out, N_in, N_out,
                                 Cin, Cout, bf16 != 0, tile_cols, cluster,
                                 dx_taps, st);
}
