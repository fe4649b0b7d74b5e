// Per-tap sparse convolution (gather + product, summed over kernel taps):
//   out[i, :] = sum_k feats[nbr[k, i], :] @ w[k]
// (an index < 0 or >= N_in gives a zero row), fp32 sums, operands bf16
// (the main path) or fp32.
//
// Replaces: tools/exp_pallas_gather.py, conv_pallas_unroll (one program,
// taps unrolled, one write) -> umr_sparse_conv_rowtile_mma /
// umr_sparse_conv_cin1 (wrapper sparse_conv_rowtile), and
// conv_pallas_taps (grid over the taps, partial sums added into one
// output) -> umr_sparse_conv_tapsplit_mma (wrapper
// sparse_conv_tapsplit). Both compute umeregrobust_tpu/ops/sparse.py
// sparse_conv.
//
// Bound on the H100. The maps are sparse (0.6-40% of K x N_out entries
// valid on the main path), so the work is the valid entries, not the
// dense K x N_out x Cin x Cout. At bf16 every layer of the main path is
// bound by bytes: the deep k5 layers by their weights (conv6: 75 taps with
// entries of 125, 157 MB of fp32 weights for 286 entries), the k7 stem
// (one input channel) by its int64 map (90 MB), the k3 layers of
// conv_impl="scan" by their map, rows and output. The first port's FMA
// tile (kept below as the fp32 path) did 64 x 32 x TN FMAs per chunk of a
// tap whenever one of a 64-row tile's rows had an entry, re-read the map
// once per 32 reduction entries, and re-read every tap's fp32 weights per
// row tile: 1.1-7 ms a layer against 0.002-0.06 ms bounds.
//
// Design (bf16 operands):
//  - Entry lists (entries_kernel, shared by both): per tap the valid
//    (out_row, in_row) pairs in row order, counts per tap and per row
//    tile, each row's position: ballots and a one-warp scan, two passes
//    over (tap, 2048-row chunk) blocks. No host read.
//  - Tap-stationary (tap_gemm_kernel + sum_entries_kernel): a block owns
//    one tap and 64 output channels; a tap without entries returns before
//    reading anything, a tap with entries stages its weights once (16-byte
//    loads, 8 a thread in flight, rounded to bf16 in shared memory), then
//    gathers its entries 32 at a time and multiplies them with
//    mma.sync.m16n8k16 (bf16, fp32 sums): one fp32 row an entry to
//    scratch. mma.sync and not wgmma: a tap has 1-350 entries on the main
//    path, and a 16-row granule wastes less than wgmma's 64. A second
//    kernel adds each output row's entries in tap order (no atomics, two
//    launches give the same bits). Scratch holds K min(N_in, N_out) rows
//    (every entry of a map the port builds); an entry past it is computed
//    by the sum kernel itself.
//  - Output-stationary (rowtile_mma_kernel): a block owns 128 rows x 64
//    channels, walks only the taps with an entry in its tile (from the
//    lists' tile counts), steps through (tap, 32 input channels) with
//    step s + 2's loads in flight while step s multiplies, and keeps the
//    sums in registers until its one write. For the k3 layers of large
//    levels, whose tiles are dense with entries.
//  - One input channel (conv_cin1_kernel): the map read as it stands, 8
//    loads a thread in flight, 8 warps a block splitting the taps, their
//    partial sums added in warp order.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------
// The FMA tile of the first port: the fp32 path, and a yardstick at bf16.
// The tap axis and the input-channel axis are one reduction axis r = k *
// Cin + c over which the weights are a (K Cin, Cout) matrix; a block owns
// 64 output rows x TN channels (TN 32 or 64) and walks r 32 entries at a
// time (map entries of the chunk's taps to shared memory, a chunk without
// a valid index in the tile skipped, gathered A and weights staged, 4 x
// TN / 16 fp32 sums a thread). rowtile: the whole axis, one write;
// tapsplit: grid z splits the taps into S segments whose partials a
// second kernel adds in segment order.
constexpr int kTM = 64;        // output rows per block
constexpr int kTK = 32;        // reduction entries per stage
constexpr int kThreads = 256;  // 16 x 16: 4 rows x (TN / 16) columns each

__device__ __forceinline__ float round_operand(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Sums taps [tap_lo, tap_hi) for the block's tile into dst (N_out, Cout).
template <int TN, typename IdxT>
__device__ __forceinline__ void conv_tile(
    const float* __restrict__ feats, const float* __restrict__ w,
    const IdxT* __restrict__ nbr, float* __restrict__ dst, int N_in,
    int N_out, int Cin, int Cout, int tap_lo, int tap_hi, bool bf16) {
  constexpr int CN = TN / 16;
  __shared__ int s_idx[kTK][kTM];
  __shared__ float sA[kTM][kTK + 1];
  __shared__ __align__(16) float sW[kTK][TN];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTM;
  const int col0 = blockIdx.y * TN;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  const int r_hi = tap_hi * Cin;
  for (int r0 = tap_lo * Cin; r0 < r_hi; r0 += kTK) {
    const int r_end = min(r0 + kTK, r_hi);
    const int k_lo = r0 / Cin;
    const int ntaps = (r_end - 1) / Cin - k_lo + 1;
    // map entries of the chunk's taps for the tile's rows
    int any = 0;
    for (int e = tid; e < ntaps * kTM; e += kThreads) {
      const int t = e / kTM, m = e % kTM;
      const int row = row0 + m;
      int64_t src = -1;
      if (row < N_out) src = (int64_t)nbr[(int64_t)(k_lo + t) * N_out + row];
      const bool ok = src >= 0 && src < N_in;
      s_idx[t][m] = ok ? (int)src : -1;
      any |= ok ? 1 : 0;
    }
    if (!__syncthreads_or(any)) continue;  // block-uniform
    {  // gathered rows: a thread owns one reduction entry of the chunk
      const int j = tid % kTK;
      const int r = r0 + j;
      const bool in = r < r_end;
      const int k = in ? r / Cin : k_lo;
      const int c = r - k * Cin;
      const int t = k - k_lo;
      for (int m = tid / kTK; m < kTM; m += kThreads / kTK) {
        float v = 0.f;
        if (in) {
          const int src = s_idx[t][m];
          if (src >= 0) v = round_operand(feats[(int64_t)src * Cin + c], bf16);
        }
        sA[m][j] = v;
      }
    }
    for (int e = tid; e < kTK * TN; e += kThreads) {
      const int kk = e / TN, n = e % TN;
      const int r = r0 + kk, col = col0 + n;
      float v = 0.f;
      if (r < r_end && col < Cout)
        v = round_operand(w[(int64_t)r * Cout + col], bf16);
      sW[kk][n] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      float a[4], b[CN];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < CN; ++j) b[j] = sW[kk][tx * CN + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the next chunk's barrier (__syncthreads_or) comes before anything
    // overwrites sA or sW
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= N_out) continue;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int col = col0 + tx * CN + j;
      if (col < Cout) dst[(int64_t)row * Cout + col] = acc[i][j];
    }
  }
}

template <int TN, typename IdxT>
__global__ void __launch_bounds__(kThreads)
    conv_rowtile_kernel(const float* __restrict__ feats,
                        const float* __restrict__ w,
                        const IdxT* __restrict__ nbr, float* __restrict__ out,
                        int N_in, int N_out, int Cin, int Cout, int K,
                        int bf16) {
  conv_tile<TN, IdxT>(feats, w, nbr, out, N_in, N_out, Cin, Cout, 0, K,
                      bf16 != 0);
}

template <int TN, typename IdxT>
__global__ void __launch_bounds__(kThreads)
    conv_tapsplit_kernel(const float* __restrict__ feats,
                         const float* __restrict__ w,
                         const IdxT* __restrict__ nbr,
                         float* __restrict__ partial, int N_in, int N_out,
                         int Cin, int Cout, int K, int taps_per_seg,
                         int bf16) {
  const int seg = blockIdx.z;
  const int tap_lo = seg * taps_per_seg;
  const int tap_hi = min(K, tap_lo + taps_per_seg);
  conv_tile<TN, IdxT>(feats, w, nbr,
                      partial + (int64_t)seg * N_out * Cout, N_in, N_out, Cin,
                      Cout, tap_lo, tap_hi, bf16 != 0);
}

__global__ void sum_segments_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int64_t n,
                                    int S) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = partial[i];
  for (int s = 1; s < S; ++s) acc += partial[(int64_t)s * n + i];
  out[i] = acc;
}

template <int TN, typename IdxT>
void launch_rowtile(const float* feats, const float* w, const void* nbr,
                    float* out, int N_in, int N_out, int Cin, int Cout, int K,
                    int bf16, cudaStream_t st) {
  dim3 grid((N_out + kTM - 1) / kTM, (Cout + TN - 1) / TN);
  conv_rowtile_kernel<TN, IdxT><<<grid, kThreads, 0, st>>>(
      feats, w, static_cast<const IdxT*>(nbr), out, N_in, N_out, Cin, Cout, K,
      bf16);
}

template <int TN, typename IdxT>
void launch_tapsplit(const float* feats, const float* w, const void* nbr,
                     float* partial, int N_in, int N_out, int Cin, int Cout,
                     int K, int S, int taps_per_seg, int bf16,
                     cudaStream_t st) {
  dim3 grid((N_out + kTM - 1) / kTM, (Cout + TN - 1) / TN, S);
  conv_tapsplit_kernel<TN, IdxT><<<grid, kThreads, 0, st>>>(
      feats, w, static_cast<const IdxT*>(nbr), partial, N_in, N_out, Cin, Cout,
      K, taps_per_seg, bf16);
}

bool bad_shape(int N_in, int N_out, int Cin, int Cout, int K) {
  return N_in < 0 || N_out < 1 || Cin < 1 || Cout < 1 || K < 1 ||
         (int64_t)K * Cin >= (1ll << 31) - kTK ||
         (Cout + 31) / 32 > 65535;
}


// ---------------------------------------------------------------------
// Entry lists. Per tap k, the valid (out_row, in_row) pairs of the map in
// row order, at ent[k * N_out + e] for e < cnt[k]; pos[k * N_out + i] =
// k * N_out + e for the entry of row i, -1 where none (optional); and
// tile_start[k * (T + 1) + t] = the first e of tile t (rows
// [t * tile_rows, ...)), T = ceil(N_out / tile_rows), tile_start[.., T] =
// cnt[k] (optional). Two passes over blocks (tap, chunk of 2048 rows),
// 8 coalesced loads a thread in flight and a ballot a load: the first
// counts each chunk's entries, the second adds the counts of the tap's
// earlier chunks, scans its 64 (load, warp) counts with one warp and
// writes.
constexpr int kEntThreads = 256;
constexpr int kEntPer = 8;
constexpr int kEntChunk = kEntThreads * kEntPer;

__host__ __device__ inline int ent_chunks(int N_out) {
  return (N_out + kEntChunk - 1) / kEntChunk;
}

template <bool WRITE, typename IdxT>
__global__ void __launch_bounds__(kEntThreads)
    entries_kernel(const IdxT* __restrict__ nbr, int N_in, int N_out,
                   int tile_rows, int* __restrict__ chunk_cnt,
                   int2* __restrict__ ent, int* __restrict__ cnt,
                   int* __restrict__ tile_start, int* __restrict__ pos) {
  __shared__ int s_ex[kEntPer * 8];  // (load j, warp) -> exclusive prefix
  __shared__ int s_base, s_total;
  const int k = blockIdx.x, ch = blockIdx.y, nch = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base_k = (int64_t)k * N_out;
  const IdxT* __restrict__ row = nbr + base_k;
  const int r0 = ch * kEntChunk;
  int64_t src[kEntPer];
#pragma unroll
  for (int j = 0; j < kEntPer; ++j) {
    const int i = r0 + j * kEntThreads + tid;
    src[j] = i < N_out ? (int64_t)row[i] : -1;
  }
  unsigned m[kEntPer];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kEntPer; ++j) {
    m[j] = __ballot_sync(0xffffffffu, src[j] >= 0 && src[j] < N_in);
    mine += __popc(m[j]);
    if (WRITE && lane == 0) s_ex[j * 8 + warp] = __popc(m[j]);
  }
  if (!WRITE) {
    if (lane == 0) s_ex[warp] = mine;
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int q = 0; q < kEntThreads / 32; ++q) total += s_ex[q];
      chunk_cnt[(int64_t)k * nch + ch] = total;
    }
    return;
  }
  if (warp == 1 && lane == 0) {  // the tap's entries in earlier chunks
    int b = 0;
    for (int q = 0; q < ch; ++q) b += chunk_cnt[(int64_t)k * nch + q];
    s_base = b;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 64 counts in (j, warp) order
    const int v0 = s_ex[2 * lane], v1 = s_ex[2 * lane + 1];
    int inc = v0 + v1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    const int ex = inc - v0 - v1;
    s_ex[2 * lane] = ex;
    s_ex[2 * lane + 1] = ex + v0;
    if (lane == 31) s_total = inc;
  }
  __syncthreads();
  const int base = s_base;
  const unsigned below = (1u << lane) - 1u;
  const int n_tiles = (N_out + tile_rows - 1) / tile_rows;
  const int warps_a_tile = tile_rows / 32;
#pragma unroll
  for (int j = 0; j < kEntPer; ++j) {
    const int i = r0 + j * kEntThreads + tid;
    const int p = base + s_ex[j * 8 + warp] + __popc(m[j] & below);
    const bool ok = (m[j] >> lane) & 1u;
    if (ok) ent[base_k + p] = make_int2(i, (int)src[j]);
    if (pos != nullptr && i < N_out)
      pos[base_k + i] = ok ? (int)(base_k + p) : -1;
    if (tile_start != nullptr && lane == 0 && warp % warps_a_tile == 0) {
      const int t = (r0 + j * kEntThreads + warp * 32) / tile_rows;
      if (t < n_tiles)
        tile_start[(int64_t)k * (n_tiles + 1) + t] = base + s_ex[j * 8 + warp];
    }
  }
  if (tid == 0 && ch == nch - 1) {
    cnt[k] = base + s_total;
    if (tile_start != nullptr)
      tile_start[(int64_t)k * (n_tiles + 1) + n_tiles] = base + s_total;
  }
}

// chunk_cnt: K ent_chunks(N_out) int32 of scratch
template <typename IdxT>
void launch_entries(const void* nbr, int N_in, int N_out, int K,
                    int tile_rows, int* chunk_cnt, int2* ent, int* cnt,
                    int* tile_start, int* pos, cudaStream_t st) {
  const dim3 grid(K, ent_chunks(N_out));
  const IdxT* map = static_cast<const IdxT*>(nbr);
  entries_kernel<false, IdxT><<<grid, kEntThreads, 0, st>>>(
      map, N_in, N_out, tile_rows, chunk_cnt, ent, cnt, tile_start, pos);
  entries_kernel<true, IdxT><<<grid, kEntThreads, 0, st>>>(
      map, N_in, N_out, tile_rows, chunk_cnt, ent, cnt, tile_start, pos);
}

// ---------------------------------------------------------------------
// Tensor-core pieces: mma.sync m16n8k16, bf16 operands, fp32 sums.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) first
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kMmaThreads = 512;  // 16 warps: 16 entries x 8 channels each
constexpr int kTNm = 64;          // output channels a block
constexpr int kME = 32;           // entries a tile (two m16 slices)
constexpr int kLdB = kTNm + 8;    // bf16 a weight row in shared (144 B)
constexpr int kBatch = 8;         // 16-byte loads a thread in flight
constexpr int kMaxCin16 = 1104;   // shared memory: weights + one A tile

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

__host__ inline size_t mma_smem_bytes(int Cin) {
  const int c16 = round16(Cin);
  return (size_t)c16 * kLdB * 2 + (size_t)kME * (c16 + 8) * 2 + kME * 4;
}

// sB[c][n] = bf16(wk[c][n0 + n]) for c < Cin, n0 + n < Cout, else 0;
// rows up to Cin16. wk is one tap's (Cin, Cout) slice.
__device__ __forceinline__ void stage_weights(const float* __restrict__ wk,
                                              __nv_bfloat16* sB, int Cin,
                                              int Cin16, int Cout, int n0) {
  const int tid = threadIdx.x;
  if ((Cout & 3) == 0) {
    constexpr int G = kTNm / 4;  // float4 groups a row
    const int total = Cin16 * G;
    for (int g0 = tid; g0 < total; g0 += kMmaThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + u * kMmaThreads;
        const int c = g / G, q = (g % G) * 4;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < total && c < Cin && n0 + q < Cout)
          v[u] = __ldg(reinterpret_cast<const float4*>(
              wk + (int64_t)c * Cout + n0 + q));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + u * kMmaThreads;
        if (g < total) {
          const int c = g / G, q = (g % G) * 4;
          *reinterpret_cast<uint2*>(sB + c * kLdB + q) = make_uint2(
              pack_bf16(v[u].x, v[u].y), pack_bf16(v[u].z, v[u].w));
        }
      }
    }
  } else {
    for (int e = tid; e < Cin16 * kTNm; e += kMmaThreads) {
      const int c = e / kTNm, n = e % kTNm;
      const float v = (c < Cin && n0 + n < Cout)
                          ? __ldg(wk + (int64_t)c * Cout + n0 + n) : 0.f;
      sB[c * kLdB + n] = __float2bfloat16_rn(v);
    }
  }
}

// sA[r][c] = bf16(feats[src[r]][c]) for c < Cin (zero row where src < 0);
// the pad columns Cin..Cin16 are left as they are.
template <int ROWS, int THREADS>
__device__ __forceinline__ void gather_rows_bf16(
    const float* __restrict__ feats, const int* s_src,
    __nv_bfloat16* sA, int ldA, int Cin) {
  const int tid = threadIdx.x;
  if ((Cin & 3) == 0) {
    const int G = Cin / 4;
    const int total = ROWS * G;
    for (int g0 = tid; g0 < total; g0 += THREADS * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + u * THREADS;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < total) {
          const int r = g / G, q = (g % G) * 4;
          const int src = s_src[r];
          if (src >= 0)
            v[u] = __ldg(reinterpret_cast<const float4*>(
                feats + (int64_t)src * Cin + q));
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = g0 + u * THREADS;
        if (g < total) {
          const int r = g / G, q = (g % G) * 4;
          *reinterpret_cast<uint2*>(sA + r * ldA + q) = make_uint2(
              pack_bf16(v[u].x, v[u].y), pack_bf16(v[u].z, v[u].w));
        }
      }
    }
  } else {
    for (int e = tid; e < ROWS * Cin; e += THREADS) {
      const int r = e / Cin, c = e % Cin;
      const int src = s_src[r];
      sA[r * ldA + c] = __float2bfloat16_rn(
          src >= 0 ? __ldg(feats + (int64_t)src * Cin + c) : 0.f);
    }
  }
}

// Exclusive prefix of the taps' entry counts: scratch row of entry e of
// tap k = pref[k] + e. The block's threads all get sum(cnt[0..k)).
__device__ __forceinline__ int tap_prefix(const int* __restrict__ cnt,
                                          int k) {
  __shared__ int s_red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = 0;
  for (int j = threadIdx.x; j < k; j += blockDim.x) v += cnt[j];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  int total = 0;
  for (int q = 0; q < (int)(blockDim.x >> 5); ++q) total += s_red[q];
  __syncthreads();  // s_red may be reused
  return total;
}

// Tap-stationary gather-GEMM. Block (k, channel tile, z): tap k's
// weights for 64 output channels go to shared memory once, then the
// block takes every gridDim.z-th tile of 32 of the tap's entries: gather
// the 32 feature rows (bf16), one m16n8k16 product a warp (16 entries x 8
// channels) and 16-deep step, a slice with no entry skipped, one fp32 row
// an entry to scratch row pref[k] + e. Entries past cap_rows get no
// scratch row (the sum kernel computes them itself). At most 64 registers
// a thread, so that two blocks fit an SM where shared memory allows.
__global__ void __launch_bounds__(kMmaThreads, 2)
    tap_gemm_kernel(const float* __restrict__ feats,
                    const float* __restrict__ w,
                    const int2* __restrict__ ent,
                    const int* __restrict__ cnt,
                    float* __restrict__ scratch, int N_out, int Cin,
                    int Cout, int64_t cap_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = blockIdx.x;
  const int n = cnt[k];
  if ((int)blockIdx.z * kME >= n) return;  // a tap without entries: no read
  const int64_t pref = tap_prefix(cnt, k);
  const int64_t room = cap_rows > pref ? cap_rows - pref : 0;
  const int n_rows = room < n ? (int)room : n;
  if ((int)blockIdx.z * kME >= n_rows) return;
  const int Cin16 = round16(Cin);
  const int ldA = Cin16 + 8;
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sA = sB + (size_t)Cin16 * kLdB;
  int* s_src = reinterpret_cast<int*>(sA + (size_t)kME * ldA);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * kTNm;
  const int64_t base = (int64_t)k * N_out;

  stage_weights(w + (int64_t)k * Cin * Cout, sB, Cin, Cin16, Cout, n0);
  for (int e = tid; e < kME * (Cin16 - Cin); e += kMmaThreads) {
    const int r = e / (Cin16 - Cin), c = Cin + e % (Cin16 - Cin);
    sA[r * ldA + c] = __float2bfloat16_rn(0.f);
  }
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int nw = (warp % (kTNm / 8)) * 8, mt = warp / (kTNm / 8);
  const bool active = n0 + nw < Cout;
  const uint32_t a_addr = smem_u32(sA + (mt * 16 + a_row) * ldA + a_col);
  const uint32_t b_addr = smem_u32(sB + (lane & 15) * kLdB + nw);
  const int g = lane >> 2, t = lane & 3;
  const int col = n0 + nw + 2 * t;

  for (int e0 = blockIdx.z * kME; e0 < n_rows; e0 += kME * gridDim.z) {
    if (tid < kME)
      s_src[tid] = e0 + tid < n_rows ? ent[base + e0 + tid].y : -1;
    __syncthreads();
    gather_rows_bf16<kME, kMmaThreads>(feats, s_src, sA, ldA, Cin);
    __syncthreads();
    if (active && e0 + mt * 16 < n_rows) {
      float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
      int kk = 0;
      for (; kk + 32 <= Cin16; kk += 32) {  // two chains for ILP
        uint32_t a[4], b[2], a2[4], b2[2];
        ldsm_x4(a, a_addr + kk * 2);
        ldsm_x2_trans(b, b_addr + kk * kLdB * 2);
        ldsm_x4(a2, a_addr + (kk + 16) * 2);
        ldsm_x2_trans(b2, b_addr + (kk + 16) * kLdB * 2);
        mma_bf16(acc0, a, b);
        mma_bf16(acc1, a2, b2);
      }
      if (kk < Cin16) {
        uint32_t a[4], b[2];
        ldsm_x4(a, a_addr + kk * 2);
        ldsm_x2_trans(b, b_addr + kk * kLdB * 2);
        mma_bf16(acc0, a, b);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = e0 + mt * 16 + g + 8 * h;
        if (e >= n_rows) continue;
        float* dst = scratch + (pref + e) * Cout;
        if (col < Cout) dst[col] = acc0[2 * h] + acc1[2 * h];
        if (col + 1 < Cout) dst[col + 1] = acc0[2 * h + 1] + acc1[2 * h + 1];
      }
    }
    __syncthreads();  // s_src and sA are rewritten by the next tile
  }
}

// out[i] = sum over taps k in order of tap k's product for row i (zero
// where row i has no entry in tap k). Block (8 rows, up to 256 output
// channels): warp r lists row i0 + r's scratch rows in tap order (a
// ballot over 32 taps at a time), then each thread adds its channel of
// the listed rows, row by row. An entry without a scratch row (past
// cap_rows: only a map that hits one input row twice in a tap can have
// one) is computed here, one fp32 dot product of bf16-rounded operands.
constexpr int kSumRows = 8;
constexpr int kSumMaxK = 1536;  // 60 KB of offsets and lists

// Tap k's product for entry p = k * N_out + e, channel c, computed here.
__device__ __noinline__ float entry_product(const float* __restrict__ feats,
                                            const float* __restrict__ w,
                                            const int2* __restrict__ ent,
                                            int p, int N_out, int Cin,
                                            int Cout, int c) {
  const int k = p / N_out;
  const float* f = feats + (int64_t)ent[p].y * Cin;
  const float* wk = w + (int64_t)k * Cin * Cout + c;
  float d = 0.f;
  for (int q = 0; q < Cin; ++q)
    d = fmaf(round_operand(f[q], true),
             round_operand(wk[(int64_t)q * Cout], true), d);
  return d;
}

__global__ void __launch_bounds__(256)
    sum_entries_kernel(const float* __restrict__ scratch,
                       const int* __restrict__ pos,
                       const int* __restrict__ cnt,
                       const int2* __restrict__ ent,
                       const float* __restrict__ feats,
                       const float* __restrict__ w, float* __restrict__ out,
                       int N_out, int Cin, int Cout, int K,
                       int64_t cap_rows) {
  extern __shared__ __align__(16) int s_sum[];
  int64_t* s_pref = reinterpret_cast<int64_t*>(s_sum);  // [K]
  int* s_list = s_sum + 2 * K;                          // [kSumRows][K]
  __shared__ int s_len[kSumRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * kSumRows;
  if (warp == 0) {  // exclusive scan of cnt over the taps
    int64_t carry = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const int64_t v = k < K ? cnt[k] : 0;
      int64_t inc = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t o = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += o;
      }
      if (k < K) s_pref[k] = carry + inc - v;
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  __syncthreads();
  {  // warp r: row i0 + r's entries in tap order
    const int i = i0 + warp;
    const unsigned below = (1u << lane) - 1u;
    int m = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const int p = (i < N_out && k < K) ? pos[(int64_t)k * N_out + i] : -1;
      const unsigned b = __ballot_sync(0xffffffffu, p >= 0);
      if (p >= 0) {
        const int64_t row = s_pref[k] + (p - (int64_t)k * N_out);
        s_list[warp * K + m + __popc(b & below)] =
            row < cap_rows ? (int)row : -2 - p;
      }
      m += __popc(b);
    }
    if (lane == 0) s_len[warp] = m;
  }
  __syncthreads();
  // thread -> (channel c, row group): cb channels a block, 256 / cb rows
  // at a time
  const int cb = Cout >= 256 ? 256 : ((Cout + 31) & ~31);
  const int c = blockIdx.y * cb + tid % cb;
  if (tid >= (256 / cb) * cb || c >= Cout) return;
  for (int r = tid / cb; r < kSumRows && i0 + r < N_out; r += 256 / cb) {
    const int* L = s_list + r * K;
    const int len = s_len[r];
    float acc = 0.f;
    for (int j0 = 0; j0 < len; j0 += 8) {  // 8 reads in flight, added in order
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + u;
        v[u] = 0.f;
        if (j < len) {
          const int x = L[j];
          v[u] = x >= 0 ? scratch[(int64_t)x * Cout + c]
                        : entry_product(feats, w, ent, -2 - x, N_out, Cin,
                                        Cout, c);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u < len) acc += v[u];
    }
    out[(int64_t)(i0 + r) * Cout + c] = acc;
  }
}

__host__ inline size_t sum_smem_bytes(int K) {
  return (size_t)K * 8 + (size_t)kSumRows * K * 4;
}

// ---------------------------------------------------------------------
// Output-stationary row tile with tensor cores. Block (row tile of 128,
// channel tile of 64): the taps with an entry in the tile (from the entry
// lists' tile_start, in tap order, up to kRActMax at a time) and their
// 128 map entries go to shared memory once; then steps of (tap, 32 input
// channels): the step's gathered rows (bf16, zero rows where the tap has
// no entry) and weights are staged through a double buffer, step s + 2's
// global loads are issued before step s multiplies, and the fp32 sums of
// the 128 x 64 tile stay in registers (a warp: 32 rows x 32 channels)
// until the one write. A 16-row slice with no entry in the tap is
// skipped. 128 rows a tile halve the weight reads from L2 of 64 (each
// tile reads every active tap's weights once).
constexpr int kRTM = 128;
constexpr int kRTN = 64;
constexpr int kRKC = 32;
constexpr int kRActMax = 32;
constexpr int kRLdA = kRKC + 8;  // 80-byte rows
constexpr int kRLdB = kRTN + 8;  // 144-byte rows
constexpr int kRA = kRTM * kRKC / 256;  // A values a thread a step
constexpr int kRB = kRKC * kRTN / 256;  // B values a thread a step

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <typename IdxT>
__global__ void __launch_bounds__(256)
    rowtile_mma_kernel(const float* __restrict__ feats,
                       const float* __restrict__ w,
                       const IdxT* __restrict__ nbr,
                       const int* __restrict__ tile_start,
                       float* __restrict__ out, int N_in, int N_out, int Cin,
                       int Cout, int K) {
  __shared__ int s_act[kRActMax];
  __shared__ unsigned s_mt[kRActMax];
  __shared__ int s_src[kRActMax][kRTM];
  __shared__ __align__(16) __nv_bfloat16 sA[2][kRTM][kRLdA];
  __shared__ __align__(16) __nv_bfloat16 sB[2][kRKC][kRLdB];
  __shared__ int s_nact, s_knext;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x, row0 = t * kRTM, n0 = blockIdx.y * kRTN;
  const int T1 = (N_out + kRTM - 1) / kRTM + 1;
  const int nchunk = (Cin + kRKC - 1) / kRKC;
  const bool vecA = (Cin & 3) == 0, vecB = (Cout & 3) == 0;
  const int wm = warp & 3, wn = warp >> 2;  // 32 rows x 32 channels a warp
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  // two register sets: step s + 2's global loads are issued before step
  // s multiplies, step s + 1's sit in registers until they are stored
  float ra0[kRA], rb0[kRB], ra1[kRA], rb1[kRB];

  // global loads of step s into ra / rb (zero outside the operands)
  auto load = [&](int s, float (&ra)[kRA], float (&rb)[kRB]) {
    const int j = s / nchunk, c0 = (s % nchunk) * kRKC, k = s_act[j];
    if (vecA) {
#pragma unroll
      for (int u = 0; u < kRA / 4; ++u) {
        const int g = tid + u * 256, r = g >> 3, q = (g & 7) * 4;
        const int src = s_src[j][r];
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (src >= 0 && c0 + q < Cin)
          v = __ldg(reinterpret_cast<const float4*>(
              feats + (int64_t)src * Cin + c0 + q));
        ra[4 * u] = v.x; ra[4 * u + 1] = v.y;
        ra[4 * u + 2] = v.z; ra[4 * u + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRA; ++u) {
        const int g = tid + u * 256, r = g >> 5, q = g & 31;
        const int src = s_src[j][r];
        ra[u] = (src >= 0 && c0 + q < Cin)
                    ? __ldg(feats + (int64_t)src * Cin + c0 + q) : 0.f;
      }
    }
    const float* wk = w + ((int64_t)k * Cin + c0) * Cout + n0;
    if (vecB) {
#pragma unroll
      for (int u = 0; u < kRB / 4; ++u) {
        const int g = tid + u * 256, kr = g >> 4, q = (g & 15) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + kr < Cin && n0 + q < Cout)
          v = __ldg(reinterpret_cast<const float4*>(wk + (int64_t)kr * Cout + q));
        rb[4 * u] = v.x; rb[4 * u + 1] = v.y;
        rb[4 * u + 2] = v.z; rb[4 * u + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRB; ++u) {
        const int g = tid + u * 256, kr = g >> 6, q = g & 63;
        rb[u] = (c0 + kr < Cin && n0 + q < Cout)
                    ? __ldg(wk + (int64_t)kr * Cout + q) : 0.f;
      }
    }
  };
  // ra / rb -> shared buffer b, rounded to bf16
  auto store = [&](int b, const float (&ra)[kRA], const float (&rb)[kRB]) {
    if (vecA) {
#pragma unroll
      for (int u = 0; u < kRA / 4; ++u) {
        const int g = tid + u * 256, r = g >> 3, q = (g & 7) * 4;
        *reinterpret_cast<uint2*>(&sA[b][r][q]) = make_uint2(
            pack_bf16(ra[4 * u], ra[4 * u + 1]),
            pack_bf16(ra[4 * u + 2], ra[4 * u + 3]));
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRA; ++u) {
        const int g = tid + u * 256;
        sA[b][g >> 5][g & 31] = __float2bfloat16_rn(ra[u]);
      }
    }
    if (vecB) {
#pragma unroll
      for (int u = 0; u < kRB / 4; ++u) {
        const int g = tid + u * 256, kr = g >> 4, q = (g & 15) * 4;
        *reinterpret_cast<uint2*>(&sB[b][kr][q]) = make_uint2(
            pack_bf16(rb[4 * u], rb[4 * u + 1]),
            pack_bf16(rb[4 * u + 2], rb[4 * u + 3]));
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRB; ++u) {
        const int g = tid + u * 256;
        sB[b][g >> 6][g & 63] = __float2bfloat16_rn(rb[u]);
      }
    }
  };
  // the products of the step in shared buffer b (tap s / nchunk); a
  // warp skips its 16-row slices without an entry in the tap
  auto multiply = [&](int b, int s) {
    const unsigned mt = s_mt[s / nchunk] >> (2 * wm);
    if (!(mt & 3u)) return;
#pragma unroll
    for (int kk = 0; kk < kRKC; kk += 16) {
      uint32_t bl[4], bh[4];  // channels wn * 32 + [0, 16) and [16, 32)
      ldsm_x4_trans(bl, smem_u32(&sB[b][kk + (lane & 15)]
                                    [wn * 32 + (lane >> 4) * 8]));
      ldsm_x4_trans(bh, smem_u32(&sB[b][kk + (lane & 15)]
                                    [wn * 32 + 16 + (lane >> 4) * 8]));
      const uint32_t b0[2] = {bl[0], bl[1]}, b1[2] = {bl[2], bl[3]};
      const uint32_t b2[2] = {bh[0], bh[1]}, b3[2] = {bh[2], bh[3]};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (!((mt >> mi) & 1u)) continue;
        uint32_t a[4];
        ldsm_x4(a, smem_u32(&sA[b][wm * 32 + mi * 16 + a_row][kk + a_col]));
        mma_bf16(acc[mi][0], a, b0);
        mma_bf16(acc[mi][1], a, b1);
        mma_bf16(acc[mi][2], a, b2);
        mma_bf16(acc[mi][3], a, b3);
      }
    }
  };

  int k_next = 0;
  while (k_next < K) {
    if (warp == 0) {  // the next taps with an entry in this tile, in
                      // order, 32 taps at a time while they fit
      int nact = 0, k = k_next;
      for (; k < K; k += 32) {
        const int kk = k + lane;
        const bool has = kk < K && tile_start[(int64_t)kk * T1 + t + 1] >
                                       tile_start[(int64_t)kk * T1 + t];
        const unsigned m = __ballot_sync(0xffffffffu, has);
        if (nact + __popc(m) > kRActMax) break;
        if ((m >> lane) & 1u) {
          const int slot = nact + __popc(m & ((1u << lane) - 1u));
          s_act[slot] = kk;
          s_mt[slot] = 0u;
        }
        nact += __popc(m);
      }
      if (lane == 0) {
        s_nact = nact;
        s_knext = min(k, K);
      }
    }
    __syncthreads();
    const int nact = s_nact;
    k_next = s_knext;
    for (int e = tid; e < nact * kRTM; e += 256) {
      const int j = e / kRTM, r = e % kRTM, row = row0 + r;
      int64_t src = -1;
      if (row < N_out) src = (int64_t)nbr[(int64_t)s_act[j] * N_out + row];
      const bool ok = src >= 0 && src < N_in;
      s_src[j][r] = ok ? (int)src : -1;
      if (ok) atomicOr(&s_mt[j], 1u << (r >> 4));
    }
    __syncthreads();
    const int S = nact * nchunk;
    if (S > 0) load(0, ra0, rb0);
    if (S > 1) load(1, ra1, rb1);
    if (S > 0) store(0, ra0, rb0);
    __syncthreads();
    for (int s = 0; s < S; s += 2) {
      if (s + 2 < S) load(s + 2, ra0, rb0);
      multiply(0, s);
      if (s + 1 < S) store(1, ra1, rb1);
      __syncthreads();
      if (s + 1 >= S) break;
      if (s + 3 < S) load(s + 3, ra1, rb1);
      multiply(1, s + 1);
      if (s + 2 < S) store(0, ra0, rb0);
      __syncthreads();
    }
  }
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * 32 + mi * 16 + g + 8 * h;
      if (row >= N_out) continue;
      float* dst = out + (int64_t)row * Cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * tq;
        if (col < Cout) dst[col] = acc[mi][ni][2 * h];
        if (col + 1 < Cout) dst[col + 1] = acc[mi][ni][2 * h + 1];
      }
    }
}

// ---------------------------------------------------------------------
// One input channel (the k7 stem): the reduction axis is the taps alone
// and the layer is bound by reading its map. A block owns 32 rows (a
// lane each) and splits the taps over its 8 warps (warp q takes taps q,
// q + 8, ...); a thread keeps 8 map loads in flight and issues the next
// 8 before it reads the features of these; the tap weights (bf16-
// rounded, CO columns, zero past Cout) sit in shared memory, whose space
// the 8 partial sums of each row take after the sweep, added in warp
// order.
constexpr int kC1Groups = 8;

__host__ inline size_t cin1_smem_bytes(int K, int CO) {
  const size_t w = (size_t)K * CO * 4, p = (size_t)kC1Groups * 32 * (CO + 1) * 4;
  return w > p ? w : p;
}

template <int CO, typename IdxT>
__global__ void __launch_bounds__(256)
    conv_cin1_kernel(const float* __restrict__ feats,
                     const float* __restrict__ w,
                     const IdxT* __restrict__ nbr, float* __restrict__ out,
                     int N_in, int N_out, int Cout, int K) {
  extern __shared__ __align__(16) float sm1[];
  float* sW = sm1;  // [K][CO]; after the sweep [kC1Groups][32][CO + 1]
  float* sP = sm1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < K * CO; e += 256) {
    const int k = e / CO, c = e % CO;
    sW[e] = c < Cout ? round_operand(w[(int64_t)k * Cout + c], true) : 0.f;
  }
  __syncthreads();
  const int i = blockIdx.x * 32 + lane;
  float acc[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) acc[c] = 0.f;
  constexpr int U = 8;  // map loads a thread in flight
  auto load_map = [&](int k0, int64_t (&src)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * kC1Groups;
      src[u] = (i < N_out && k < K) ? (int64_t)nbr[(int64_t)k * N_out + i]
                                    : -1;
    }
  };
  int64_t src[U], next[U];
  load_map(warp, src);
  for (int k0 = warp; k0 < K; k0 += kC1Groups * U) {
    if (k0 + kC1Groups * U < K) load_map(k0 + kC1Groups * U, next);
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = (src[u] >= 0 && src[u] < N_in)
                 ? round_operand(__ldg(feats + src[u]), true) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v[u] == 0.f) continue;  // adds nothing (and skips absent rows)
      const float4* wr =
          reinterpret_cast<const float4*>(sW + (k0 + u * kC1Groups) * CO);
#pragma unroll
      for (int c4 = 0; c4 < CO / 4; ++c4) {
        const float4 b = wr[c4];
        acc[4 * c4 + 0] = fmaf(v[u], b.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(v[u], b.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(v[u], b.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(v[u], b.w, acc[4 * c4 + 3]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) src[u] = next[u];
  }
  __syncthreads();  // every warp is done with sW: sP takes its place
#pragma unroll
  for (int c = 0; c < CO; ++c) sP[(warp * 32 + lane) * (CO + 1) + c] = acc[c];
  __syncthreads();
  for (int e = tid; e < 32 * CO; e += 256) {
    const int r = e / CO, c = e % CO;
    const int row = blockIdx.x * 32 + r;
    if (row >= N_out || c >= Cout) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kC1Groups; ++q) s += sP[(q * 32 + r) * (CO + 1) + c];
    out[(int64_t)row * Cout + c] = s;
  }
}

}  // namespace

// feats (N_in, Cin) f32, w (K, Cin, Cout) f32, nbr (K, N_out) int32 or
// int64 (idx64) -> out (N_out, Cout) f32. bf16: round both operands to
// bf16 before multiplying (sums stay fp32).
UMR_EXPORT int umr_sparse_conv_rowtile(const float* feats, const float* w,
                                       const void* nbr, float* out, int N_in,
                                       int N_out, int Cin, int Cout, int K,
                                       int idx64, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(N_in, N_out, Cin, Cout, K)) return (int)cudaErrorInvalidValue;
  if (Cout >= 64) {
    if (idx64) launch_rowtile<64, int64_t>(feats, w, nbr, out, N_in, N_out, Cin, Cout, K, bf16, st);
    else launch_rowtile<64, int32_t>(feats, w, nbr, out, N_in, N_out, Cin, Cout, K, bf16, st);
  } else {
    if (idx64) launch_rowtile<32, int64_t>(feats, w, nbr, out, N_in, N_out, Cin, Cout, K, bf16, st);
    else launch_rowtile<32, int32_t>(feats, w, nbr, out, N_in, N_out, Cin, Cout, K, bf16, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same function with the taps split into S segments of taps_per_seg
// (S = ceil(K / taps_per_seg) <= 65535). partial (S, N_out, Cout) f32 is
// caller-allocated scratch.
UMR_EXPORT int umr_sparse_conv_tapsplit(const float* feats, const float* w,
                                        const void* nbr, float* partial,
                                        float* out, int N_in, int N_out,
                                        int Cin, int Cout, int K, int S,
                                        int taps_per_seg, int idx64, int bf16,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(N_in, N_out, Cin, Cout, K) || S < 1 || S > 65535 ||
      taps_per_seg < 1 || (int64_t)S * taps_per_seg < K)
    return (int)cudaErrorInvalidValue;
  if (Cout >= 64) {
    if (idx64) launch_tapsplit<64, int64_t>(feats, w, nbr, partial, N_in, N_out, Cin, Cout, K, S, taps_per_seg, bf16, st);
    else launch_tapsplit<64, int32_t>(feats, w, nbr, partial, N_in, N_out, Cin, Cout, K, S, taps_per_seg, bf16, st);
  } else {
    if (idx64) launch_tapsplit<32, int64_t>(feats, w, nbr, partial, N_in, N_out, Cin, Cout, K, S, taps_per_seg, bf16, st);
    else launch_tapsplit<32, int32_t>(feats, w, nbr, partial, N_in, N_out, Cin, Cout, K, S, taps_per_seg, bf16, st);
  }
  const int64_t n = (int64_t)N_out * Cout;
  sum_segments_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(partial, out,
                                                                  n, S);
  return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr size_t kMaxSmem = 232448;  // bytes a block may have on the H100

bool entries_ok(int N_out, int K) {
  return N_out >= 1 && K >= 1 && (int64_t)K * N_out < (1ll << 31) &&
         ent_chunks(N_out) <= 65535;
}

template <typename Kern>
int set_smem(Kern kernel, size_t bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------
// Weight gradient (the backward of both conv paths; their input gradient
// is the forward conv over the inverted map, ops/cuda_conv.py):
//   dW[k] = sum over tap k's valid entries (o, i) of X[i]^T dY[o]
// (K, Cin, Cout) fp32; operands rounded to bf16 when the forward's were.
// Replaces: what JAX's autodiff makes of the gather convs of
// tools/exp_pallas_gather.py:74,107 (umeregrobust_tpu/ops/sparse.py
// sparse_conv's weight gradient).
// Bound on the H100: bytes at the main path's widths (each entry reads
// one row of X and one of dY, and makes Cin x Cout products: 64-1024 a
// byte at 32-512 channels in fp32 FMAs, ~20 needed to reach the 67
// TFLOP/s fp32 line only at the widest layers), and at the deep k5
// layers writing dW itself (up to 268 MB a layer). The first port's
// kernel, kept for fp32 operands (and as the yardstick at bf16; the
// bf16 kernels follow it). Simple design: a block
// owns one (tap, 32 input channels, 32 output channels) tile and walks
// its tap's entries (the forward's entry lists, row order) 64 at a time
// through shared memory, 4 sums a thread. With few taps and channel tiles
// for the card (the k3 layers of level 0) the entries of a tap are split
// into S contiguous segments over grid z, and a second kernel adds the
// segments' partial tiles in segment order: no atomics, so two launches
// give the same bits.
constexpr int kWT = 32;        // input and output channels of a tile
constexpr int kWE = 64;        // entries staged a step
constexpr int kWThreads = 256; // 8 x 32: 4 input channels x 1 output each

__global__ void __launch_bounds__(kWThreads)
wgrad_kernel(const float* __restrict__ X, const float* __restrict__ G,
             const int2* __restrict__ ent, const int* __restrict__ cnt,
             float* __restrict__ dst, int N_out, int Cin, int Cout, int K,
             int S, bool bf16) {
  __shared__ float xs[kWE][kWT + 1];
  __shared__ float gs[kWE][kWT + 1];
  const int k = blockIdx.x;
  const int ci0 = blockIdx.y * kWT;
  const int tiles_o = (Cout + kWT - 1) / kWT;
  const int co0 = (blockIdx.z % tiles_o) * kWT;
  const int seg = blockIdx.z / tiles_o;
  const int tid = threadIdx.x;
  const int tx = tid % kWT, ty = tid / kWT;  // ty: 0..7
  const int n = cnt[k];
  const int chunk = (n + S - 1) / S;
  const int e0 = min(n, seg * chunk), e1 = min(n, e0 + chunk);
  const int2* te = ent + (int64_t)k * N_out;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = e0; base < e1; base += kWE) {
    const int rows = min(kWE, e1 - base);
    __syncthreads();  // the previous step's tiles are read
    for (int idx = tid; idx < kWE * kWT; idx += kWThreads) {
      const int r = idx / kWT, c = idx % kWT;
      float xv = 0.f, gv = 0.f;
      if (r < rows) {
        const int2 oe = te[base + r];  // (out_row, in_row)
        if (ci0 + c < Cin) xv = X[(int64_t)oe.y * Cin + ci0 + c];
        if (co0 + c < Cout) gv = G[(int64_t)oe.x * Cout + co0 + c];
      }
      xs[r][c] = round_operand(xv, bf16);
      gs[r][c] = round_operand(gv, bf16);
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float g = gs[r][tx];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(xs[r][ty + 8 * j], g, acc[j]);
    }
  }
  if (co0 + tx >= Cout) return;
  float* d = dst + (int64_t)(S > 1 ? seg * K + k : k) * Cin * Cout;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ci = ci0 + ty + 8 * j;
    if (ci < Cin) d[(int64_t)ci * Cout + co0 + tx] = acc[j];
  }
}

// out[e] = sum over s in order of partial[s][e], e < n
__global__ void wgrad_sum_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, int64_t n, int S) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int q = 0; q < S; ++q) s += partial[(int64_t)q * n + e];
  out[e] = s;
}

// ---------------------------------------------------------------------
// Weight gradient with bf16 operands, redesigned for the H100. The first
// port's kernel above (kept: the fp32 path, and the yardstick at bf16)
// made fp32 FMAs on CUDA cores with five shared-memory loads for every
// four, and a 32 x 32 tile read every gathered X row Cout / 32 times and
// every dY row Cin / 32 times. Here each tap's (Cin x E_k)(E_k x Cout)
// product, whose long axis is the tap's entries, goes through the tensor
// cores:
//  - X and dY are rounded to bf16 once a call (to_bf16_rows_kernel, rows
//    zero-padded to a multiple of 8 channels: 16-byte row pieces), the
//    rounding the forward gives its operands, so every product is exact
//    and the sums stay fp32;
//  - a block owns (tap, 128 input channels, 128 output channels, entry
//    segment): each stage gathers 32 entries' X and dY row slices with
//    cp.async into shared memory (three stages in flight, the entry list
//    read one stage ahead), and 8 warps (2 x 4, 64 x 32 each) multiply
//    them with mma.sync.m16n8k16 (A = X^T by ldmatrix.trans from the
//    gathered rows, B = dY as in the forward), fp32 sums in registers
//    until one write of the tile. 128-channel tiles read a gathered row
//    Cout / 128 (X) or Cin / 128 (dY) times: 1-8 at ResUNet's widths.
//    mma.sync and not wgmma: the products are not what bounds a layer
//    (the deep layers' taps hold a handful of entries, the wide layers
//    are bound by writing dW, K Cin Cout fp32, the rest by gathering
//    rows), and mma.sync takes the staged rows as ldmatrix reads them,
//    with no warpgroup layout to build;
//  - the map's entry lists are built here (launch_entries, as the forward
//    kernels build theirs): keeping the forward's lists until the
//    backward saved ~0.11 ms of device time over ResUNet's 11 layers, in
//    a host-bound step of ~0.5 s, for ~0.2 GB of peak memory and a second
//    way to get them, so the lists are not kept;
//  - a tap without entries writes its zero tile without reading;
//  - with few (tap, tile) blocks for the card the entries are cut into S
//    contiguous segments whose partial tiles wgrad_sum_kernel adds in
//    segment order: no atomics, two launches give the same bits.
// One input channel (the stems, wgrad_cin1_kernel): a block takes a tile
// of output rows, stages each 32-row chunk of dY once, and its warps (16,
// a tap in 16 each) read the map's chunk for their taps, coalesced, the
// next 8 taps' entries in flight while these are added, and add x * dY[o]
// for the valid entries (a ballot, in row order) into per-(tap, channel)
// sums in registers (at most 64 registers a thread: two blocks of 512 an
// SM): every dY row is read once, the map once. The tiles' partials are
// added in tile order by wgrad_sum_kernel. Bound: reading the (K, N_out)
// map.
constexpr int kGM = 128;     // input channels a tile (rows of dW[k])
constexpr int kGN = 128;     // output channels a tile
constexpr int kGE = 32;      // entries a stage
constexpr int kGStages = 3;
constexpr int kGThreads = 256;
constexpr int kGLd = kGM + 8;  // bf16 a staged row (272 B: ldmatrix rows
                               // fall in distinct banks)
static_assert(kGM == kGN, "one staged row length serves X and dY");

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

__host__ inline size_t wgrad_mma_smem_bytes() {
  return (size_t)kGStages * 2 * kGE * kGLd * 2;
}

// y[r][c] = bf16(x[r][c]) for c < C, 0 for C <= c < round8(C), and the
// same of g into gy: one thread an 8-value (16-byte) piece, one launch
// for both operands.
__device__ __forceinline__ void to_bf16_piece(const float* __restrict__ x,
                                              __nv_bfloat16* __restrict__ y,
                                              int64_t t, int C) {
  const int C8 = round8(C), P = C8 / 8;
  const int64_t r = t / P;
  const int c0 = (int)(t - r * P) * 8;
  const float* src = x + r * C;
  float v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) v[u] = c0 + u < C ? src[c0 + u] : 0.f;
  *reinterpret_cast<uint4*>(y + r * C8 + c0) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__global__ void to_bf16_rows_kernel(const float* __restrict__ x,
                                    __nv_bfloat16* __restrict__ xy,
                                    int64_t x_pieces, int Cx,
                                    const float* __restrict__ g,
                                    __nv_bfloat16* __restrict__ gy,
                                    int64_t g_pieces, int Cg) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < x_pieces) to_bf16_piece(x, xy, t, Cx);
  else if (t < x_pieces + g_pieces) to_bf16_piece(g, gy, t - x_pieces, Cg);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kGThreads, 2)
    wgrad_mma_kernel(const __nv_bfloat16* __restrict__ Xb,
                     const __nv_bfloat16* __restrict__ Gb,
                     const int2* __restrict__ ent,
                     const int* __restrict__ cnt, float* __restrict__ dst,
                     int N_out, int Cin, int Cout, int K, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  const int k = blockIdx.x;
  const int ci0 = blockIdx.y * kGM;
  const int tiles_n = (Cout + kGN - 1) / kGN;
  const int co0 = (blockIdx.z % tiles_n) * kGN;
  const int seg = blockIdx.z / tiles_n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Cin8 = round8(Cin), Cout8 = round8(Cout);
  const int n = cnt[k];
  const int chunk = (n + S - 1) / S;
  const int e0 = min(n, seg * chunk), e1 = min(n, e0 + chunk);
  const int nsteps = (e1 - e0 + kGE - 1) / kGE;
  const int2* te = ent + (int64_t)k * N_out;

  // staging: thread -> rows ra, ra + 16 of a stage, 16-byte piece pc
  const int ra = tid >> 4, pc = (tid & 15) * 8;
  const bool x_in = ci0 + pc < Cin8, g_in = co0 + pc < Cout8;
  auto load_ent = [&](int step, int2& a, int2& b) {
    const int base = e0 + step * kGE;
    a = make_int2(-1, -1);
    b = make_int2(-1, -1);
    if (step < nsteps) {
      if (base + ra < e1) a = te[base + ra];
      if (base + ra + 16 < e1) b = te[base + ra + 16];
    }
  };
  auto issue = [&](int step, int2 a, int2 b) {
    __nv_bfloat16* sx = sbuf + (size_t)(step % kGStages) * 2 * kGE * kGLd;
    __nv_bfloat16* sg = sx + kGE * kGLd;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int2 e = h ? b : a;  // (out_row, in_row)
      const int r = ra + 16 * h;
      const bool xv = x_in && e.y >= 0, gv = g_in && e.x >= 0;
      cp_async16(smem_u32(sx + r * kGLd + pc),
                 xv ? (const void*)(Xb + (int64_t)e.y * Cin8 + ci0 + pc)
                    : (const void*)Xb,
                 xv ? 16 : 0);
      cp_async16(smem_u32(sg + r * kGLd + pc),
                 gv ? (const void*)(Gb + (int64_t)e.x * Cout8 + co0 + pc)
                    : (const void*)Gb,
                 gv ? 16 : 0);
    }
  };

  const int wm = warp & 1, wn = warp >> 1;  // 64 input x 32 output channels
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  const int a_k = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int a_m = wm * 64 + ((lane >> 3) & 1) * 8;
  const int b_k = lane & 15;
  const int b_n = wn * 32 + (lane >> 4) * 8;

  int2 ea, eb;
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    load_ent(s, ea, eb);
    if (s < nsteps) issue(s, ea, eb);
    cp_async_commit();
  }
  load_ent(kGStages - 1, ea, eb);
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();  // stage `step` landed; stage step - 1 is read
    if (step + kGStages - 1 < nsteps) issue(step + kGStages - 1, ea, eb);
    cp_async_commit();
    load_ent(step + kGStages, ea, eb);
    const __nv_bfloat16* sx =
        sbuf + (size_t)(step % kGStages) * 2 * kGE * kGLd;
    const __nv_bfloat16* sg = sx + kGE * kGLd;
#pragma unroll
    for (int kk = 0; kk < kGE; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4_trans(a[mi], smem_u32(sx + (kk + a_k) * kGLd + a_m + mi * 16));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4_trans(r, smem_u32(sg + (kk + b_k) * kGLd + b_n + nj * 16));
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();  // nothing in flight when the block ends

  float* d = dst + (int64_t)(S > 1 ? seg * K + k : k) * Cin * Cout;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + wm * 64 + mi * 16 + g + 8 * h;
      if (ci >= Cin) continue;
      float* row = d + (int64_t)ci * Cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = co0 + wn * 32 + ni * 8 + 2 * t;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (pairs && co + 1 < Cout) {
          *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);
        } else {
          if (co < Cout) row[co] = v0;
          if (co + 1 < Cout) row[co + 1] = v1;
        }
      }
    }
}

constexpr int kW1Warps = 16;
constexpr int kW1TapsAWarp = 24;  // taps a warp at most: K <= 384

template <typename IdxT>
__global__ void __launch_bounds__(kW1Warps * 32, 2)
    wgrad_cin1_kernel(const float* __restrict__ X, const float* __restrict__ G,
                      const IdxT* __restrict__ nbr,
                      float* __restrict__ partial, int N_in, int N_out,
                      int Cout, int K, int rows_per_tile, bool bf16) {
  __shared__ float sG[32][33];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o_begin = blockIdx.x * rows_per_tile;
  const int o_end = min(N_out, o_begin + rows_per_tile);
  float acc[kW1TapsAWarp];
#pragma unroll
  for (int t = 0; t < kW1TapsAWarp; ++t) acc[t] = 0.f;
  for (int o0 = o_begin; o0 < o_end; o0 += 32) {
    __syncthreads();  // the previous chunk's dY rows are read
    for (int q = tid; q < 32 * 32; q += kW1Warps * 32) {
      const int r = q >> 5, c = q & 31;
      const int o = o0 + r;
      sG[r][c] = (o < o_end && c < Cout)
                     ? round_operand(G[(int64_t)o * Cout + c], bf16) : 0.f;
    }
    __syncthreads();
    const int o = o0 + lane;
    constexpr int U = 8;  // map loads a lane in flight
    // a map entry as a row of X, -1 where absent (narrowed to 32 bits)
    auto load_map = [&](int t0, int (&m)[U]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = warp + kW1Warps * (t0 + u);
        const int64_t v = (kk < K && o < o_end)
                              ? (int64_t)nbr[(int64_t)kk * N_out + o] : -1;
        m[u] = (v >= 0 && v < N_in) ? (int)v : -1;
      }
    };
    int m[U], next[U];
    load_map(0, m);
#pragma unroll
    for (int t0 = 0; t0 < kW1TapsAWarp; t0 += U) {
      if (warp + kW1Warps * t0 >= K) break;  // warp-uniform
      // the next taps' map loads go out before these taps' rows are read
      if (t0 + U < kW1TapsAWarp) load_map(t0 + U, next);
      float x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        x[u] = m[u] >= 0 ? round_operand(__ldg(X + m[u]), bf16) : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        unsigned vm = __ballot_sync(0xffffffffu, m[u] >= 0);
        while (vm) {  // the chunk's valid rows in row order
          const int j = __ffs(vm) - 1;
          vm &= vm - 1;
          acc[t0 + u] = fmaf(__shfl_sync(0xffffffffu, x[u], j), sG[j][lane],
                             acc[t0 + u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) m[u] = next[u];
    }
  }
  const int64_t n = (int64_t)K * Cout;
  float* dst = partial + (int64_t)blockIdx.x * n;
#pragma unroll
  for (int t = 0; t < kW1TapsAWarp; ++t) {
    const int kk = warp + kW1Warps * t;
    if (kk < K && lane < Cout) dst[(int64_t)kk * Cout + lane] = acc[t];
  }
}

}  // namespace

// The per-tap entry lists alone (see entries_kernel): ent (K, N_out, 2),
// cnt (K,), tile_start (K, ceil(N_out / tile_rows) + 1) or null, pos
// (K, N_out) or null, chunk_cnt (K ceil(N_out / 2048)) scratch; int32,
// caller-allocated. tile_rows 32, 64, 128 or 256.
UMR_EXPORT int umr_conv_entries(const void* nbr, int* ent, int* cnt,
                                int* tile_start, int* pos, int* chunk_cnt,
                                int N_in, int N_out, int K, int tile_rows,
                                int idx64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!entries_ok(N_out, K) || N_in < 0 ||
      (tile_rows != 32 && tile_rows != 64 && tile_rows != 128 &&
       tile_rows != 256))
    return (int)cudaErrorInvalidValue;
  int2* e = reinterpret_cast<int2*>(ent);
  if (idx64) launch_entries<int64_t>(nbr, N_in, N_out, K, tile_rows, chunk_cnt, e, cnt, tile_start, pos, st);
  else launch_entries<int32_t>(nbr, N_in, N_out, K, tile_rows, chunk_cnt, e, cnt, tile_start, pos, st);
  return static_cast<int>(cudaGetLastError());
}

// bf16 operands, tap-stationary: entry lists, the tensor-core product of
// each tap's entries (grid z = split: tiles of 32 entries dealt round
// robin), then the sum over taps in tap order. ints (3 K N_out + K +
// K ceil(N_out / 2048)) int32
// and scratch (cap_rows, Cout) f32 are caller-allocated; entries past
// cap_rows are computed by the sum kernel. Cin <= 1104, K <= 1536.
UMR_EXPORT int umr_sparse_conv_tapsplit_mma(
    const float* feats, const float* w, const void* nbr, int* ints,
    float* scratch, float* out, int N_in, int N_out, int Cin, int Cout,
    int K, int split, long long cap_rows, int idx64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(N_in, N_out, Cin, Cout, K) || !entries_ok(N_out, K) ||
      round16(Cin) > kMaxCin16 || K > kSumMaxK || split < 1 ||
      split > 65535 || (Cout + kTNm - 1) / kTNm > 65535 || cap_rows < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t KN = (int64_t)K * N_out;
  int2* ent = reinterpret_cast<int2*>(ints);
  int* pos = ints + 2 * KN;
  int* cnt = pos + KN;
  int* chunk_cnt = cnt + K;
  if (idx64) launch_entries<int64_t>(nbr, N_in, N_out, K, 32, chunk_cnt, ent, cnt, nullptr, pos, st);
  else launch_entries<int32_t>(nbr, N_in, N_out, K, 32, chunk_cnt, ent, cnt, nullptr, pos, st);
  const size_t smem = mma_smem_bytes(Cin);
  int code = set_smem(tap_gemm_kernel, smem);
  if (code != 0) return code;
  dim3 grid(K, (Cout + kTNm - 1) / kTNm, split);
  tap_gemm_kernel<<<grid, kMmaThreads, smem, st>>>(
      feats, w, ent, cnt, scratch, N_out, Cin, Cout, cap_rows);
  const size_t smem_sum = sum_smem_bytes(K);
  if ((code = set_smem(sum_entries_kernel, smem_sum)) != 0) return code;
  const int cb = Cout >= 256 ? 256 : ((Cout + 31) & ~31);
  dim3 grid_sum((N_out + kSumRows - 1) / kSumRows, (Cout + cb - 1) / cb);
  sum_entries_kernel<<<grid_sum, 256, smem_sum, st>>>(scratch, pos, cnt, ent, feats, w, out, N_out,
                             Cin, Cout, K, cap_rows);
  return static_cast<int>(cudaGetLastError());
}

// bf16 operands and one input channel (the k7 stem): feats (N_in, 1),
// w (K, 1, Cout) with Cout <= 64.
UMR_EXPORT int umr_sparse_conv_cin1(const float* feats, const float* w,
                                    const void* nbr, float* out, int N_in,
                                    int N_out, int Cout, int K, int idx64,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(N_in, N_out, 1, Cout, K) || Cout > 64)
    return (int)cudaErrorInvalidValue;
  const int blocks = (N_out + 31) / 32;
  int code;
  if (Cout <= 32) {
    const size_t smem = cin1_smem_bytes(K, 32);
    if (idx64) {
      if ((code = set_smem(conv_cin1_kernel<32, int64_t>, smem))) return code;
      conv_cin1_kernel<32, int64_t><<<blocks, 256, smem, st>>>(feats, w, static_cast<const int64_t*>(nbr), out, N_in, N_out, Cout, K);
    } else {
      if ((code = set_smem(conv_cin1_kernel<32, int32_t>, smem))) return code;
      conv_cin1_kernel<32, int32_t><<<blocks, 256, smem, st>>>(feats, w, static_cast<const int32_t*>(nbr), out, N_in, N_out, Cout, K);
    }
  } else {
    const size_t smem = cin1_smem_bytes(K, 64);
    if (idx64) {
      if ((code = set_smem(conv_cin1_kernel<64, int64_t>, smem))) return code;
      conv_cin1_kernel<64, int64_t><<<blocks, 256, smem, st>>>(feats, w, static_cast<const int64_t*>(nbr), out, N_in, N_out, Cout, K);
    } else {
      if ((code = set_smem(conv_cin1_kernel<64, int32_t>, smem))) return code;
      conv_cin1_kernel<64, int32_t><<<blocks, 256, smem, st>>>(feats, w, static_cast<const int32_t*>(nbr), out, N_in, N_out, Cout, K);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 operands, output-stationary (see rowtile_mma_kernel): entry lists
// with 128-row tiles, then the row-tile kernel. ints (2 K N_out + K +
// K (ceil(N_out / 128) + 1) + K ceil(N_out / 2048)) int32
// caller-allocated.
UMR_EXPORT int umr_sparse_conv_rowtile_mma(const float* feats, const float* w,
                                           const void* nbr, int* ints,
                                           float* out, int N_in, int N_out,
                                           int Cin, int Cout, int K, int idx64,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(N_in, N_out, Cin, Cout, K) || !entries_ok(N_out, K) ||
      (Cout + kRTN - 1) / kRTN > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t KN = (int64_t)K * N_out;
  int2* ent = reinterpret_cast<int2*>(ints);
  int* cnt = ints + 2 * KN;
  int* tile_start = cnt + K;
  int* chunk_cnt = tile_start + (int64_t)K * ((N_out + kRTM - 1) / kRTM + 1);
  dim3 grid((N_out + kRTM - 1) / kRTM, (Cout + kRTN - 1) / kRTN);
  if (idx64) {
    launch_entries<int64_t>(nbr, N_in, N_out, K, kRTM, chunk_cnt, ent, cnt, tile_start, nullptr, st);
    rowtile_mma_kernel<int64_t><<<grid, 256, 0, st>>>(feats, w, static_cast<const int64_t*>(nbr), tile_start, out, N_in, N_out, Cin, Cout, K);
  } else {
    launch_entries<int32_t>(nbr, N_in, N_out, K, kRTM, chunk_cnt, ent, cnt, tile_start, nullptr, st);
    rowtile_mma_kernel<int32_t><<<grid, 256, 0, st>>>(feats, w, static_cast<const int32_t*>(nbr), tile_start, out, N_in, N_out, Cin, Cout, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// Weight gradient of the per-tap conv: X (N_in, Cin) and G = dY (N_out,
// Cout) f32, nbr (K, N_out) -> out (K, Cin, Cout) f32. ints (2 K N_out + K
// + K ceil(N_out / 2048)) int32 scratch for the entry lists; partial (S,
// K, Cin, Cout) f32 scratch when S > 1 (else null). bf16: round X and G to
// bf16 (the forward's operands); sums are fp32 either way.
UMR_EXPORT int umr_sparse_conv_wgrad(const float* X, const float* G,
                                     const void* nbr, int* ints,
                                     float* partial, float* out, int N_in,
                                     int N_out, int Cin, int Cout, int K,
                                     int S, int bf16, int idx64,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_o = (Cout + kWT - 1) / kWT;
  if (bad_shape(N_in, N_out, Cin, Cout, K) || !entries_ok(N_out, K) ||
      S < 1 || (S > 1 && partial == nullptr) || K > 65535 ||
      (Cin + kWT - 1) / kWT > 65535 || (int64_t)tiles_o * S > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t KN = (int64_t)K * N_out;
  int2* ent = reinterpret_cast<int2*>(ints);
  int* cnt = ints + 2 * KN;
  int* chunk_cnt = cnt + K;
  if (idx64) launch_entries<int64_t>(nbr, N_in, N_out, K, 32, chunk_cnt, ent, cnt, nullptr, nullptr, st);
  else launch_entries<int32_t>(nbr, N_in, N_out, K, 32, chunk_cnt, ent, cnt, nullptr, nullptr, st);
  dim3 grid(K, (Cin + kWT - 1) / kWT, tiles_o * S);
  wgrad_kernel<<<grid, kWThreads, 0, st>>>(X, G, ent, cnt,
                                           S > 1 ? partial : out, N_out, Cin,
                                           Cout, K, S, bf16 != 0);
  if (S > 1) {
    const int64_t n = KN / N_out * Cin * Cout;
    wgrad_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        partial, out, n, S);
  }
  return static_cast<int>(cudaGetLastError());
}

// Weight gradient at bf16 operands on the tensor cores (wgrad_mma_kernel):
// X (N_in, Cin) and G = dY (N_out, Cout) f32, nbr (K, N_out) -> out (K,
// Cin, Cout) f32. Scratch, caller-allocated: ints (2 K N_out + K + K
// ceil(N_out / 2048)) int32 for the entry lists; xb (N_in, round8(Cin))
// and gb (N_out, round8(Cout)) bf16; partial (S, K, Cin, Cout) f32 when
// S > 1 (else null).
UMR_EXPORT int umr_sparse_conv_wgrad_mma(const float* X, const float* G,
                                         const void* nbr, int* ints,
                                         void* xb, void* gb, float* partial,
                                         float* out, int N_in, int N_out,
                                         int Cin, int Cout, int K, int S,
                                         int idx64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_n = (Cout + kGN - 1) / kGN;
  if (bad_shape(N_in, N_out, Cin, Cout, K) || !entries_ok(N_out, K) ||
      S < 1 || (S > 1 && partial == nullptr) ||
      (Cin + kGM - 1) / kGM > 65535 || (int64_t)tiles_n * S > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t KN = (int64_t)K * N_out;
  int2* ent = reinterpret_cast<int2*>(ints);
  int* cnt = ints + 2 * KN;
  int* chunk_cnt = cnt + K;
  if (idx64) launch_entries<int64_t>(nbr, N_in, N_out, K, 32, chunk_cnt, ent, cnt, nullptr, nullptr, st);
  else launch_entries<int32_t>(nbr, N_in, N_out, K, 32, chunk_cnt, ent, cnt, nullptr, nullptr, st);
  __nv_bfloat16* xh = static_cast<__nv_bfloat16*>(xb);
  __nv_bfloat16* gh = static_cast<__nv_bfloat16*>(gb);
  const int64_t px = (int64_t)N_in * (round8(Cin) / 8);
  const int64_t pg = (int64_t)N_out * (round8(Cout) / 8);
  to_bf16_rows_kernel<<<(unsigned)((px + pg + 255) / 256), 256, 0, st>>>(
      X, xh, px, Cin, G, gh, pg, Cout);
  const size_t smem = wgrad_mma_smem_bytes();
  const int code = set_smem(wgrad_mma_kernel, smem);
  if (code != 0) return code;
  dim3 grid(K, (Cin + kGM - 1) / kGM, tiles_n * S);
  wgrad_mma_kernel<<<grid, kGThreads, smem, st>>>(
      xh, gh, ent, cnt, S > 1 ? partial : out, N_out, Cin, Cout, K, S);
  if (S > 1) {
    const int64_t n = (int64_t)K * Cin * Cout;
    wgrad_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        partial, out, n, S);
  }
  return static_cast<int>(cudaGetLastError());
}

// Weight gradient with one input channel (wgrad_cin1_kernel): X (N_in, 1),
// G (N_out, Cout <= 32), nbr (K <= 384, N_out) -> out (K, 1, Cout) f32;
// partial (ceil(N_out / rows_per_tile), K, Cout) f32 scratch;
// rows_per_tile a multiple of 32. bf16: operands rounded to bf16.
UMR_EXPORT int umr_sparse_conv_wgrad_cin1(const float* X, const float* G,
                                          const void* nbr, float* partial,
                                          float* out, int N_in, int N_out,
                                          int Cout, int K, int rows_per_tile,
                                          int bf16, int idx64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(N_in, N_out, 1, Cout, K) || Cout > 32 ||
      K > kW1Warps * kW1TapsAWarp || rows_per_tile < 32 ||
      rows_per_tile % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int T = (N_out + rows_per_tile - 1) / rows_per_tile;
  if (idx64)
    wgrad_cin1_kernel<int64_t><<<T, kW1Warps * 32, 0, st>>>(
        X, G, static_cast<const int64_t*>(nbr), partial, N_in, N_out, Cout,
        K, rows_per_tile, bf16 != 0);
  else
    wgrad_cin1_kernel<int32_t><<<T, kW1Warps * 32, 0, st>>>(
        X, G, static_cast<const int32_t*>(nbr), partial, N_in, N_out, Cout,
        K, rows_per_tile, bf16 != 0);
  const int64_t n = (int64_t)K * Cout;
  wgrad_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(partial, out,
                                                                n, T);
  return static_cast<int>(cudaGetLastError());
}
