// Radius-capped Cauchy kernel-correlation scores.
//
// Replaces: umeregrobust_tpu/ops/pallas_corr.py, corr_scores_fused.
//
// For each hypothesis h: sum_i sum_j 1[d2 <= (2 sigma)^2] / (1 + d2 /
// sigma^2) * <f_i, g_j>, with d2 = |T_h p_i - q_j|^2 (the caller passes
// the transformed source points and divides by N).
//
// Bound on the H100: operations, and of these the dense distance tests.
// Every (h, i, j) triple costs 8 rounded fp32 operations and a compare;
// the feature product <f_i, g_j> is 2C operations per (i, j), shared by
// all hypotheses, and on the main path under 1% of the triples are in
// radius and use it. The inputs are a few MB.
//
// Design. A thread owns one source row: its 32 features and its points
// under the block's 8 hypotheses stay in registers. A block of 256 source
// rows sweeps its targets, which stream through shared memory in tiles of
// 128 (xyz and features as float4).
//  - Load pipe: a step (the warp's 32 source rows against one target)
//    reads the target's point with one broadcast 16-byte shared load for
//    all 8 hypotheses, and its features with 8 more only when needed. The
//    first version of this redesign kept a target per thread and read the
//    source points from shared memory (8 + 8 such loads a step); this
//    tiling measured 3-10% faster at three of the four stage shapes.
//  - Skip: a step first computes the 8 distances and whether any is in
//    radius, then votes over the warp. Only a warp in which some lane has
//    some hypothesis in radius computes <f_i, g_j> and the weights; a lane
//    out of radius never used the product, so the skip is exact and the
//    branch is warp-uniform. Two targets go through the distance tests
//    together, each with its own vote. The vote fails more often when a
//    warp's 32 source rows are neighbours in space; the sum over i does
//    not depend on the rows' order, so that is the caller's layout to
//    choose (the main path's subsets are random: PERF.md, section 6).
//  - Fill: with few hypotheses the (source tile, hypothesis block) grid
//    is smaller than the card, so the target sweep is split over grid z,
//    one tile a block. The hypothesis loop is compiled for each count
//    1..8, so a block of fewer than 8 hypotheses tests no padding (the
//    exact stage has 4).
// Pair axis: a call scores B pairs of one shape; grid y runs over (pair,
// hypothesis block) with per-pair pointer offsets, and each pair keeps the
// grid and partial layout of its B = 1 call, so its scores have the same
// bits.
// Widths: the first 32 features of a row are the register and shared
// memory slice above. A row of C > 32 (the wrapper zero-pads C to a
// multiple of 32; C < 32 to 32, which adds only zero products) carries
// its further 32-wide slices in device memory, read only in the steps a
// vote asks for (through L1 / L2, as those steps are rare). The product
// of a pair stays one sum: each slice's four partial sums are added as
// ((G0 + G1) + (G2 + G3)), and the slices one after another in column
// order, so <f_i, g_j> = ((S_0 + S_1) + S_2) + ...
// Distance and weight are fp32 with explicitly rounded operations (never
// below fp32: rounding coordinates flips radius membership) and an exact
// divide. Each block writes one partial sum per (hypothesis, source tile,
// segment) after a fixed-order shuffle reduction, and a second kernel adds
// a hypothesis' partials in a fixed order: no float atomics, so scores are
// identical from run to run. The feature products run on CUDA cores in
// fp32. Times on the card, per stage: PERF.md, section 6.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kC = 32;        // features of a slice (the main path's C)
constexpr int kC4 = kC / 4;   // float4 pieces of a feature row
constexpr int kHB = 8;        // hypotheses per block
constexpr int kThreads = 256; // source rows per block (one per thread)
constexpr int kTT = 128;      // target rows per shared-memory tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Shared {
  float4 tq[kTT];       // target points
  float4 tg[kTT][kC4];  // target features
  float red[kWarps][kHB];
};

// <f, g> over one 32-wide slice: four partial sums, then
// (G0 + G1) + (G2 + G3)
template <typename LoadF, typename LoadG>
__device__ __forceinline__ float slice_dot(LoadF f, LoadG g) {
  float G0 = 0.f, G1 = 0.f, G2 = 0.f, G3 = 0.f;
#pragma unroll
  for (int c = 0; c < kC4; ++c) {
    const float4 fc = f(c);
    const float4 gc = g(c);
    G0 = fmaf(fc.x, gc.x, G0);
    G1 = fmaf(fc.y, gc.y, G1);
    G2 = fmaf(fc.z, gc.z, G2);
    G3 = fmaf(fc.w, gc.w, G3);
  }
  return (G0 + G1) + (G2 + G3);
}

// The step a warp's vote asked for: G = <f_i, g_j>, then the weights of
// this thread's triples in radius. g: the target's first slice in shared
// memory; f: the source row's first slice in registers; fx / gx: the two
// rows' further slices in device memory (ns slices in all; fx is null for
// a thread past the source rows, whose features are zero).
template <int NH>
__device__ __forceinline__ void add_in_radius(const float4* __restrict__ g,
                                              const float4* f,
                                              const float4* __restrict__ fx,
                                              const float4* __restrict__ gx,
                                              int ns, const float* d2,
                                              float inv_s2, float r2,
                                              float* acc) {
  float G = slice_dot([&](int c) { return f[c]; },
                      [&](int c) { return g[c]; });
  for (int sl = 1; sl < ns; ++sl) {
    const float4* fs = fx + (sl - 1) * kC4;
    const float4* gs = gx + (sl - 1) * kC4;
    G += slice_dot(
        [&](int c) {
          return fx != nullptr ? __ldg(fs + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        },
        [&](int c) { return __ldg(gs + c); });
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    if (d2[h] <= r2) {
      const float w =
          __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(d2[h], inv_s2)));
      acc[h] = fmaf(w, G, acc[h]);
    }
  }
}

// One block with NH hypotheses: this thread's source row against the
// block's target tiles; acc_out[h] is the thread's sum.
template <int NH>
__device__ __forceinline__ void sweep(Shared& sm,
                                      const float4* __restrict__ pts_t,
                                      const float4* __restrict__ fs,
                                      const float4* __restrict__ tp,
                                      const float4* __restrict__ ft,
                                      int ld4, int h0, int S, int T,
                                      int tile0, int tile1, float inv_s2,
                                      float r2, float* acc_out) {
  const int ns = ld4 / kC4;  // 32-wide slices of a feature row
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  // a thread past the end holds a source row that is in no radius
  float px[NH], py[NH], pz[NH];
  float4 f[kC4];
  const float4* fx = i < S ? fs + (int64_t)i * ld4 + kC4 : nullptr;
  if (i < S) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float4 p = pts_t[(int64_t)(h0 + h) * S + i];
      px[h] = p.x, py[h] = p.y, pz[h] = p.z;
    }
#pragma unroll
    for (int c = 0; c < kC4; ++c) f[c] = fs[(int64_t)i * ld4 + c];
  } else {
#pragma unroll
    for (int h = 0; h < NH; ++h) px[h] = py[h] = pz[h] = INFINITY;
#pragma unroll
    for (int c = 0; c < kC4; ++c) f[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float acc[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) acc[h] = 0.f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int j0 = tile * kTT;
    const int nt = min(kTT, T - j0);
    __syncthreads();  // the previous tile is read to its end
    if (tid < nt) sm.tq[tid] = tp[j0 + tid];
    for (int e = tid; e < nt * kC4; e += kThreads)
      (&sm.tg[0][0])[e] = ft[(int64_t)(j0 + e / kC4) * ld4 + e % kC4];
    __syncthreads();
    // two targets a turn: their distance tests overlap, each has its vote
    int j = 0;
    for (; j + 1 < nt; j += 2) {
      const float4 qa = sm.tq[j], qb = sm.tq[j + 1];
      float da[NH], db[NH];
      bool hit_a = false, hit_b = false;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        da[h] = umr_sqdist3(px[h], py[h], pz[h], qa.x, qa.y, qa.z);
        db[h] = umr_sqdist3(px[h], py[h], pz[h], qb.x, qb.y, qb.z);
        hit_a = hit_a || (da[h] <= r2);
        hit_b = hit_b || (db[h] <= r2);
      }
      const bool any_a = __any_sync(kFull, hit_a);
      const bool any_b = __any_sync(kFull, hit_b);
      const float4* gxa = ft + (int64_t)(j0 + j) * ld4 + kC4;
      if (any_a)
        add_in_radius<NH>(sm.tg[j], f, fx, gxa, ns, da, inv_s2, r2, acc);
      if (any_b)
        add_in_radius<NH>(sm.tg[j + 1], f, fx, gxa + ld4, ns, db, inv_s2, r2,
                          acc);
    }
    if (j < nt) {
      const float4 qa = sm.tq[j];
      float da[NH];
      bool hit_a = false;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        da[h] = umr_sqdist3(px[h], py[h], pz[h], qa.x, qa.y, qa.z);
        hit_a = hit_a || (da[h] <= r2);
      }
      if (__any_sync(kFull, hit_a))
        add_in_radius<NH>(sm.tg[j], f, fx, ft + (int64_t)(j0 + j) * ld4 + kC4,
                          ns, da, inv_s2, r2, acc);
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) acc_out[h] = acc[h];
}

__global__ void __launch_bounds__(kThreads, 2)
corr_partial_kernel(const float4* __restrict__ pts_t,
                    const float4* __restrict__ fs,
                    const float4* __restrict__ tp,
                    const float4* __restrict__ ft,
                    float* __restrict__ partial, int H, int S, int T,
                    int ld4, float inv_s2, float r2) {
  __shared__ Shared sm;
  const int tid = threadIdx.x;
  const int hblocks = (H + kHB - 1) / kHB;
  const int64_t pair = blockIdx.y / hblocks;
  pts_t += pair * H * S;
  fs += pair * S * ld4;
  tp += pair * T;
  ft += pair * T * ld4;
  partial += pair * H * gridDim.x * gridDim.z;
  const int h0 = (blockIdx.y % hblocks) * kHB;
  const int nh = min(kHB, H - h0);
  // grid z is 1 (this block sweeps every target tile) or the tiles' count
  const int tile0 = blockIdx.z;
  const int tile1 = gridDim.z > 1 ? tile0 + 1 : (T + kTT - 1) / kTT;
  float acc[kHB];
#pragma unroll
  for (int h = 0; h < kHB; ++h) acc[h] = 0.f;
  switch (nh) {
#define UMR_CASE(N)                                                          \
  case N:                                                                    \
    sweep<N>(sm, pts_t, fs, tp, ft, ld4, h0, S, T, tile0, tile1, inv_s2, r2, \
             acc);                                                           \
    break;
    UMR_CASE(1) UMR_CASE(2) UMR_CASE(3) UMR_CASE(4)
    UMR_CASE(5) UMR_CASE(6) UMR_CASE(7) UMR_CASE(8)
#undef UMR_CASE
  }
  // fixed order: lanes by a shuffle tree, then the warps one after another
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int h = 0; h < kHB; ++h) {
    float v = acc[h];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) sm.red[warp][h] = v;
  }
  __syncthreads();
  if (tid < nh) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sm.red[w][tid];
    partial[((int64_t)(h0 + tid) * gridDim.x + blockIdx.x) * gridDim.z +
            blockIdx.z] = s;
  }
}

// One warp per hypothesis: lane l adds partials l, l + 32, ... in that
// order, then the lanes are added by a shuffle tree.
__global__ void corr_sum_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int H, int n_parts) {
  const int h = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (h >= H) return;  // whole warps leave together
  float s = 0.f;
  for (int t = lane; t < n_parts; t += 32) s += partial[(int64_t)h * n_parts + t];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) out[h] = s;
}

}  // namespace

// B pairs: pts_t (B,H,S,4), fs (B,S,C), tp (B,T,4), ft (B,T,C) f32,
// 16-byte aligned -> out (B,H) f32. split: 0 = a block sweeps every
// target, else one block per tile of 128 targets. partial (B, H,
// ceil(S/256), split ? ceil(T/128) : 1) f32 is caller-allocated scratch.
// C must be a positive multiple of 32 (the wrapper pads); B, H, S, T >= 1.
UMR_EXPORT int umr_corr_scores(const float* pts_t, const float* fs,
                               const float* tp, const float* ft,
                               float* partial, float* out, int B, int H,
                               int S, int T, int C, int split, float inv_s2,
                               float r2, void* stream) {
  if (C < kC || C % kC != 0 || B < 1 || H < 1 || S < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_src = (S + kThreads - 1) / kThreads;
  const int n_seg = split ? (T + kTT - 1) / kTT : 1;
  const int64_t grid_y = (int64_t)B * ((H + kHB - 1) / kHB);
  if (grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(n_src, (unsigned)grid_y, n_seg);
  if (grid.y > 65535u || grid.z > 65535u)
    return static_cast<int>(cudaErrorInvalidValue);
  corr_partial_kernel<<<grid, kThreads, 0, st>>>(
      reinterpret_cast<const float4*>(pts_t),
      reinterpret_cast<const float4*>(fs), reinterpret_cast<const float4*>(tp),
      reinterpret_cast<const float4*>(ft), partial, H, S, T, C / 4, inv_s2,
      r2);
  constexpr int kSumThreads = 128;  // 4 hypotheses a block
  const int64_t sum_blocks = ((int64_t)B * H * 32 + kSumThreads - 1) /
                             kSumThreads;
  corr_sum_kernel<<<(unsigned)sum_blocks, kSumThreads, 0, st>>>(
      partial, out, B * H, n_src * n_seg);
  return static_cast<int>(cudaGetLastError());
}
