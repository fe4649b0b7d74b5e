// First-K ball query: for each query, the first K valid point indices in
// ascending index order whose squared distance is <= r2, padded with -1.
//
// Replaces: umeregrobust_tpu/ops/neighbors.py:68 ball_query (a lax.scan of
// distance tiles and top-k selections, plain XLA: no TPU kernel), and on
// the card the port's chunked plain version (ops/neighbors.py
// ball_query_plain: per 256 queries a (256, N) distance tile from a GEMM
// and element-wise passes, then a radix top-k over all N columns, and a
// copy of the radius to the card). The training keypoint selection
// (pipeline/train_keypoints._select) calls it three times a pair over
// 100000-row clouds: 394 such chunks a pair.
//
// Exact decisions. The plain version decides
//   d2 = max((|q|^2 + |p|^2) - 2 (q . p), 0) <= r2
// in fp32, with q . p from the fp32 GEMM. |q|^2 and |p|^2 come in from the
// wrapper, computed by the plain version's own torch expression. The dot
// product is formed as the GEMM forms a depth-3 product, one fused
// multiply-add a term in index order: q0 p0, then fma(q1, p1, .), then
// fma(q2, p2, .) (on an H100 this chain equals cuBLAS's fp32 q @ p^T on
// every element of a (256, 100000) product; (q0 p0 + q1 p1) + q2 p2
// differs on 36% of them). Every step is a rounded intrinsic, so that
// nvcc's contraction cannot change the rounding. 2 (q . p) is exact, and
// so is the clamp at 0: r2 >= 0, so a negative d2 is in radius either
// way. An invalid point is staged with |p|^2 = NaN and is in no radius.
//
// Bound on the H100: fp32 operations (9 a radius test). The main path's
// worst call, K = 1 over a padded 100000-row cloud with ~30000 valid
// rows, is ~9e8 tests a pair if no query stopped early: ~0.12 ms at 67
// TFLOP/s. The K = 750 calls test under 2e7 pairs. Measured on an H100
// (700 W), device alone: 0.27 ms for the K = 1 call, 0.08-0.10 ms for a
// K = 750 call, where the plain version took 446 ms and 1.4-2.5 ms.
//
// Design:
//  - A block owns kWarps queries, a warp each, and stages tiles of kTile
//    points in shared memory as float4 (x, y, z, |p|^2 or NaN), so that a
//    warp's step is one conflict-free 16-byte read a lane. The points'
//    mask is read first: a tile with no valid point (a padded cloud's
//    tail) is skipped without reading its coordinates.
//  - A warp sweeps a tile 32 points a step and takes __ballot_sync of the
//    in-radius lanes, kUnroll steps' ballots before it looks at the
//    first. A hit lane writes its index at count + popc(bits below it),
//    which keeps index order; count stops at K and the warp stops
//    sweeping (at K = 1 the first non-zero ballot's lowest lane). This is
//    ume_moments.cu's in-order ballot cap, emitting indices in place of
//    sums. Indices go straight to the output row.
//  - The block stops staging tiles once none of its warps sweeps; a query
//    with q_mask false never sweeps. Every warp pads its row with -1.
// Pair axis: grid y runs over B independent problems of one shape.
#include "common.cuh"

namespace {

constexpr int kWarps = 16;   // queries a block, one a warp
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;  // points a block stages a pass
constexpr int kPer = kTile / kThreads;  // points a thread stages
constexpr int kUnroll = 4;   // ballots taken before the first is read
constexpr int kSteps = kTile / 32;

static_assert(kTile % kThreads == 0, "whole points a thread");
static_assert(kSteps % kUnroll == 0, "whole turns a tile");

// the plain version's radius decision (see the note above)
__device__ __forceinline__ bool in_radius(float qx, float qy, float qz,
                                          float qq, float4 p, float r2) {
  const float dot =
      __fmaf_rn(qz, p.z, __fmaf_rn(qy, p.y, __fmul_rn(qx, p.x)));
  return __fsub_rn(__fadd_rn(qq, p.w), __fmul_rn(2.f, dot)) <= r2;
}

__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ query,
                  const float* __restrict__ qq,
                  const uint8_t* __restrict__ q_mask,
                  const float* __restrict__ points,
                  const float* __restrict__ pp,
                  const uint8_t* __restrict__ p_mask,
                  int64_t* __restrict__ out, int M, int N, int K, float r2) {
  __shared__ float4 tile[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t pair = blockIdx.y;
  query += pair * M * 3;
  qq += pair * M;
  points += pair * N * 3;
  pp += pair * N;
  if (q_mask != nullptr) q_mask += pair * M;
  if (p_mask != nullptr) p_mask += pair * N;
  const int k = blockIdx.x * kWarps + warp;
  int64_t* row = out + (pair * M + k) * K;
  const bool owner = k < M;  // whole warps: k is uniform over the warp
  bool active = owner && (q_mask == nullptr || q_mask[k] != 0);
  float qx = 0.f, qy = 0.f, qz = 0.f, q2 = 0.f;
  if (active) {
    qx = query[3 * (int64_t)k];
    qy = query[3 * (int64_t)k + 1];
    qz = query[3 * (int64_t)k + 2];
    q2 = qq[k];
  }
  const unsigned below = (1u << lane) - 1u;
  const float nan = __int_as_float(0x7fc00000);
  int count = 0;  // hits written, <= K (uniform over the warp)

  bool go = __syncthreads_or(active);
  for (int t0 = 0; go && t0 < N; t0 += kTile) {
    bool valid[kPer];
    bool any = false;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = t0 + i * kThreads + threadIdx.x;
      valid[i] = n < N && (p_mask == nullptr || p_mask[n] != 0);
      any |= valid[i];
    }
    // the previous tile's sweep ended at the barrier that set `go`
    if (!__syncthreads_or(any)) continue;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int n = t0 + i * kThreads + threadIdx.x;
      tile[i * kThreads + threadIdx.x] =
          valid[i] ? make_float4(points[3 * (int64_t)n],
                                 points[3 * (int64_t)n + 1],
                                 points[3 * (int64_t)n + 2], pp[n])
                   : make_float4(0.f, 0.f, 0.f, nan);
    }
    __syncthreads();
    if (active) {
      for (int s = 0; s < kSteps; s += kUnroll) {
        unsigned bits[kUnroll];
        unsigned hit = 0u;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float4 p = tile[(s + u) * 32 + lane];
          bits[u] = __ballot_sync(0xffffffffu,
                                  in_radius(qx, qy, qz, q2, p, r2));
          hit |= bits[u];
        }
        if (hit == 0u) continue;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (bits[u] == 0u || count >= K) continue;
          const int pos = count + __popc(bits[u] & below);
          if (((bits[u] >> lane) & 1u) && pos < K)
            row[pos] = t0 + (s + u) * 32 + lane;
          count = min(count + __popc(bits[u]), K);
        }
        if (count >= K) break;
      }
      active = count < K;
    }
    go = __syncthreads_or(active);
  }
  if (owner)
    for (int j = count + lane; j < K; j += 32) row[j] = -1;
}

}  // namespace

// B problems: query (B,M,3) and qq (B,M) f32, points (B,N,3) and pp (B,N)
// f32, masks (B,M) / (B,N) bool or null (all valid) -> out (B,M,K) int64.
// qq and pp are |q|^2 and |p|^2 as the plain version computes them; r2 is
// the fp32 radius squared. 1 <= K <= N.
UMR_EXPORT int umr_ball_query(const float* query, const float* qq,
                              const uint8_t* q_mask, const float* points,
                              const float* pp, const uint8_t* p_mask,
                              int64_t* out, int B, int M, int N, int K,
                              float r2, void* stream) {
  if (B < 1 || B > 65535 || M < 0 || K < 1 || K > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kWarps - 1) / kWarps, B);
  ball_query_kernel<<<grid, kThreads, 0, st>>>(query, qq, q_mask, points, pp,
                                               p_mask, out, M, N, K, r2);
  return static_cast<int>(cudaGetLastError());
}
