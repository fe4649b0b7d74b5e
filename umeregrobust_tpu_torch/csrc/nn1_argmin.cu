// Exact brute-force 1-NN argmin.
//
// Replaces: umeregrobust_tpu/ops/pallas_nn.py, nn1_argmin (the Pallas
// TPU kernel behind the SEM-grid -> correlator-point feature transfer).
//
// What it computes: for each query, the first index among the minima of
// ((d0*d0 + d1*d1) + d2*d2), d = q - p, every operation rounded on its own
// (umr_sqdist3: the bits of the plain version and of the JAX kernel);
// masked rows are parked at 1e9. No multiply is fused into an add.
//
// Bound on the H100: operations. A (query, point) pair is 8 fp32
// operations and a compare; without fused multiply-adds at most one fp32
// instruction issues a lane and clock, so the floor is 9 instructions a
// pair over 132 SMs x 128 lanes x the SM clock (~0.018 ms at 4096 x 16384
// and 1.98 GHz), twice what the published 67 TFLOP/s (which counts an FMA
// as two operations) would give. The inputs are ~250 KB.
//
// Design:
// - A thread keeps kQ queries in registers (kQ independent compare
//   chains); a block of kThreads threads serves kThreads * kQ queries.
// - The block stages its SEGMENT of the targets in shared memory as float4
//   (x, y, z, pad), kTile at a time, with the mask applied while staging
//   (masked rows at 1e9; the ragged end padded to a whole step with +inf,
//   which never wins). One 16-byte broadcast load then serves the
//   thread's kQ queries. The segment is a few KB read once a block:
//   cp.async or TMA could not apply the mask and would have nothing to
//   overlap.
// - The sweep goes kStep targets a step, two steps a loop turn. Per query
//   and step the kStep distances are reduced with fminf and one strict `<`
//   against the running minimum keeps the first step that reaches it;
//   after the sweep the step's kStep distances are computed again (the
//   same bits, from shared memory when the step is in the last tile) and
//   the first equal slot wins. That is ~1.5 instructions a pair for the
//   running (min, argmin) instead of 3, and the exact first index.
// - Running indices and the partials are int32 (the wrapper raises for
//   N >= 2^31); the index widens to int64 only at the final store.
// - The grid (query tiles x segments) is sized by the wrapper from the SM
//   count, two blocks an SM in one wave (more blocks an SM did not make
//   the sweep faster on the H100 and made the merge longer). The merge
//   kernel takes each query's segments in index order with the same
//   strict `<`, 8 warps a block over 32 queries, each warp one run of
//   segments, then the runs in order: the exact first-index argmin,
//   identical to the plain version. No atomics, no host read; two
//   launches a call.
// - Pair axis: a call serves B independent (queries, targets) problems of
//   one shape; the pair is grid z of the sweep and grid y of the merge,
//   with per-pair pointer offsets. The wrapper's plan gives each pair
//   fewer segments as B grows (about two blocks an SM in all); a pair's
//   answer is exact whatever its segments, so it equals the B = 1 call.
// Tensor cores, wgmma and TMA do not apply: the expanded |q|^2 + |p|^2 -
// 2 q.p form would change the argmin on near-ties and break exactness
// against the JAX package.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kQ = 4;          // queries a thread
constexpr int kTile = 512;     // targets staged in shared memory a pass
constexpr int kStep = 4;       // targets a step of the sweep
constexpr int kPer = kTile / kThreads;  // targets a thread stages a pass
constexpr int kMergeWarps = 8;  // warps that merge 32 queries' segments
constexpr float kFar = 1e9f;   // where masked rows are parked

// Target n of the segment [.., hi) as the sweep sees it: its point, 1e9
// where masked, +inf at and past hi (a pad, never the minimum). The row
// is read from a clamped index, so no load waits for a test.
__device__ __forceinline__ float4 target(const float* __restrict__ p,
                                         const uint8_t* __restrict__ mask,
                                         int64_t n, int hi) {
  const int64_t r = min(n, (int64_t)hi - 1);
  const uint8_t ok = mask[r];
  const float* row = p + 3 * r;
  const float x = row[0], y = row[1], z = row[2];
  const float inf = __int_as_float(0x7f800000);
  if (n >= hi) return make_float4(inf, inf, inf, 0.f);
  return ok ? make_float4(x, y, z, 0.f) : make_float4(kFar, kFar, kFar, 0.f);
}

__global__ void __launch_bounds__(kThreads)
    nn1_segment_kernel(const float* __restrict__ q,
                       const float* __restrict__ p,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ part_d2,
                       int32_t* __restrict__ part_idx, int M, int N,
                       int seg_len) {
  __shared__ float4 sp[kTile];
  const int tid = threadIdx.x;
  const int64_t pair = blockIdx.z;
  q += pair * M * 3;
  p += pair * N * 3;
  mask += pair * N;
  part_d2 += pair * gridDim.y * M;
  part_idx += pair * gridDim.y * M;
  const int q0 = (int)blockIdx.x * (kThreads * kQ) + tid;
  const int seg_lo = (int)blockIdx.y * seg_len;
  const int seg_hi = (int)min((int64_t)N, (int64_t)seg_lo + seg_len);
  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int bi[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const float* r = q + 3 * (int64_t)min(q0 + k * kThreads, M - 1);
    qx[k] = r[0];
    qy[k] = r[1];
    qz[k] = r[2];
    best[k] = __int_as_float(0x7f800000);  // +inf
    bi[k] = seg_lo;
  }
  int base = seg_lo;
  for (int64_t tile = seg_lo; tile < seg_hi; tile += kTile) {
    base = (int)tile;  // 64-bit step: no overflow near N = 2^31
    const int steps = (min(kTile, seg_hi - base) + kStep - 1) / kStep;
    if (base != seg_lo) __syncthreads();
    float4 v[kPer];  // the pass's loads issued before its first store
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      v[j] = target(p, mask, tile + tid + j * kThreads, seg_hi);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (tid + j * kThreads < steps * kStep) sp[tid + j * kThreads] = v[j];
    __syncthreads();
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      float4 tp[kStep];
#pragma unroll
      for (int u = 0; u < kStep; ++u) tp[u] = sp[s * kStep + u];
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        float m = umr_sqdist3(qx[k], qy[k], qz[k], tp[0].x, tp[0].y, tp[0].z);
#pragma unroll
        for (int u = 1; u < kStep; ++u)
          m = fminf(m, umr_sqdist3(qx[k], qy[k], qz[k], tp[u].x, tp[u].y,
                                   tp[u].z));
        if (m < best[k]) {  // strict: the first step that reaches it
          best[k] = m;
          bi[k] = base + s * kStep;
        }
      }
    }
  }
  // the first slot of the winning step that holds the minimum: its
  // distances again, from shared memory when the step is in the last
  // tile (always on a segment of at most kTile targets)
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = q0 + k * kThreads;
    if (qi >= M) continue;
    int idx = bi[k];
#pragma unroll
    for (int u = kStep - 1; u >= 0; --u) {
      float4 t;
      if (bi[k] >= base)
        t = sp[bi[k] - base + u];
      else
        t = target(p, mask, (int64_t)bi[k] + u, seg_hi);
      if (umr_sqdist3(qx[k], qy[k], qz[k], t.x, t.y, t.z) == best[k])
        idx = bi[k] + u;
    }
    part_d2[(int64_t)blockIdx.y * M + qi] = best[k];
    part_idx[(int64_t)blockIdx.y * M + qi] = idx;
  }
}

// 32 queries a block: warp w takes the w-th run of segments in order
// (strict `<`), then warp 0 takes the runs in order.
__global__ void __launch_bounds__(32 * kMergeWarps)
    nn1_merge_kernel(const float* __restrict__ part_d2,
                     const int32_t* __restrict__ part_idx,
                     int64_t* __restrict__ out, int M, int S) {
  __shared__ float run_d2[kMergeWarps][32];
  __shared__ int run_idx[kMergeWarps][32];
  const int64_t pair = blockIdx.y;
  part_d2 += pair * S * M;
  part_idx += pair * S * M;
  out += pair * M;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = (int)blockIdx.x * 32 + lane;
  const int qi = min(q, M - 1);
  const int per = (S + kMergeWarps - 1) / kMergeWarps;
  const int s_lo = w * per, s_hi = min(S, s_lo + per);
  float best = __int_as_float(0x7f800000);  // an empty run never wins
  int best_i = 0;
  if (s_lo < s_hi) {
    best = part_d2[(int64_t)s_lo * M + qi];
    best_i = part_idx[(int64_t)s_lo * M + qi];
  }
#pragma unroll 4
  for (int s = s_lo + 1; s < s_hi; ++s) {
    const float d2 = part_d2[(int64_t)s * M + qi];
    const int i = part_idx[(int64_t)s * M + qi];
    if (d2 < best) {  // earlier segments (lower indices) win ties
      best = d2;
      best_i = i;
    }
  }
  run_d2[w][lane] = best;
  run_idx[w][lane] = best_i;
  __syncthreads();
  if (w != 0 || q >= M) return;
#pragma unroll
  for (int r = 1; r < kMergeWarps; ++r) {
    if (run_d2[r][lane] < best) {
      best = run_d2[r][lane];
      best_i = run_idx[r][lane];
    }
  }
  out[qi] = best_i;
}

}  // namespace

// B pairs: q (B,M,3) f32, p (B,N,3) f32, mask (B,N) bool -> out (B,M)
// int64. scratch: 2 B S M int32 from the caller (the B x S x M partial
// minima, then their indices); per pair, S segments of seg_len targets
// cover [0, N).
UMR_EXPORT int umr_nn1_argmin(const float* q, const float* p,
                              const uint8_t* mask, int32_t* scratch,
                              int64_t* out, int B, int M, int N, int S,
                              int seg_len, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || M <= 0 || N <= 0 || S <= 0 || S > 65535 ||
      seg_len <= 0 || (int64_t)(S - 1) * seg_len >= N ||
      (int64_t)S * seg_len < N)
    return static_cast<int>(cudaErrorInvalidValue);
  float* part_d2 = reinterpret_cast<float*>(scratch);
  int32_t* part_idx = scratch + (int64_t)B * S * M;
  const dim3 grid((M + kThreads * kQ - 1) / (kThreads * kQ), S, B);
  nn1_segment_kernel<<<grid, kThreads, 0, st>>>(q, p, mask, part_d2, part_idx,
                                                M, N, seg_len);
  nn1_merge_kernel<<<dim3((M + 31) / 32, B), 32 * kMergeWarps, 0, st>>>(
      part_d2, part_idx, out, M, S);
  return static_cast<int>(cudaGetLastError());
}
