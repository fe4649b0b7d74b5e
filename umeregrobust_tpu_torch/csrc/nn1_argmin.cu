// Exact brute-force 1-NN argmin.
//
// Replaces: umeregrobust_tpu/ops/pallas_nn.py, nn1_argmin (the Pallas
// TPU kernel behind the SEM-grid -> correlator-point feature transfer).
//
// Bound on the H100: operations. About 8 fp32 operations per (query,
// point) pair (3 sub, 3 mul, 2 add) plus a compare; at the main path's
// 4096 x 16384 that is ~0.5 GFLOP per cloud, microseconds at 67 TFLOP/s,
// while the inputs are only ~250 KB.
//
// Design: one thread per query. A block of 128 queries sweeps one
// SEGMENT of the reference cloud, staged tile by tile in shared memory
// (xyz, masked rows parked at 1e9 as the TPU kernel does), keeping a
// running (min d2, argmin) with a strict `<` so the first index wins ties.
// Splitting the cloud into segments gives enough blocks to fill the SMs
// (4096 queries alone make only 32 blocks); a second pass takes the
// segments in index order with the same strict `<`, so the result is the
// exact first-index argmin, identical to the plain version. No atomics.
#include "common.cuh"

namespace {

constexpr int kQueries = 128;  // threads (queries) per block
constexpr int kTile = 1024;    // reference points staged per tile

__global__ void nn1_segment_kernel(const float* __restrict__ q,
                                   const float* __restrict__ p,
                                   const uint8_t* __restrict__ mask,
                                   float* __restrict__ part_d2,
                                   int64_t* __restrict__ part_idx,
                                   int M, int N, int seg_len) {
  __shared__ float sp[kTile * 3];
  const int qi = blockIdx.x * kQueries + threadIdx.x;
  const int seg = blockIdx.y;
  const int seg_lo = seg * seg_len;
  const int seg_hi = min(N, seg_lo + seg_len);
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < M) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  float best = __int_as_float(0x7f800000);  // +inf
  int64_t best_i = seg_lo;
  for (int base = seg_lo; base < seg_hi; base += kTile) {
    const int len = min(kTile, seg_hi - base);
    __syncthreads();
    for (int t = threadIdx.x; t < len; t += kQueries) {
      const int n = base + t;
      const bool ok = mask[n] != 0;
      sp[3 * t] = ok ? p[3 * n] : 1e9f;
      sp[3 * t + 1] = ok ? p[3 * n + 1] : 1e9f;
      sp[3 * t + 2] = ok ? p[3 * n + 2] : 1e9f;
    }
    __syncthreads();
    for (int t = 0; t < len; ++t) {
      const float d2 = umr_sqdist3(qx, qy, qz, sp[3 * t], sp[3 * t + 1],
                                   sp[3 * t + 2]);
      if (d2 < best) {
        best = d2;
        best_i = base + t;
      }
    }
  }
  if (qi < M) {
    part_d2[(int64_t)seg * M + qi] = best;
    part_idx[(int64_t)seg * M + qi] = best_i;
  }
}

__global__ void nn1_reduce_kernel(const float* __restrict__ part_d2,
                                  const int64_t* __restrict__ part_idx,
                                  int64_t* __restrict__ out, int M, int S) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= M) return;
  float best = part_d2[qi];
  int64_t best_i = part_idx[qi];
  for (int s = 1; s < S; ++s) {
    const float d2 = part_d2[(int64_t)s * M + qi];
    if (d2 < best) {  // earlier segments (lower indices) win ties
      best = d2;
      best_i = part_idx[(int64_t)s * M + qi];
    }
  }
  out[qi] = best_i;
}

}  // namespace

// q (M,3) f32, p (N,3) f32, mask (N,) bool -> out (M,) int64.
// part_d2 (S,M) f32 and part_idx (S,M) int64 are caller-allocated scratch.
UMR_EXPORT int umr_nn1_argmin(const float* q, const float* p,
                              const uint8_t* mask, float* part_d2,
                              int64_t* part_idx, int64_t* out, int M, int N,
                              int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int seg_len = (N + S - 1) / S;
  dim3 grid((M + kQueries - 1) / kQueries, S);
  nn1_segment_kernel<<<grid, kQueries, 0, st>>>(q, p, mask, part_d2,
                                                part_idx, M, N, seg_len);
  nn1_reduce_kernel<<<(M + 255) / 256, 256, 0, st>>>(part_d2, part_idx, out,
                                                     M, S);
  return static_cast<int>(cudaGetLastError());
}
