// Capped ball-query UME moment accumulation.
//
// Replaces: umeregrobust_tpu/ops/pallas_ume.py, ume_moments_fused.
//
// Computes out[k] = sum_n w[k,n] * Z[n] with w[k,n] = 1 iff point n is
// valid, lies within `radius` of keypoint k, and is among the first
// `max_nn` such points in index order (PyTorch3D ball_query capping).
//
// Bound on the H100: bytes. Z is 16384 x 128 x 4 B = 8 MB read once;
// the selected-row sums are <= 2048 * 750 * 128 * 2 FLOP ~ 0.4 GFLOP and
// the radius tests ~0.3 GFLOP, both far below the fp32 rate.
//
// Design: one warp per keypoint. The warp sweeps the points in index
// order, 32 at a time: each lane tests one point with the direct-
// difference distance, `__ballot_sync` gathers the in-radius lanes and
// the set bits are consumed in ascending order while a register count
// (uniform across the warp) stays below max_nn -- the in-order prefix
// count that the TPU kernel built with a triangular matmul. Each lane owns
// 4 of the 128 columns of Z and accumulates the selected rows in fp32, in
// index order, with one coalesced 512-byte row read per selected point
// (Z stays resident in the 50 MB L2). The block's 8 warps share point
// tiles staged in shared memory (masked points parked far away so they
// never pass the test and never use up a slot); a warp stops once its
// count reaches max_nn, which the capped semantics make exact, and the
// block stops when all its warps have. No bf16 hi/lo split: fp32 all the
// way.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 2048;
constexpr int kCols = 128;  // 4C at C = 32: 4 columns per lane

__global__ void ume_moments_kernel(const float* __restrict__ kpts,
                                   const float* __restrict__ pts,
                                   const float* __restrict__ Z,
                                   const uint8_t* __restrict__ mask,
                                   float* __restrict__ out, int M, int N,
                                   float r2, int max_nn) {
  __shared__ float sp[kTile * 3];
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  float kx = 0.f, ky = 0.f, kz = 0.f;
  if (k < M) {
    kx = kpts[3 * k];
    ky = kpts[3 * k + 1];
    kz = kpts[3 * k + 2];
  }
  int count = 0;
  bool active = (k < M) && (max_nn > 0);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* Z4 = reinterpret_cast<const float4*>(Z);
  for (int base = 0; base < N; base += kTile) {
    // every thread reaches both barriers; the block leaves together once
    // no warp has slots left to fill
    if (__syncthreads_or(active) == 0) break;
    const int len = min(kTile, N - base);
    for (int t = threadIdx.x; t < len; t += kWarps * 32) {
      const int n = base + t;
      const bool ok = mask[n] != 0;
      sp[3 * t] = ok ? pts[3 * n] : -1e9f;
      sp[3 * t + 1] = ok ? pts[3 * n + 1] : -1e9f;
      sp[3 * t + 2] = ok ? pts[3 * n + 2] : -1e9f;
    }
    __syncthreads();
    if (active) {
      for (int g = 0; g < len && count < max_nn; g += 32) {
        const int t = g + lane;
        bool in = false;
        if (t < len) {
          const float d2 = umr_sqdist3(kx, ky, kz, sp[3 * t], sp[3 * t + 1],
                                       sp[3 * t + 2]);
          in = d2 <= r2;
        }
        unsigned bits = __ballot_sync(0xffffffffu, in);
        while (bits != 0u && count < max_nn) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1u;
          const float4 z = Z4[(int64_t)(base + g + b) * (kCols / 4) + lane];
          acc.x += z.x;
          acc.y += z.y;
          acc.z += z.z;
          acc.w += z.w;
          ++count;
        }
      }
      active = count < max_nn;
    }
  }
  if (k < M) {
    reinterpret_cast<float4*>(out)[(int64_t)k * (kCols / 4) + lane] = acc;
  }
}

}  // namespace

// kpts (M,3), pts (N,3), Z (N,128) f32, mask (N,) bool -> out (M,128) f32.
// C4 must be 128 (checked by the wrapper; passed for the record).
UMR_EXPORT int umr_ume_moments(const float* kpts, const float* pts,
                               const float* Z, const uint8_t* mask,
                               float* out, int M, int N, int C4, float r2,
                               int max_nn, void* stream) {
  if (C4 != kCols) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (M + kWarps - 1) / kWarps;
  ume_moments_kernel<<<blocks, kWarps * 32, 0, st>>>(kpts, pts, Z, mask, out,
                                                     M, N, r2, max_nn);
  return static_cast<int>(cudaGetLastError());
}
