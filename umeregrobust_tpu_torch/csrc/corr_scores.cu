// Radius-capped Cauchy kernel-correlation scores.
//
// Replaces: umeregrobust_tpu/ops/pallas_corr.py, corr_scores_fused.
//
// For each hypothesis h: sum_i sum_j 1[d2 <= (2 sigma)^2] / (1 + d2 /
// sigma^2) * <f_i, g_j>, with d2 = |T_h p_i - q_j|^2 (the caller passes
// the transformed source points and divides by N).
//
// Bound on the H100: operations. Per (h, i, j) triple the distance test
// is ~9 fp32 operations and an in-radius triple adds the weight; the
// feature tile <f_i, g_j> is 2C operations per (i, j), shared by all
// hypotheses. The main path's stages come to ~8-9 GFLOP per pair, while
// the inputs are a few MB.
//
// Design: a block owns one (hypothesis block of 8, source tile of 32
// rows) pair and sweeps the whole target cloud in tiles of 256, one
// target per thread. The source features and the 8 hypotheses'
// transformed source points sit in shared memory; a thread keeps its
// target's features and xyz in registers, computes <f_i, g_j> once per
// source row and reuses it for all 8 hypotheses of the block. Distance
// and weight are fp32 with explicitly rounded operations (never below
// fp32: rounding coordinates flips radius membership). Each block writes
// one partial sum per (hypothesis, source tile) after a fixed-order tree
// reduction, and a second pass adds the partials of a hypothesis in
// source-tile order: no float atomics, so scores are identical from run
// to run. The feature products run on CUDA cores in fp32; tensor cores
// are later work.
#include "common.cuh"

namespace {

constexpr int kC = 32;        // feature width on the main path
constexpr int kHB = 8;        // hypotheses per block
constexpr int kTS = 32;       // source rows per block
constexpr int kThreads = 256; // target rows per tile (one per thread)

__global__ void corr_partial_kernel(const float* __restrict__ pts_t,
                                    const float* __restrict__ fs,
                                    const float* __restrict__ tp,
                                    const float* __restrict__ ft,
                                    float* __restrict__ partial, int H, int S,
                                    int T, float inv_s2, float r2) {
  __shared__ float sf[kTS][kC];
  __shared__ float sp[kHB][kTS][3];
  __shared__ float red[kHB][kThreads];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kTS;
  const int h0 = blockIdx.y * kHB;
  const int ns = min(kTS, S - i0);
  const int nh = min(kHB, H - h0);
  for (int e = tid; e < kTS * kC; e += kThreads) {
    const int i = e / kC, c = e % kC;
    sf[i][c] = (i < ns) ? fs[(int64_t)(i0 + i) * kC + c] : 0.f;
  }
  for (int e = tid; e < kHB * kTS; e += kThreads) {
    const int h = e / kTS, i = e % kTS;
    const bool ok = (h < nh) && (i < ns);
    const int64_t row = ((int64_t)(h0 + h) * S + (i0 + i)) * 4;
    sp[h][i][0] = ok ? pts_t[row] : 0.f;
    sp[h][i][1] = ok ? pts_t[row + 1] : 0.f;
    sp[h][i][2] = ok ? pts_t[row + 2] : 0.f;
  }
  __syncthreads();

  float acc[kHB];
#pragma unroll
  for (int h = 0; h < kHB; ++h) acc[h] = 0.f;

  for (int j0 = 0; j0 < T; j0 += kThreads) {
    const int j = j0 + tid;
    float g[kC];
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (j < T) {
#pragma unroll
      for (int c = 0; c < kC; ++c) g[c] = ft[(int64_t)j * kC + c];
      qx = tp[(int64_t)j * 4];
      qy = tp[(int64_t)j * 4 + 1];
      qz = tp[(int64_t)j * 4 + 2];
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c) g[c] = 0.f;  // contributes nothing
    }
    for (int i = 0; i < ns; ++i) {
      float G = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) G = fmaf(sf[i][c], g[c], G);
#pragma unroll
      for (int h = 0; h < kHB; ++h) {
        if (h < nh) {
          const float d2 = umr_sqdist3(sp[h][i][0], sp[h][i][1], sp[h][i][2],
                                       qx, qy, qz);
          if (d2 <= r2) {
            const float w =
                __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(d2, inv_s2)));
            acc[h] = fmaf(w, G, acc[h]);
          }
        }
      }
    }
  }
  // fixed-order tree reduction over the block's targets
#pragma unroll
  for (int h = 0; h < kHB; ++h) red[h][tid] = acc[h];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
#pragma unroll
      for (int h = 0; h < kHB; ++h) red[h][tid] += red[h][tid + half];
    }
    __syncthreads();
  }
  if (tid < nh) partial[(int64_t)(h0 + tid) * gridDim.x + blockIdx.x] = red[tid][0];
}

__global__ void corr_sum_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int H, int n_tiles) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[(int64_t)h * n_tiles + t];
  out[h] = s;
}

}  // namespace

// pts_t (H,S,4), fs (S,C), tp (T,4), ft (T,C) f32 -> out (H,) f32.
// partial (H, ceil(S/32)) f32 is caller-allocated scratch; C must be 32.
UMR_EXPORT int umr_corr_scores(const float* pts_t, const float* fs,
                               const float* tp, const float* ft,
                               float* partial, float* out, int H, int S,
                               int T, int C, float inv_s2, float r2,
                               void* stream) {
  if (C != kC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (S + kTS - 1) / kTS;
  dim3 grid(n_tiles, (H + kHB - 1) / kHB);
  corr_partial_kernel<<<grid, kThreads, 0, st>>>(pts_t, fs, tp, ft, partial,
                                                 H, S, T, inv_s2, r2);
  corr_sum_kernel<<<(H + 255) / 256, 256, 0, st>>>(partial, out, H, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
