// Per-tap sparse convolution (gather + product, summed over kernel taps):
//   out[i, :] = sum_k feats[nbr[k, i], :] @ w[k]      (nbr < 0: zero row)
// with fp32 sums and, on request, both operands rounded to bf16 first.
//
// Replaces: tools/exp_pallas_gather.py, conv_pallas_unroll (one program,
// taps unrolled, one write) -> umr_sparse_conv_rowtile, and
// conv_pallas_taps (grid over the taps, partial sums added into one
// output) -> umr_sparse_conv_tapsplit. Both compute
// umeregrobust_tpu/ops/sparse.py sparse_conv.
//
// Bound on the H100: operations for the wide deep layers (125 taps of
// 512 x 1024), bytes for the narrow shallow ones (the k7 stem has one
// input channel: all gather, no arithmetic).
//
// Design: the tap axis and the input-channel axis are one reduction axis
// r = k * Cin + c of length K * Cin, over which the weights (K, Cin, Cout)
// are already a contiguous (K * Cin, Cout) matrix; the left operand
// A[i, r] = feats[nbr[r / Cin, i], r % Cin] is gathered on the fly. A
// block owns 64 output rows x TN output channels (TN 32 or 64) and walks
// the reduction axis 32 entries at a time: the map entries of the taps in
// the chunk go to shared memory (coalesced along rows), a chunk none of
// whose taps has a valid index in the tile is skipped (changes no sum),
// the gathered 64 x 32 piece of A and the 32 x TN piece of the weights are
// staged in shared memory (rounded to bf16 there when asked), and each of
// the 256 threads keeps a 4 x (TN / 16) tile of fp32 sums in registers.
// With Cin = 1 a chunk holds 32 taps; with Cin >= 32 it lies inside one.
//   rowtile:  the block walks the whole axis and writes the result once.
//   tapsplit: grid z splits the taps into S segments; each block writes
//             its partial tile and a second kernel adds the S partials in
//             segment order. For the deep levels (<= 256 rows), where row
//             x channel tiles alone leave most SMs idle. No atomics: the
//             result is the same from run to run.
// Static shared memory: 8 KB map + 8.25 KB A + 4 or 8 KB weights.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

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
