// The SO(3) solver: the proper rotation R = argmin sum |R p - q|^2 from a
// batch of 3x3 cross-covariances H, by Horn's quaternion method with a
// fixed number of cyclic Jacobi sweeps on the symmetric 4x4.
//
// Replaces: no TPU kernel. umeregrobust_tpu/core/so3.py:kabsch_rotation is
// plain XLA, which fuses its element-wise steps; the port's plain version
// (core/so3.kabsch_rotation_plain) runs them as separate PyTorch kernels,
// about 36 a Jacobi rotation: 730 launches a call at 3 sweeps, 1,378 at 6,
// whatever the batch. ICP's umeyama update, the consensus refit and polish
// and the closed-form UME estimator call it (about 105k launches a served
// batch of 8 pairs).
//
// Same bits as the plain version on the card. Every fp32 step is the
// operation PyTorch's separate element-wise kernel performs, written as a
// rounded intrinsic so that nvcc's contraction cannot fuse two of them
// into one FMA; atan2f, cosf, sinf and sqrtf are the library functions
// PyTorch's kernels call (no fast-math forms). The two small reductions
// follow the order PyTorch's reduce kernel takes over a contiguous
// (..., 3, 3) / (..., 4) input: lanes of block_width = 8 / 4 threads
// hold the products (lane 0 of the 9-sum also the ninth), then a warp
// shuffle tree with halving offsets (see sum9 and norm4). torch.argmax's
// rule: the first NaN wins, else the largest value, the lower index on a
// tie.
//
// Bound on the H100: one thread's chain of dependent operations. A matrix
// is 72 bytes in and out and ~80 fp32 operations and three library calls a
// rotation (18 rotations at 3 sweeps, 36 at 6), so at the main path's
// 8-20,000 matrices the card's throughput is never near its limit; each
// rotation waits on atan2f, then cosf / sinf, then its products.
//
// Design: one thread owns one matrix, K and V (32 floats) in registers.
// Each of the six rotations of a sweep is a template instance on its pair
// (p, r), so every register index is a compile-time constant; the sweeps
// are a loop. R is written (n, 3, 3) on the caller's stream.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // matrices a block, one a thread

// one rotation zeroing A[p][r], as core/so3._jacobi_rotate: rows p and r
// from the old rows, then columns p and r of the result, then V's columns
template <int P, int R>
__device__ __forceinline__ void rotate(float (&A)[4][4], float (&V)[4][4]) {
  const float theta = __fmul_rn(
      0.5f, atan2f(__fmul_rn(2.f, A[P][R]), __fsub_rn(A[R][R], A[P][P])));
  const float c = cosf(theta);
  const float s = sinf(theta);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float rp = A[P][j], rr = A[R][j];
    A[P][j] = __fsub_rn(__fmul_rn(c, rp), __fmul_rn(s, rr));
    A[R][j] = __fadd_rn(__fmul_rn(s, rp), __fmul_rn(c, rr));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float cp = A[i][P], cr = A[i][R];
    A[i][P] = __fsub_rn(__fmul_rn(c, cp), __fmul_rn(s, cr));
    A[i][R] = __fadd_rn(__fmul_rn(s, cp), __fmul_rn(c, cr));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float vp = V[i][P], vr = V[i][R];
    V[i][P] = __fsub_rn(__fmul_rn(c, vp), __fmul_rn(s, vr));
    V[i][R] = __fadd_rn(__fmul_rn(s, vp), __fmul_rn(c, vr));
  }
}

// torch.sum(H * H, dim=(-2, -1)) of one contiguous 3x3: lane x of 8 holds
// e[x] (lane 0: e[0] + e[8]), then offsets 4, 2, 1
__device__ __forceinline__ float sum9(const float (&e)[9]) {
  const float l0 = __fadd_rn(e[0], e[8]);
  const float a0 = __fadd_rn(l0, e[4]), a1 = __fadd_rn(e[1], e[5]);
  const float a2 = __fadd_rn(e[2], e[6]), a3 = __fadd_rn(e[3], e[7]);
  return __fadd_rn(__fadd_rn(a0, a2), __fadd_rn(a1, a3));
}

// torch.linalg.vector_norm(q, dim=-1)'s sum of one (4,): lane x of 4 holds
// q[x]^2, then offsets 2, 1
__device__ __forceinline__ float norm4(const float (&q)[4]) {
  const float s0 = __fadd_rn(__fmul_rn(q[0], q[0]), __fmul_rn(q[2], q[2]));
  const float s1 = __fadd_rn(__fmul_rn(q[1], q[1]), __fmul_rn(q[3], q[3]));
  return sqrtf(__fadd_rn(s0, s1));
}

__global__ void __launch_bounds__(kThreads)
kabsch_kernel(const float* __restrict__ H, float* __restrict__ Rout,
              int64_t n, int sweeps) {
  const int64_t m = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (m >= n) return;
  float h[9], e[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    h[k] = H[m * 9 + k];
    e[k] = __fmul_rn(h[k], h[k]);
  }
  const float scale = __fadd_rn(sqrtf(sum9(e)), 1e-30f);
  float S[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) S[k] = __fdiv_rn(h[k], scale);
  const float sxx = S[0], sxy = S[1], sxz = S[2];
  const float syx = S[3], syy = S[4], syz = S[5];
  const float szx = S[6], szy = S[7], szz = S[8];
  // Horn's matrix, each entry in the plain version's order of operations
  float A[4][4] = {
      {__fadd_rn(__fadd_rn(sxx, syy), szz), __fsub_rn(syz, szy),
       __fsub_rn(szx, sxz), __fsub_rn(sxy, syx)},
      {__fsub_rn(syz, szy), __fsub_rn(__fsub_rn(sxx, syy), szz),
       __fadd_rn(sxy, syx), __fadd_rn(szx, sxz)},
      {__fsub_rn(szx, sxz), __fadd_rn(sxy, syx),
       __fsub_rn(__fadd_rn(-sxx, syy), szz), __fadd_rn(syz, szy)},
      {__fsub_rn(sxy, syx), __fadd_rn(szx, sxz), __fadd_rn(syz, szy),
       __fadd_rn(__fsub_rn(-sxx, syy), szz)}};
  float V[4][4] = {{1.f, 0.f, 0.f, 0.f},
                   {0.f, 1.f, 0.f, 0.f},
                   {0.f, 0.f, 1.f, 0.f},
                   {0.f, 0.f, 0.f, 1.f}};
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    // core/so3._PAIRS, in its order
    rotate<0, 1>(A, V);
    rotate<0, 2>(A, V);
    rotate<0, 3>(A, V);
    rotate<1, 2>(A, V);
    rotate<1, 3>(A, V);
    rotate<2, 3>(A, V);
  }
  // torch.argmax over the diagonal: the first NaN, else the first maximum
  int best = 0;
  float wb = A[0][0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const float wi = A[i][i];
    if (!isnan(wb) && (isnan(wi) || wi > wb)) {
      best = i;
      wb = wi;
    }
  }
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = best == 0 ? V[i][0] : best == 1 ? V[i][1] : best == 2 ? V[i][2]
                                                                  : V[i][3];
  const float den = __fadd_rn(norm4(q), 1e-30f);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __fdiv_rn(q[i], den);
  // quat_to_rot, (w, x, y, z)
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
  const float xy = __fmul_rn(x, y), xz = __fmul_rn(x, z), yz = __fmul_rn(y, z);
  const float wx = __fmul_rn(w, x), wy = __fmul_rn(w, y), wz = __fmul_rn(w, z);
  float* out = Rout + m * 9;
  out[0] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(yy, zz)));
  out[1] = __fmul_rn(2.f, __fsub_rn(xy, wz));
  out[2] = __fmul_rn(2.f, __fadd_rn(xz, wy));
  out[3] = __fmul_rn(2.f, __fadd_rn(xy, wz));
  out[4] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(xx, zz)));
  out[5] = __fmul_rn(2.f, __fsub_rn(yz, wx));
  out[6] = __fmul_rn(2.f, __fsub_rn(xz, wy));
  out[7] = __fmul_rn(2.f, __fadd_rn(yz, wx));
  out[8] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(xx, yy)));
}

}  // namespace

// H (n, 3, 3) f32, contiguous -> R (n, 3, 3) f32; sweeps >= 0 cyclic
// Jacobi sweeps. n = 0 launches nothing.
UMR_EXPORT int umr_kabsch_rotation(const float* H, float* R, long long n,
                                   int sweeps, void* stream) {
  if (n < 0 || sweeps < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kabsch_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(H, R, n, sweeps);
  return static_cast<int>(cudaGetLastError());
}
