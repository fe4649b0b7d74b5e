// Shared helpers for the port's kernels (plain C interface, no PyTorch
// headers): exact distances, and the tensor-core pieces of the conv
// kernels (mma.sync m16n8k16 with bf16 operands and fp32 sums, ldmatrix,
// cp.async, bf16 row copies). Distances are written with explicitly
// rounded intrinsics so that nvcc's FMA contraction cannot make them
// differ from the plain PyTorch versions, which round after every
// operation.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define UMR_EXPORT extern "C" __attribute__((visibility("default")))

// ((a0-b0)^2 + (a1-b1)^2) + (a2-b2)^2, each operation rounded to nearest:
// the exact op order of the plain versions (sum over c = 0, 1, 2).
__device__ __forceinline__ float umr_sqdist3(float a0, float a1, float a2,
                                             float b0, float b1, float b2) {
  const float d0 = __fsub_rn(a0, b0);
  const float d1 = __fsub_rn(a1, b1);
  const float d2 = __fsub_rn(a2, b2);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                   __fmul_rn(d2, d2));
}

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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// 16 bytes global -> shared; bytes 0 zero-fills the destination
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

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

// y[r][c] = bf16(x[r][c]) for c < C, 0 for C <= c < round8(C): one
// thread an 8-value (16-byte) piece t of the (rows, round8(C)) copy.
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
