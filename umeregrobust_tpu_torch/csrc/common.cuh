// Shared helpers for the port's kernels (plain C interface, no PyTorch
// headers). Distances are written with explicitly rounded intrinsics so
// that nvcc's FMA contraction cannot make them differ from the plain
// PyTorch versions, which round after every operation.
#pragma once
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
