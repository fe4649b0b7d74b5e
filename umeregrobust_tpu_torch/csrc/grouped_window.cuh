// The grouped-window map of a k=3 conv (ops/sparse.GroupedMap), as the
// grouped conv's forward (sparse_conv_grouped.cu) and its weight gradient
// (sparse_conv_grouped_wgrad.cu) read it.
#pragma once
#include <stdint.h>

constexpr int kGroups = 9;

// The 3 input rows of window (g, row), -1 where the slot reads zeros:
// with c = center[g, row] - 1, slot 0 reads row c - 1 if masks[g, 0, row],
// slot 1 row c if masks[g, 1, row], slot 2 row c + 1 if masks[g, 2, row],
// else row c if patho[g, row]; a row outside [0, N_in) reads zeros.
template <typename IdxT>
__device__ __forceinline__ void window_rows(
    const IdxT* __restrict__ center, const unsigned char* __restrict__ masks,
    const unsigned char* __restrict__ patho, int g, int64_t row,
    int64_t N_in, int64_t N_out, int (&src)[3]) {
  const int64_t c = (int64_t)center[(int64_t)g * N_out + row] - 1;
  const unsigned char* m = masks + (int64_t)g * 3 * N_out + row;
  int64_t r[3] = {m[0] ? c - 1 : -1, m[N_out] ? c : -1,
                  m[2 * N_out] ? c + 1
                               : (patho[(int64_t)g * N_out + row] ? c : -1)};
#pragma unroll
  for (int s = 0; s < 3; ++s)
    src[s] = (r[s] >= 0 && r[s] < N_in) ? (int)r[s] : -1;
}

// Whether window (g, row) has a slot that reads (its mask or patho bit).
__device__ __forceinline__ bool window_used(
    const unsigned char* __restrict__ masks,
    const unsigned char* __restrict__ patho, int g, int64_t row,
    int64_t N_out) {
  const unsigned char* m = masks + (int64_t)g * 3 * N_out + row;
  return (m[0] | m[N_out] | m[2 * N_out] | patho[(int64_t)g * N_out + row])
         != 0;
}
