// Row gather: out[i] = table[idx[i]], a zero row where idx[i] < 0, and
// its backward, the scatter-add of the output's cotangent into the table.
//
// Replaces: tools/exp_gather2.py, pg (body kern): the Pallas probe of
// Mosaic's dynamic gather, the row gather inside
// umeregrobust_tpu/ops/neighbors.py gather_padded.
//
// Bound on the H100: bytes. The function reads M rows of C elements and
// M indices and writes M rows; it does no arithmetic.
//
// Design: one thread per 16-byte piece of an output row when the row
// size and the pointers allow it (neighbouring threads on neighbouring
// addresses of one row, so a warp reads and writes whole 128-byte
// lines), one thread per element otherwise. A row index is read by every
// thread of its row (served from L1). An index outside [0, N) yields a
// zero row, so nothing is read out of bounds.
//
// Backward (gather_rows_backward): dtable[r] = the sum, over the positions
// i with idx[i] == r in ascending i, of dout[i]. Bound: bytes (each
// cotangent row read once, each table row written once, the sorted
// positions read once). Design: the wrapper sorts the indices once
// (torch.sort, stable) and finds each row's segment of the sorted
// positions (searchsorted); a warp owns a destination row, its lanes the
// columns, and adds the row's cotangents in ascending position, 8 loads in
// flight before the adds. No float atomics: two launches give the same
// bits, and they are the bits of a sequential index_add_ on the CPU.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename IdxT>
__global__ void gather_rows_vec16(const uint4* __restrict__ table,
                                  const IdxT* __restrict__ idx,
                                  uint4* __restrict__ out, int64_t M,
                                  int64_t N, int pieces) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= M * pieces) return;
  const int64_t row = t / pieces;
  const int piece = (int)(t - row * pieces);
  const int64_t src = (int64_t)idx[row];
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (src >= 0 && src < N) v = table[src * pieces + piece];
  out[t] = v;
}

template <typename T, typename IdxT>
__global__ void gather_rows_scalar(const T* __restrict__ table,
                                   const IdxT* __restrict__ idx,
                                   T* __restrict__ out, int64_t M, int64_t N,
                                   int C) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= M * C) return;
  const int64_t row = t / C;
  const int c = (int)(t - row * C);
  const int64_t src = (int64_t)idx[row];
  T v = 0;
  if (src >= 0 && src < N) v = table[src * C + c];
  out[t] = v;
}

template <typename IdxT>
void launch(const void* table, const void* idx, void* out, int64_t M,
            int64_t N, int C, int elem_bytes, int vec16, cudaStream_t st) {
  const IdxT* ix = static_cast<const IdxT*>(idx);
  if (vec16) {
    const int pieces = C * elem_bytes / 16;
    const int64_t blocks = (M * pieces + kThreads - 1) / kThreads;
    gather_rows_vec16<IdxT><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(table), ix, static_cast<uint4*>(out), M, N,
        pieces);
  } else {
    const int64_t blocks = (M * C + kThreads - 1) / kThreads;
    if (elem_bytes == 4) {
      gather_rows_scalar<uint32_t, IdxT><<<(unsigned)blocks, kThreads, 0, st>>>(
          static_cast<const uint32_t*>(table), ix, static_cast<uint32_t*>(out),
          M, N, C);
    } else {
      gather_rows_scalar<uint16_t, IdxT><<<(unsigned)blocks, kThreads, 0, st>>>(
          static_cast<const uint16_t*>(table), ix, static_cast<uint16_t*>(out),
          M, N, C);
    }
  }
}

constexpr int kLoads = 8;  // cotangent rows in flight a lane

__global__ void gather_rows_backward_kernel(const float* __restrict__ dout,
                                            const int64_t* __restrict__ perm,
                                            const int64_t* __restrict__ starts,
                                            float* __restrict__ dtable,
                                            int64_t N, int C) {
  const int64_t r = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= N) return;  // whole warps leave together
  const int64_t s0 = starts[r], s1 = starts[r + 1];
  for (int c = lane; c < C; c += 32) {
    float acc = 0.f;
    int64_t e = s0;
    for (; e + kLoads <= s1; e += kLoads) {
      float v[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) v[j] = dout[perm[e + j] * C + c];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) acc += v[j];
    }
    for (; e < s1; ++e) acc += dout[perm[e] * C + c];
    dtable[r * C + c] = acc;
  }
}

}  // namespace

// table (N, C) of 4-byte (fp32) or 2-byte (bf16) elements, idx (M,) int32
// or int64 (idx64) -> out (M, C). vec16: rows are a multiple of 16 bytes
// and both pointers are 16-byte aligned.
UMR_EXPORT int umr_gather_rows(const void* table, const void* idx, void* out,
                               int M, int N, int C, int elem_bytes, int idx64,
                               int vec16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes != 4 && elem_bytes != 2) return (int)cudaErrorInvalidValue;
  if (idx64) {
    launch<int64_t>(table, idx, out, M, N, C, elem_bytes, vec16, st);
  } else {
    launch<int32_t>(table, idx, out, M, N, C, elem_bytes, vec16, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// dout (M, C) f32; perm (M,) int64: positions in stable order of their
// index (rows outside [0, N) last); starts (N + 1,) int64: row r's
// positions are perm[starts[r] .. starts[r + 1]) -> dtable (N, C) f32,
// every row written.
UMR_EXPORT int umr_gather_rows_backward(const float* dout, const int64_t* perm,
                                        const int64_t* starts, float* dtable,
                                        int N, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = ((int64_t)N * 32 + kThreads - 1) / kThreads;
  gather_rows_backward_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      dout, perm, starts, dtable, N, C);
  return static_cast<int>(cudaGetLastError());
}
