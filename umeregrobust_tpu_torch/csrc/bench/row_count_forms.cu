// The count and placement of gather_rows_backward's counting sort in three
// forms, built and timed by chip_smoke.py (gather_backward_shape's
// `count_forms`); not part of the kernel library (ops/_build.py compiles
// csrc/*.cu only). Build: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -Xcompiler -fPIC -shared -I csrc
// csrc/bench/row_count_forms.cu -o librow_count_forms.so
//   form 0: gather_rows.cu's own: one integer atomic a position on its
//           row's count, whose old value is the position's rank; the
//           placement writes start + rank, no atomics;
//   form 1: the count's atomic warp-aggregated: __match_any_sync groups a
//           warp's lanes by row, one lane adds the group's size, each
//           lane's rank is the old value plus its peers below it; the
//           placement as in form 0;
//   form 2: plain atomics in both: the count stores no rank, the
//           placement takes its slot from a second atomic on a copy of
//           the starts.
// The ranks of every form depend on the order the blocks run in, so each
// ends with the same segment sort and gives the same segments.
#include "../gather_rows.cu"

namespace {

template <typename IdxT>
__global__ void __launch_bounds__(kSegThreads)
    count_aggregated_kernel(const IdxT* __restrict__ idx, int64_t M, int N,
                            int* __restrict__ cnt, int* __restrict__ rank) {
  const int64_t i = (int64_t)blockIdx.x * kSegThreads + threadIdx.x;
  const int key = row_key(idx, i, M, N);
  const unsigned active = __ballot_sync(0xffffffffu, key >= 0);
  if (key < 0) return;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(active, key);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cnt + key, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  rank[i] = base + __popc(peers & ((1u << lane) - 1u));
}

template <typename IdxT>
__global__ void __launch_bounds__(kSegThreads)
    count_plain_kernel(const IdxT* __restrict__ idx, int64_t M, int N,
                       int* __restrict__ cnt) {
  const int64_t i = (int64_t)blockIdx.x * kSegThreads + threadIdx.x;
  const int key = row_key(idx, i, M, N);
  if (key >= 0) atomicAdd(cnt + key, 1);
}

template <typename IdxT>
__global__ void __launch_bounds__(kSegThreads)
    place_atomic_kernel(const IdxT* __restrict__ idx, int64_t M, int N,
                        int* __restrict__ cursor, int* __restrict__ pos) {
  const int64_t i = (int64_t)blockIdx.x * kSegThreads + threadIdx.x;
  const int key = row_key(idx, i, M, N);
  if (key >= 0) pos[atomicAdd(cursor + key, 1)] = (int)i;
}

template <typename IdxT>
int run_form(const void* idx, int* ints, int* cursor, int M, int N, int form,
             int stop, cudaStream_t st) {
  const int n = N + 1;
  const int T = (n + kScanTile - 1) / kScanTile;
  int* cnt = ints;
  int* starts = cnt + n;
  int* tile_sum = starts + n;
  int* pos = tile_sum + T;
  int* tmp = pos + M;
  const IdxT* ix = static_cast<const IdxT*>(idx);
  const unsigned pblocks =
      (unsigned)(((int64_t)M + kSegThreads - 1) / kSegThreads);
  cudaError_t e = cudaMemsetAsync(cnt, 0, (size_t)n * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (form == 0)
    seg_count_kernel<IdxT><<<pblocks, kSegThreads, 0, st>>>(ix, M, N, cnt, tmp);
  else if (form == 1)
    count_aggregated_kernel<IdxT><<<pblocks, kSegThreads, 0, st>>>(ix, M, N,
                                                                  cnt, tmp);
  else
    count_plain_kernel<IdxT><<<pblocks, kSegThreads, 0, st>>>(ix, M, N, cnt);
  if (stop == 0) return 0;
  seg_tile_sum_kernel<<<T, kSegThreads, 0, st>>>(cnt, n, tile_sum);
  seg_tile_scan_kernel<<<1, kTileScanThreads, 0, st>>>(tile_sum, T);
  seg_scan_kernel<<<T, kSegThreads, 0, st>>>(cnt, n, tile_sum, starts);
  if (form == 2) {
    e = cudaMemcpyAsync(cursor, starts, (size_t)N * sizeof(int),
                        cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return (int)e;
    place_atomic_kernel<IdxT><<<pblocks, kSegThreads, 0, st>>>(ix, M, N,
                                                              cursor, pos);
  } else {
    seg_place_kernel<IdxT><<<pblocks, kSegThreads, 0, st>>>(ix, M, N, starts,
                                                           tmp, pos);
  }
  if (stop == 1) return 0;
  const int64_t sblocks = ((int64_t)N + kSegThreads - 1) / kSegThreads;
  seg_sort_kernel<<<(unsigned)sblocks, kSegThreads, 0, st>>>(starts, pos, tmp,
                                                            N);
  return 0;
}

}  // namespace

// idx (M,) int32 / int64 (idx64), ints as umr_row_segments' scratch,
// cursor (N,) int32 (form 2): `form` 0-2 up to `stop` (0: the count; 1:
// count, scan and placement; 2: and the segment sort, as umr_row_segments).
UMR_EXPORT int umr_bench_row_count(const void* idx, int* ints, int* cursor,
                                   int M, int N, int idx64, int form,
                                   int stop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || M < 1 || form < 0 || form > 2 || stop < 0 || stop > 2)
    return (int)cudaErrorInvalidValue;
  const int code =
      idx64 ? run_form<int64_t>(idx, ints, cursor, M, N, form, stop, st)
            : run_form<int32_t>(idx, ints, cursor, M, N, form, stop, st);
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}
