// Row gather: out[i] = table[idx[i]], a zero row where idx[i] < 0, and
// its backward, the scatter-add of the output's cotangent into the table.
//
// Replaces: tools/exp_gather2.py, pg (body kern): the Pallas probe of
// Mosaic's dynamic gather, the row gather inside
// umeregrobust_tpu/ops/neighbors.py gather_padded. The backward replaces
// what JAX's autodiff makes of that gather (a scatter-add), and so of the
// gathers of tools/exp_pallas_gather.py:74,107 as well.
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
// i with idx[i] == r in ascending i, of dout[i]; an index outside [0, N)
// adds nothing. Bound: bytes (the valid positions' cotangent rows read
// once, the indices read once, each table row written once). What bounded
// the first port was not its summing kernel but the library sort in front
// of it (a stable radix sort of M int64 keys over all 64 bits, a
// searchsorted of N + 1 values, an int64 permutation): three quarters of
// the function's time. The design sorts with a counting sort over the
// key's own range [0, N), in 32-bit integers, all of it here:
//  - count: one thread a position, an integer atomic on its row's count
//    whose old value is the position's rank among its row's arrivals
//    (a count does not depend on the order of its adds; the ranks do);
//  - scan: the exclusive prefix of the N + 1 counts gives each row's
//    segment start directly (tile sums, one block scans them, tiles
//    scanned with their offset);
//  - place: each valid position written at its row's start plus its
//    rank, no atomics. The order inside a segment then depends on the
//    order the count's blocks ran in, so
//  - sort: a warp sorts each segment of its 32 rows in turn (the rows
//    with fewer than two positions skipped by one ballot), in registers
//    (bitonic over 32, 128 or 512 values, the warp's lanes by shuffles, a
//    lane's values in registers); a longer segment is sorted in runs of
//    512 and merged in rounds (each value finds its slot by a binary
//    search in the other run), through a scratch twin of the positions.
//    Ranks that do not depend on block order would need per-block counts
//    of every row; sorting the short segments afterwards costs less (the
//    UME gathers of a training step: 18.8 positions a row, 130 at most;
//    the window gathers of the grouped convs: 3 at most);
//  - sum: G lanes a row (G = 4-32, as many as the row has 16-byte pieces,
//    or elements where C * 4 is no multiple of 16), 8 cotangent reads a
//    lane in flight, added in ascending position.
// No float atomics and no library sort: two launches give the same bits,
// the bits of a sequential index_add_ on the CPU. umr_row_segments stops
// after the sort (a check of the segments against their plain version).
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

// ---------------------------------------------------------------------
// Backward. Scratch (int32, from the wrapper): cnt[N + 1], starts[N + 1],
// tile_sum[T] (T = ceil((N + 1) / kScanTile)), pos[M], tmp[M] (the
// ranks, then the long segments' merge twin).
constexpr int kSegThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kSegThreads * kScanItems;  // values a scan block
constexpr int kTileScanThreads = 1024;
constexpr int kSumLoads = 8;  // cotangent reads a lane in flight

template <typename IdxT>
__device__ __forceinline__ int row_key(const IdxT* __restrict__ idx,
                                       int64_t i, int64_t M, int N) {
  if (i >= M) return -1;
  const int64_t v = (int64_t)idx[i];
  return (v >= 0 && v < N) ? (int)v : -1;
}

// cnt[r] = the positions with key r; rank[i] = position i's arrival among
// them (integer atomics: the counts do not depend on the order of the
// adds, the ranks do, and the segment sort below makes that order moot).
template <typename IdxT>
__global__ void __launch_bounds__(kSegThreads)
    seg_count_kernel(const IdxT* __restrict__ idx, int64_t M, int N,
                     int* __restrict__ cnt, int* __restrict__ rank) {
  const int64_t i = (int64_t)blockIdx.x * kSegThreads + threadIdx.x;
  const int key = row_key(idx, i, M, N);
  if (key >= 0) rank[i] = atomicAdd(cnt + key, 1);
}

// Exclusive scan of the block's kScanTile values in shared memory s
// (padded: value p at s[p + p / 32]); returns the tile's total.
__device__ __forceinline__ int block_scan_tile(int* s) {
  __shared__ int s_warp[kSegThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int run = 0;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    const int p = tid * kScanItems + u;
    run += s[p + p / 32];
  }
  int inc = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int q = 0; q < kSegThreads / 32; ++q) {
    const int v = s_warp[q];
    before += q < warp ? v : 0;
    total += v;
  }
  int ex = before + inc - run;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    const int p = tid * kScanItems + u;
    const int v = s[p + p / 32];
    s[p + p / 32] = ex;
    ex += v;
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kSegThreads)
    seg_tile_sum_kernel(const int* __restrict__ cnt, int n,
                        int* __restrict__ tile_sum) {
  __shared__ int s_red[kSegThreads / 32];
  const int64_t base = (int64_t)blockIdx.x * kScanTile;
  int v = 0;
  for (int u = 0; u < kScanItems; ++u) {
    const int64_t j = base + u * kSegThreads + threadIdx.x;
    if (j < n) v += cnt[j];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int q = 0; q < kSegThreads / 32; ++q) t += s_red[q];
    tile_sum[blockIdx.x] = t;
  }
}

// One block: the exclusive scan of the T tile sums, in place.
__global__ void __launch_bounds__(kTileScanThreads)
    seg_tile_scan_kernel(int* __restrict__ tile_sum, int T) {
  __shared__ int s_warp[kTileScanThreads / 32];
  __shared__ int s_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_carry = 0;
  __syncthreads();
  for (int j0 = 0; j0 < T; j0 += kTileScanThreads) {
    const int j = j0 + tid;
    const int v = j < T ? tile_sum[j] : 0;
    int inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    int before = s_carry, total = 0;
    for (int q = 0; q < kTileScanThreads / 32; ++q) {
      before += q < warp ? s_warp[q] : 0;
      total += s_warp[q];
    }
    if (j < T) tile_sum[j] = before + inc - v;
    __syncthreads();  // every thread has read s_warp and s_carry
    if (tid == 0) s_carry += total;
    __syncthreads();
  }
}

// starts[j] = the exclusive prefix of cnt at j (j <= N).
__global__ void __launch_bounds__(kSegThreads)
    seg_scan_kernel(const int* __restrict__ cnt, int n,
                    const int* __restrict__ tile_sum,
                    int* __restrict__ starts) {
  __shared__ int s[kScanTile + kScanTile / 32];
  const int64_t base = (int64_t)blockIdx.x * kScanTile;
  for (int u = 0; u < kScanItems; ++u) {
    const int p = u * kSegThreads + threadIdx.x;
    const int64_t j = base + p;
    s[p + p / 32] = j < n ? cnt[j] : 0;
  }
  __syncthreads();
  block_scan_tile(s);
  const int off = tile_sum[blockIdx.x];
  for (int u = 0; u < kScanItems; ++u) {
    const int p = u * kSegThreads + threadIdx.x;
    const int64_t j = base + p;
    if (j < n) starts[j] = off + s[p + p / 32];
  }
}

template <typename IdxT>
__global__ void __launch_bounds__(kSegThreads)
    seg_place_kernel(const IdxT* __restrict__ idx, int64_t M, int N,
                     const int* __restrict__ starts,
                     const int* __restrict__ rank, int* __restrict__ pos) {
  const int64_t i = (int64_t)blockIdx.x * kSegThreads + threadIdx.x;
  const int key = row_key(idx, i, M, N);
  if (key >= 0) pos[starts[key] + rank[i]] = (int)i;
}

// Bitonic sort, ascending, of the warp's 32 E values: value e of lane l
// is element e * 32 + l. Distances below 32 exchange across lanes, the
// others inside a lane's registers.
template <int E>
__device__ __forceinline__ void warp_bitonic(int (&v)[E]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        const int jr = j / 32;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & jr) continue;
          const bool up = (((e * 32 + lane) & k) == 0);
          const int a = v[e], b = v[e | jr];
          const bool swap = up ? (a > b) : (a < b);
          v[e] = swap ? b : a;
          v[e | jr] = swap ? a : b;
        }
      } else {
        const bool lower = (lane & j) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const bool up = (((e * 32 + lane) & k) == 0);
          const int o = __shfl_xor_sync(0xffffffffu, v[e], j);
          v[e] = (lower == up) ? min(v[e], o) : max(v[e], o);
        }
      }
    }
  }
}

template <int E>
__device__ __forceinline__ void warp_sort_short(int* p, int L) {
  const int lane = threadIdx.x & 31;
  int v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int a = e * 32 + lane;
    v[e] = a < L ? p[a] : 0x7fffffff;  // past every position
  }
  warp_bitonic<E>(v);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int a = e * 32 + lane;
    if (a < L) p[a] = v[e];
  }
}

// Values of the ascending run r[0, n) below x.
__device__ __forceinline__ int count_below(const int* r, int n, int x) {
  int lo = 0;
  while (n > 0) {
    const int h = n >> 1;
    if (r[lo + h] < x) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}

constexpr int kRun = 512;  // the register sort's longest segment

// A segment longer than kRun: runs of kRun sorted in registers, then
// merged in rounds between p and t (positions are distinct, so a value's
// slot is its rank in its own run plus the values below it in the other).
__device__ void warp_sort_long(int* p, int* t, int L) {
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < L; c += kRun)
    warp_sort_short<kRun / 32>(p + c, L - c < kRun ? L - c : kRun);
  __syncwarp();
  int* src = p;
  int* dst = t;
  for (int64_t w = kRun; w < L; w *= 2) {
    for (int a = lane; a < L; a += 32) {
      const int x = src[a];
      const int64_t q = a / w, b0 = (q & ~1ll) * w;
      int slot;
      if (q & 1) {
        slot = (int)(a - w + count_below(src + b0, (int)w, x));
      } else if (b0 + w >= L) {
        slot = a;
      } else {
        const int64_t end = b0 + 2 * w < L ? b0 + 2 * w : (int64_t)L;
        const int n = (int)(end - (b0 + w));
        slot = a + count_below(src + b0 + w, n, x);
      }
      dst[slot] = x;
    }
    __syncwarp();
    int* s = src;
    src = dst;
    dst = s;
  }
  if (src != p) {
    for (int a = lane; a < L; a += 32) p[a] = src[a];
  }
}

// A warp takes 32 rows: their segment lengths in one load a lane, then
// the rows with two positions or more one after another, each sorted by
// the whole warp (most rows of a window gather have none or one).
__global__ void __launch_bounds__(kSegThreads)
    seg_sort_kernel(const int* __restrict__ starts, int* pos, int* tmp,
                    int N) {
  const int64_t r0 = ((int64_t)blockIdx.x * kSegThreads + threadIdx.x) / 32 * 32;
  if (r0 >= N) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int64_t r = r0 + lane;
  int s0 = 0, L = 0;
  if (r < N) {
    s0 = starts[r];
    L = starts[r + 1] - s0;
  }
  unsigned todo = __ballot_sync(0xffffffffu, L > 1);
  while (todo) {
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    const int sj = __shfl_sync(0xffffffffu, s0, j);
    const int Lj = __shfl_sync(0xffffffffu, L, j);
    if (Lj <= 32) warp_sort_short<1>(pos + sj, Lj);
    else if (Lj <= 128) warp_sort_short<4>(pos + sj, Lj);
    else if (Lj <= kRun) warp_sort_short<kRun / 32>(pos + sj, Lj);
    else warp_sort_long(pos + sj, tmp + sj, Lj);
  }
}

__device__ __forceinline__ void add_piece(float& a, float b) { a += b; }
__device__ __forceinline__ void add_piece(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// G lanes a row, a lane a piece (T: float or float4) at a time, P pieces
// a row; the row's cotangents added in ascending position.
template <int G, typename T>
__global__ void __launch_bounds__(kSegThreads)
    seg_sum_kernel(const T* __restrict__ dout, const int* __restrict__ pos,
                   const int* __restrict__ starts, T* __restrict__ dtable,
                   int N, int P) {
  const int64_t r =
      ((int64_t)blockIdx.x * kSegThreads + threadIdx.x) / G;
  if (r >= N) return;
  const int g = threadIdx.x % G;
  const int s0 = starts[r], s1 = starts[r + 1];
  for (int c = g; c < P; c += G) {
    T acc = {};
    int e = s0;
    for (; e + kSumLoads <= s1; e += kSumLoads) {
      int src[kSumLoads];
#pragma unroll
      for (int j = 0; j < kSumLoads; ++j) src[j] = pos[e + j];
      T v[kSumLoads];
#pragma unroll
      for (int j = 0; j < kSumLoads; ++j) v[j] = dout[(int64_t)src[j] * P + c];
#pragma unroll
      for (int j = 0; j < kSumLoads; ++j) add_piece(acc, v[j]);
    }
    for (; e < s1; ++e) add_piece(acc, dout[(int64_t)pos[e] * P + c]);
    dtable[r * P + c] = acc;
  }
}

template <int G, typename T>
void launch_sum(const void* dout, const int* pos, const int* starts,
                void* dtable, int N, int P, cudaStream_t st) {
  const int64_t blocks = ((int64_t)N * G + kSegThreads - 1) / kSegThreads;
  seg_sum_kernel<G, T><<<(unsigned)blocks, kSegThreads, 0, st>>>(
      static_cast<const T*>(dout), pos, starts, static_cast<T*>(dtable), N,
      P);
}

template <typename T>
void launch_sum_pieces(const void* dout, const int* pos, const int* starts,
                       void* dtable, int N, int P, cudaStream_t st) {
  if (P <= 4) launch_sum<4, T>(dout, pos, starts, dtable, N, P, st);
  else if (P <= 8) launch_sum<8, T>(dout, pos, starts, dtable, N, P, st);
  else if (P <= 16) launch_sum<16, T>(dout, pos, starts, dtable, N, P, st);
  else launch_sum<32, T>(dout, pos, starts, dtable, N, P, st);
}

// Counting sort of the valid positions by row: starts and the sorted
// positions in the scratch (see above).
template <typename IdxT>
int row_segments(const void* idx, int* ints, int M, int N, cudaStream_t st) {
  const int n = N + 1;
  const int T = (n + kScanTile - 1) / kScanTile;
  int* cnt = ints;
  int* starts = cnt + n;
  int* tile_sum = starts + n;
  int* pos = tile_sum + T;
  int* tmp = pos + M;
  const IdxT* ix = static_cast<const IdxT*>(idx);
  cudaError_t e = cudaMemsetAsync(cnt, 0, (size_t)n * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const unsigned pblocks = (unsigned)(((int64_t)M + kSegThreads - 1) / kSegThreads);
  if (M > 0)
    seg_count_kernel<IdxT><<<pblocks, kSegThreads, 0, st>>>(ix, M, N, cnt,
                                                           tmp);
  seg_tile_sum_kernel<<<T, kSegThreads, 0, st>>>(cnt, n, tile_sum);
  seg_tile_scan_kernel<<<1, kTileScanThreads, 0, st>>>(tile_sum, T);
  seg_scan_kernel<<<T, kSegThreads, 0, st>>>(cnt, n, tile_sum, starts);
  if (M > 0) {
    seg_place_kernel<IdxT><<<pblocks, kSegThreads, 0, st>>>(ix, M, N, starts,
                                                           tmp, pos);
    const int64_t sblocks = ((int64_t)N + kSegThreads - 1) / kSegThreads;
    seg_sort_kernel<<<(unsigned)sblocks, kSegThreads, 0, st>>>(starts, pos,
                                                              tmp, N);
  }
  return 0;
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

// The row segments of idx (M,) int32 or int64 (idx64) over [0, N): ints
// (2 (N + 1) + ceil((N + 1) / 4096) + 2 M) int32 scratch, caller-
// allocated; on return ints[N + 1 .. 2 N + 2) holds starts (N + 1) and
// ints[2 (N + 1) + ceil((N + 1) / 4096) ..) the valid positions, each
// row's segment ascending.
UMR_EXPORT int umr_row_segments(const void* idx, int* ints, int M, int N,
                                int idx64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || M < 0) return (int)cudaErrorInvalidValue;
  const int code = idx64 ? row_segments<int64_t>(idx, ints, M, N, st)
                         : row_segments<int32_t>(idx, ints, M, N, st);
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

// dout (M, C) f32, idx (M,) int32 or int64 (idx64), ints the scratch of
// umr_row_segments -> dtable (N, C) f32, every row written. vec16: C * 4
// is a multiple of 16 and both pointers are 16-byte aligned.
UMR_EXPORT int umr_gather_rows_backward(const float* dout, const void* idx,
                                        int* ints, float* dtable, int M,
                                        int N, int C, int idx64, int vec16,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || C < 1 || M < 0) return (int)cudaErrorInvalidValue;
  const int code = idx64 ? row_segments<int64_t>(idx, ints, M, N, st)
                         : row_segments<int32_t>(idx, ints, M, N, st);
  if (code != 0) return code;
  const int n = N + 1;
  const int* starts = ints + n;
  const int* pos = ints + 2 * n + (n + kScanTile - 1) / kScanTile;
  if (vec16) launch_sum_pieces<float4>(dout, pos, starts, dtable, N, C / 4, st);
  else launch_sum_pieces<float>(dout, pos, starts, dtable, N, C, st);
  return static_cast<int>(cudaGetLastError());
}
