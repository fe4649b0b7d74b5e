// The grouped conv's row order as it stood before its one-launch redesign
// (three launches a map: count, a one-block scan, place), kept as a
// yardstick: chip_smoke.py builds it and times it in the same call beside
// ../grouped_row_order.cu (the grouped_row_order line's `parent_kernel_ms`).
// Not part of the kernel library (ops/_build.py compiles csrc/*.cu only).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -Xcompiler -fPIC -shared -I csrc csrc/bench/grouped_row_order_parent.cu
// -o libgrouped_order_parent.so
// Its entry umr_bench_grouped_row_order_parent takes the arguments the
// library's entry took then (one map; scratch keys and hist from the
// caller).
//
// The row order of a grouped k=3 conv map (ops/sparse.GroupedMap), which
// the grouped conv kernel (sparse_conv_grouped.cu) reads its output rows
// through: the rows sorted by their used-group mask (key = sum over
// groups g whose window (g, row) has a slot that reads of 2^g, 9 bits),
// rows of one key in ascending row order (a stable counting sort), and
// each 64-row tile of the order's mask (the OR of its rows' keys: the
// groups the tile stages and multiplies). Built once a map: the pyramid
// builds it beside the map (models/resunet.build_unet_geometry), and the
// conv's wrapper for a map that has none.
//
// Replaces no TPU kernel: it is the grouped conv's tile plan (the conv
// replaces tools/exp_gather2.py `pg`'s window gathers). The first grouped
// conv kernel voted each 128-row tile's groups in code order inside every
// launch, and a transposed conv's tiles then used nearly all 9 groups
// while each row uses one or two.
//
// Bound on the H100: the map's masks and patho bytes read once (36 bytes
// a row) and the order (4 bytes a row) and tiles written once, at
// 3.35 TB/s: about a microsecond at 32768 rows; the three launches' own
// latency sets the time.
//
// Design: three launches, no float and no order-dependent atomics:
//  - count: a block a 1024-row segment computes its rows' keys (written
//    to int16 scratch) and its histogram of the 512 keys in shared
//    memory (integer atomics: the counts do not depend on their order),
//    written key-major (hist[key][segment]); it also zeroes its tiles;
//  - scan: one block turns the key-major histogram into exclusive
//    offsets (each thread a contiguous run, then a block scan);
//  - place: a block a segment, 8 warps of 128 rows: each warp's
//    histogram, the warps' offsets per key, then each warp places its
//    rows 32 at a time in row order (__match_any_sync ranks the lanes of
//    one key), and ORs each row's key into its tile's mask (an integer
//    atomic OR: order-free).
#include "common.cuh"
#include "grouped_window.cuh"

namespace {

constexpr int kTileRows = 64;     // rows a tile of the conv kernel (kBM)
constexpr int kKeys = 512;        // 9-bit used-group masks
constexpr int kSegRows = 1024;    // rows a histogram segment
constexpr int kCountThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kPlaceWarps = 8;    // kSegRows / 128 rows a warp
static_assert(kPlaceWarps * 128 == kSegRows, "warps cover a segment");

__device__ __forceinline__ int row_key(const unsigned char* __restrict__ masks,
                                       const unsigned char* __restrict__ patho,
                                       int64_t row, int64_t N_out) {
  int key = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
    if (window_used(masks, patho, g, row, N_out)) key |= 1 << g;
  return key;
}

__global__ void __launch_bounds__(kCountThreads)
    order_count_kernel(const unsigned char* __restrict__ masks,
                       const unsigned char* __restrict__ patho,
                       int64_t N_out, int nseg,
                       unsigned short* __restrict__ keys,
                       int* __restrict__ hist, int* __restrict__ tiles,
                       int64_t n_tiles) {
  __shared__ int h[kKeys];
  const int tid = threadIdx.x;
  for (int k = tid; k < kKeys; k += kCountThreads) h[k] = 0;
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.x * kSegRows;
  for (int i = tid; i < kSegRows; i += kCountThreads) {
    const int64_t r = r0 + i;
    if (r >= N_out) break;
    const int key = row_key(masks, patho, r, N_out);
    keys[r] = (unsigned short)key;
    atomicAdd(&h[key], 1);
  }
  const int64_t t0 = (int64_t)blockIdx.x * (kSegRows / kTileRows);
  if (tid < kSegRows / kTileRows && t0 + tid < n_tiles) tiles[t0 + tid] = 0;
  __syncthreads();
  for (int k = tid; k < kKeys; k += kCountThreads)
    hist[(int64_t)k * nseg + blockIdx.x] = h[k];
}

// Exclusive scan of hist[0, L) in place, one block.
__global__ void __launch_bounds__(kScanThreads)
    order_scan_kernel(int* __restrict__ hist, int64_t L) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t per = (L + kScanThreads - 1) / kScanThreads;
  const int64_t lo = tid * per, hi = lo + per < L ? lo + per : L;
  int sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += hist[i];
  int incl = sum;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int64_t i = lo; i < hi; ++i) {
    const int v = hist[i];
    hist[i] = run;
    run += v;
  }
}

__global__ void __launch_bounds__(kPlaceWarps * 32)
    order_place_kernel(const unsigned short* __restrict__ keys,
                       const int* __restrict__ hist, int64_t N_out, int nseg,
                       int* __restrict__ order, int* __restrict__ tiles) {
  __shared__ int cnt[kPlaceWarps][kKeys];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < kPlaceWarps * kKeys; e += kPlaceWarps * 32)
    cnt[e / kKeys][e % kKeys] = 0;
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.x * kSegRows + warp * 128;
  for (int c = 0; c < 4; ++c) {
    const int64_t r = r0 + 32 * c + lane;
    if (r < N_out) atomicAdd(&cnt[warp][keys[r]], 1);
  }
  __syncthreads();
  for (int k = tid; k < kKeys; k += kPlaceWarps * 32) {
    int base = hist[(int64_t)k * nseg + blockIdx.x];
    for (int w = 0; w < kPlaceWarps; ++w) {
      const int n = cnt[w][k];
      cnt[w][k] = base;
      base += n;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < 4; ++c) {
    const int64_t r = r0 + 32 * c + lane;
    const bool valid = r < N_out;
    const int key = valid ? (int)keys[r] : kKeys + lane;  // alone if not
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (valid) {
      const int64_t pos = cnt[warp][key] + __popc(peers & below);
      order[pos] = (int)r;
      atomicOr(&tiles[pos / kTileRows], key);
    }
    __syncwarp();
    if (valid && lane == 31 - __clz(peers))  // the group's last lane
      cnt[warp][key] += __popc(peers);
    __syncwarp();
  }
}

}  // namespace

// The row order of a grouped map with N_out rows: masks (9, 3, N_out) and
// patho (9, N_out) bool bytes -> order (N_out,) int32 (rows by used-group
// mask, stable) and tiles (ceil(N_out / 64),) int32 (each 64-row tile's
// groups); scratch keys (N_out,) int16 and hist (512 ceil(N_out / 1024),)
// int32 from the caller. Three launches.
UMR_EXPORT int umr_bench_grouped_row_order_parent(const unsigned char* masks,
                                                 const unsigned char* patho,
                                                 void* keys, int* hist,
                                                 int* order, int* tiles,
                                                 long long N_out,
                                                 void* stream) {
  if (N_out < 1 || N_out >= (1ll << 31) - kSegRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nseg = (int)((N_out + kSegRows - 1) / kSegRows);
  const int64_t n_tiles = (N_out + kTileRows - 1) / kTileRows;
  unsigned short* k16 = static_cast<unsigned short*>(keys);
  order_count_kernel<<<nseg, kCountThreads, 0, st>>>(masks, patho, N_out,
                                                     nseg, k16, hist, tiles,
                                                     n_tiles);
  order_scan_kernel<<<1, kScanThreads, 0, st>>>(hist,
                                                (int64_t)kKeys * nseg);
  order_place_kernel<<<nseg, kPlaceWarps * 32, 0, st>>>(k16, hist, N_out,
                                                        nseg, order, tiles);
  return static_cast<int>(cudaGetLastError());
}
