// The row order of a grouped k=3 conv map (ops/sparse.GroupedMap), which
// the grouped conv kernel (sparse_conv_grouped.cu) reads its output rows
// through: the rows sorted by their used-group mask (key = sum over
// groups g whose window (g, row) has a slot that reads of 2^g, 9 bits),
// rows of one key in ascending row order (a stable counting sort), and
// each 64-row tile of the order's mask (the OR of its rows' keys: the
// groups the tile stages and multiplies). Built once a map, all the maps
// of a pyramid in one launch: the pyramid builds them beside its maps
// (models/resunet.build_unet_geometry), and the conv's wrapper for a map
// that has none (a list of one).
//
// Replaces no TPU kernel: it is the grouped conv's tile plan (the conv
// replaces tools/exp_gather2.py `pg`'s window gathers).
//
// Bound on the H100: each map's masks and patho bytes read once (36 bytes
// a row) and the order (4 bytes a row) and tiles written once, at
// 3.35 TB/s: about 2 microseconds for the 13 maps of a one-pair
// ResUNetSmall2 pyramid (103,936 rows). The earlier form made three
// dependent launches a map (count, a one-block scan, place; 39 a
// pyramid), whose starts and drains set its time, and its one-block scan
// walked every segment's histogram of a map.
//
// Design: one launch for a list of up to kMaxMaps maps, a thread-block
// cluster of c CTAs a map (c fixed a launch: the wrapper's
// _ORDER_CLUSTER); the maps' descriptors travel by value in the kernel's
// parameters. No float and no order-dependent atomic:
//  1. CTA j of a map's cluster takes rows [j s, (j + 1) s) (s: a share of
//     whole 32-row steps) and computes their keys into shared memory
//     (four rows a thread from 4-byte loads where the map allows it;
//     a CTA whose share passes kKeyRows reads them again from the map
//     when it places them). Its 16 warps take the share in row order, a
//     run each, and count their keys (lanes of one key merged by
//     __match_any_sync, each warp its own histogram row: no atomic). A
//     thread a key turns the warps' counts into offsets within the CTA
//     and the CTA's histogram. cluster barrier.
//  2. A thread a key reads the key's count in every CTA of the cluster
//     (distributed shared memory): the map's count, and the rows of that
//     key in lower-ranked CTAs. A block scan over the 512 keys gives each
//     key's first place in the order; the warps' offsets become places.
//  3. Each warp places its rows 32 at a time in row order (lanes of one
//     key ranked by __match_any_sync), so the order is stable.
//  4. Tiles: the order is sorted by key, so tile t's mask is the OR of
//     the keys whose places meet [64 t, 64 t + 64): two binary searches
//     over the keys' first places and a walk between them. Each tile is
//     written once, by one thread of one CTA; nothing is zeroed first.
//  A last cluster barrier keeps every CTA until its peers have read its
//  histogram.
#include "common.cuh"
#include "grouped_window.cuh"

namespace {

constexpr int kTileRows = 64;      // rows a tile of the conv kernel (kBM)
constexpr int kKeys = 512;         // 9-bit used-group masks
constexpr int kThreads = 512;      // a thread a key in steps 1-2
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMaps = 16;       // maps a launch (3 L - 2 for L <= 6)
constexpr int kMaxCluster = 16;    // CTAs a map (> 8: non-portable)
constexpr int kKeyRows = 65536;    // keys a CTA keeps in shared memory
constexpr long long kMaxRows = (1ll << 31) - 1024;  // rows a map, below
static_assert(kThreads == kKeys, "a thread a key");

struct OrderMap {
  const unsigned char* masks;  // (9, 3, n) bool
  const unsigned char* patho;  // (9, n) bool
  long long n;                 // rows
  long long order;             // its order's offset in the order buffer
  long long tiles;             // its tiles' offset in the tiles buffer
};
struct OrderMaps {
  OrderMap map[kMaxMaps];
};

__device__ __forceinline__ int row_key(const unsigned char* __restrict__ masks,
                                       const unsigned char* __restrict__ patho,
                                       int64_t row, int64_t N) {
  int key = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
    if (window_used(masks, patho, g, row, N)) key |= 1 << g;
  return key;
}

__device__ __forceinline__ uint32_t ld_u32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The keys of rows r .. r + 3 (r and N multiples of 4, the map 4-byte
// aligned): one 4-byte load a slot and group.
__device__ __forceinline__ void row_keys4(
    const unsigned char* __restrict__ masks,
    const unsigned char* __restrict__ patho, int64_t r, int64_t N,
    int (&key)[4]) {
  uint32_t used[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const unsigned char* m = masks + (int64_t)g * 3 * N + r;
    used[g] = ld_u32(m) | ld_u32(m + N) | ld_u32(m + 2 * N) |
              ld_u32(patho + (int64_t)g * N + r);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int k = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      if ((used[g] >> (8 * j)) & 0xffu) k |= 1 << g;
    key[j] = k;
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// The int at `local` (this CTA's shared address) in CTA `rank`'s shared
// memory.
__device__ __forceinline__ int ld_cluster_s32(uint32_t local,
                                              uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(remote)
               : "memory");
  return v;
}

// The last key whose first place is at or before p (a key with rows).
__device__ __forceinline__ int key_at(const int* __restrict__ start,
                                      int64_t p) {
  int lo = 0, hi = kKeys - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= p)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Shared memory: the warps' counts, then places (kWarps x kKeys int), the
// CTA's histogram (read by its peers), each key's first place and count
// in the map, the scan's warp sums, then the keys (key_rows uint16).
constexpr int kSmemInts = kWarps * kKeys + 3 * kKeys + kWarps;
static_assert(kSmemInts % 4 == 0, "the keys start 16-byte aligned");

__global__ void __launch_bounds__(kThreads)
    grouped_order_kernel(const __grid_constant__ OrderMaps maps,
                         int* __restrict__ order_buf,
                         int* __restrict__ tiles_buf, int key_rows) {
  extern __shared__ __align__(16) int smem[];
  int* cnt = smem;
  int* hist = cnt + kWarps * kKeys;
  int* start = hist + kKeys;
  int* total = start + kKeys;
  int* wsum = total + kKeys;
  unsigned short* keys = reinterpret_cast<unsigned short*>(smem + kSmemInts);

  const int c = (int)cluster_size();
  const int rank = (int)cluster_rank();
  const OrderMap& m = maps.map[blockIdx.x / c];
  const int64_t N = m.n;
  const unsigned char* __restrict__ masks = m.masks;
  const unsigned char* __restrict__ patho = m.patho;
  int* __restrict__ order = order_buf + m.order;
  int* __restrict__ tiles = tiles_buf + m.tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. this CTA's rows, their keys and the warps' histograms
  const int64_t share = ((N + c - 1) / c + 31) / 32 * 32;
  const int64_t lo = min(N, (int64_t)rank * share);
  const int64_t rows = min(N, lo + share) - lo;
  const bool in_smem = rows <= key_rows;
  for (int e = tid; e < kWarps * kKeys; e += kThreads) cnt[e] = 0;
  if (in_smem) {
    const bool vec = (N & 3) == 0 &&
                     (((uintptr_t)masks | (uintptr_t)patho) & 3) == 0;
    if (vec) {  // lo and rows are multiples of 4 too
      for (int64_t i = 4 * (int64_t)tid; i < rows; i += 4 * kThreads) {
        int k[4];
        row_keys4(masks, patho, lo + i, N, k);
        *reinterpret_cast<uint2*>(keys + i) =
            make_uint2((uint32_t)k[0] | (uint32_t)k[1] << 16,
                       (uint32_t)k[2] | (uint32_t)k[3] << 16);
      }
    } else {
      for (int64_t i = tid; i < rows; i += kThreads)
        keys[i] = (unsigned short)row_key(masks, patho, lo + i, N);
    }
  }
  __syncthreads();
  const int64_t run = ((rows + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int64_t w_lo = lo + min(rows, warp * run);
  const int64_t w_hi = lo + min(rows, (warp + 1) * run);
  int* mine = cnt + warp * kKeys;
  for (int64_t r0 = w_lo; r0 < w_hi; r0 += 32) {
    const int64_t r = r0 + lane;
    const bool valid = r < w_hi;
    const int key = !valid ? kKeys + lane  // alone if not
                    : in_smem ? (int)keys[r - lo]
                              : row_key(masks, patho, r, N);
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (valid && lane == __ffs(peers) - 1) mine[key] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  const int k = tid;  // a thread a key from here to the scan
  {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int n = cnt[w * kKeys + k];
      cnt[w * kKeys + k] = sum;
      sum += n;
    }
    hist[k] = sum;
  }
  cluster_sync();

  // 2. the key's rows in the map and in lower-ranked CTAs, then its first
  // place (an exclusive scan over the keys)
  int tot = 0, below = 0;
  for (int q = 0; q < c; ++q) {
    const int v = q == rank ? hist[k] : ld_cluster_s32(smem_u32(hist + k), q);
    tot += v;
    below += q < rank ? v : 0;
  }
  int incl = tot;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += v;
    }
    if (lane < kWarps) wsum[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int first = incl - tot + (warp > 0 ? wsum[warp - 1] : 0);
  start[k] = first;
  total[k] = tot;
  for (int w = 0; w < kWarps; ++w) cnt[w * kKeys + k] += first + below;
  __syncthreads();

  // 3. place the rows: warps in row order, 32 rows a step
  const unsigned lower = (1u << lane) - 1u;
  for (int64_t r0 = w_lo; r0 < w_hi; r0 += 32) {
    const int64_t r = r0 + lane;
    const bool valid = r < w_hi;
    const int key = !valid ? kKeys + lane
                    : in_smem ? (int)keys[r - lo]
                              : row_key(masks, patho, r, N);
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (valid) order[mine[key] + __popc(peers & lower)] = (int)r;
    __syncwarp();
    if (valid && lane == 31 - __clz(peers))  // the key's last lane
      mine[key] += __popc(peers);
    __syncwarp();
  }

  // 4. this CTA's share of the tiles, from the keys' places
  const int64_t n_tiles = (N + kTileRows - 1) / kTileRows;
  const int64_t t_share = (n_tiles + c - 1) / c;
  const int64_t t_hi = min(n_tiles, (int64_t)(rank + 1) * t_share);
  for (int64_t t = (int64_t)rank * t_share + tid; t < t_hi; t += kThreads) {
    const int64_t p0 = t * kTileRows;
    const int64_t p1 = min(N, p0 + kTileRows) - 1;
    const int k1 = key_at(start, p1);
    int mask = 0;
    for (int j = key_at(start, p0); j <= k1; ++j)
      if (total[j] > 0) mask |= j;
    tiles[t] = mask;
  }
  cluster_sync();  // no CTA leaves while a peer may read its histogram
}

}  // namespace

// The row orders of `count` (1 to kMaxMaps) grouped maps in one launch:
// map i has masks[i] (9, 3, n[i]) and patho[i] (9, n[i]) bool bytes, 1 <=
// n[i] < 2^31 - 1024 rows; its order (n[i] int32: rows by used-group
// mask, stable) goes to `order` after the earlier maps' orders, its tiles
// (ceil(n[i] / 64) int32: each 64-row tile's groups) to `tiles` after
// theirs. A cluster of `cluster` (1 to kMaxCluster) CTAs a map.
UMR_EXPORT int umr_grouped_row_order(const void* const* masks,
                                     const void* const* patho,
                                     const long long* n, int count,
                                     int* order, int* tiles, int cluster,
                                     void* stream) {
  if (count < 1 || count > kMaxMaps || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  OrderMaps maps = {};
  long long o = 0, t = 0, max_share = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 1 || n[i] >= kMaxRows) return (int)cudaErrorInvalidValue;
    maps.map[i] = {static_cast<const unsigned char*>(masks[i]),
                   static_cast<const unsigned char*>(patho[i]), n[i], o, t};
    o += n[i];
    t += (n[i] + kTileRows - 1) / kTileRows;
    const long long share = ((n[i] + cluster - 1) / cluster + 31) / 32 * 32;
    max_share = share > max_share ? share : max_share;
  }
  const int key_rows = (int)(max_share < kKeyRows ? max_share : kKeyRows);
  const size_t smem =
      sizeof(int) * kSmemInts + sizeof(unsigned short) * ((key_rows + 7) & ~7);
  auto kernel = grouped_order_kernel;
  int code = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (code == 0 && cluster > 8)
    code = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (code != 0) return code;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(count * cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  code = (int)cudaLaunchKernelEx(&cfg, kernel, maps, order, tiles, key_rows);
  return code != 0 ? code : (int)cudaGetLastError();
}
