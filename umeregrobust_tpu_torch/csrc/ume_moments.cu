// Capped ball-query UME moment accumulation.
//
// Replaces: umeregrobust_tpu/ops/pallas_ume.py, ume_moments_fused.
//
// Computes out[k] = sum_n w[k,n] * Z[n] with w[k,n] = 1 iff point n is
// valid, lies within `radius` of keypoint k, and is among the first
// `max_nn` such points in index order (PyTorch3D ball_query capping).
// fp32 throughout, rows added in index order with compensated (Kahan)
// sums, no atomics: two launches give the same bits. Plain fp32 sums of a
// ball's up to 750 rows one after another left G 1.3e-5 of its max off
// float64 sums (the plain version's blocked matmul 7.5e-6), and RT-UME's
// subspace distances carried that through a near-degenerate UME
// (condition number 2e5) to 9e-5; compensated, G is 2.6e-6 off. The
// compensation lengthens the add chain a warp waits on (0.150 ms a call
// at the main path's shape against 0.085; a tree over each batch of 16
// rows was slower still, 0.286).
//
// Bound on the H100. Against device memory the work is small: Z is
// 16384 x 128 x 4 B = 8 MB read once, the radius tests and row sums are
// under 1 GFLOP. What the kernel really moves is L2 traffic: every
// selected row is a 512-byte read by its warp (Z stays resident in the
// 50 MB L2), ~0.9 M rows = 467 MB a launch at the main path's shape. And
// with 2048 warps on 132 SMs (about 16 a SM, one wave) there are too few
// warps to hide an L2 round trip by switching between them: the time is
// that of a warp's own chain, its sweep plus its row reads. So the design
// keeps many row reads in flight per warp, keeps the sweep's loads cheap
// and ahead of their use, and lets no warp wait for another.
//
// Design: one warp per keypoint, and the warps of a block share nothing:
// no shared point tiles and no block-wide barrier (the only
// synchronisation is __syncwarp round the warp's own queue).
//  - Packed copy. A small kernel first writes the coordinates into scratch
//    as three padded arrays x[], y[], z[], NaN where the mask is off or
//    past the end. A step of the sweep is then three coalesced 128-byte
//    reads with no mask read and no bounds test (from the (N, 3) layout a
//    step is three strided reads over 384 bytes plus the mask, and the
//    SM's load pipe set the sweep's time).
//  - Sweep. The warp walks the packed points in index order, 32 a step,
//    kUnroll steps a turn, through the read-only path: the 196 KB stay in
//    L1/L2 and every warp of the SM walks the same stream. The next turn's
//    points are loaded into registers while this turn's are tested, and a
//    turn's ballots are all taken before the first is looked at, so a turn
//    without a hit is one short chain.
//  - Hit queue. A step's in-radius lanes are gathered with __ballot_sync;
//    a lane's slot is pos = count + popc(bits below it); lanes with
//    pos < max_nn write their point index into a per-warp ring of kQueue
//    int32 in shared memory (size independent of max_nn); count advances by
//    popc(bits), clamped at max_nn. This is the in-order prefix count that
//    the TPU kernel built with a triangular matmul.
//  - Drain. Whenever the ring holds kBatch indices each lane starts kBatch
//    independent 16-byte loads (its 4 of the 128 columns of kBatch queued
//    rows: kBatch x 512 B = 8 KB in flight per warp, past L1 so that the
//    rows do not push the points out of it) and then adds them in queue
//    order. The sweep's end or the cap ends the last, partial batch, which
//    reads only the rows that were selected.
//  - A warp stops sweeping once its count reaches max_nn, which the capped
//    semantics make exact.
//  - Per-keypoint caps (optional): a cloud sharded over its points gives
//    each block's keypoint the cap left by the blocks before it; the warp
//    reads its own once and uses it in place of max_nn.
// Pair axis: a call serves B independent clouds of one shape (grid y of
// both kernels, per-pair pointer offsets, a packed copy per pair). A
// keypoint's warp does what it does at B = 1, so each pair's rows are
// added in the same order and its output has the bits of the B = 1 call.
// Widths: Z has C4 columns, a multiple of 128 (the wrapper zero-pads 4C up
// to one); grid z runs over the 128-column slices, each warp of a slice
// sweeping the same points and adding its own 128 columns of the same rows
// in the same order. Columns are independent, so a column's bits do not
// depend on the slice it falls in or on the padding.
// Candidates that were measured on the card and not kept: point tiles
// shared by the block with no row read between its barriers (the block
// first fills an in-radius bitmap for its 8 keypoints, then each warp
// drains its own: a cheaper sweep that cannot overlap the block's row
// reads, level with independent warps on the (N, 3) layout and slower
// than these); two batches in flight across the sweep (register double
// buffer: within 2% of this); prefetch instructions for the points
// (slower).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;    // warps a block; they share nothing
constexpr int kCols = 128;   // columns a slice (4C at C = 32): 4 a lane
constexpr int kQueue = 128;  // ring slots per warp (power of two)
constexpr int kBatch = 16;   // row reads in flight per warp in a drain
constexpr int kUnroll = 4;   // steps whose points are loaded ahead
constexpr int kChunk = kUnroll * 32;

static_assert((kQueue & (kQueue - 1)) == 0, "ring index is masked");
static_assert(kQueue >= kBatch + 32, "a step adds up to 32 to < kBatch");

// points the packed copy holds for a cloud of N: whole chunks, and one
// more that the sweep loads ahead of the last
__host__ __device__ constexpr int packed_points(int N) {
  return ((N + kChunk - 1) / kChunk + 1) * kChunk;
}

// packed[c * P + n] = pts[n][c] for a valid point, NaN (in no radius)
// where the mask is off or n >= N: one coalesced 128-byte read a
// coordinate and step in the sweep, no mask read, no bounds test
__global__ void ume_pack_points_kernel(const float* __restrict__ pts,
                                       const uint8_t* __restrict__ mask,
                                       float* __restrict__ packed, int N,
                                       int P) {
  const int64_t pair = blockIdx.y;
  pts += pair * N * 3;
  mask += pair * N;
  packed += pair * 3 * P;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= P) return;
  const bool ok = n < N && mask[n] != 0;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    packed[(int64_t)c * P + n] = ok ? pts[3 * (int64_t)n + c] : nan;
}

// s += x with the running compensation c (Kahan); rounded intrinsics, so
// that no contraction or reassociation drops the compensation
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// adds the rows queued at ring positions head .. head + n - 1 (n <= kBatch,
// uniform over the warp) to acc (compensation cmp), in that order; all n
// reads are started before the first add. Z4 points at this lane's float4
// of the slice; ld4 is a row's float4 count.
template <bool kFull>
__device__ __forceinline__ void drain(const int* __restrict__ q,
                                      const float4* __restrict__ Z4, int ld4,
                                      int head, int n, float4& acc,
                                      float4& cmp) {
  float4 z[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (kFull || j < n) {
      const int row = q[(head + j) & (kQueue - 1)];
      z[j] = __ldcg(Z4 + (int64_t)row * ld4);
    }
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (kFull || j < n) {
      kahan_add(acc.x, cmp.x, z[j].x);
      kahan_add(acc.y, cmp.y, z[j].y);
      kahan_add(acc.z, cmp.z, z[j].z);
      kahan_add(acc.w, cmp.w, z[j].w);
    }
  }
}

// kCaps: each keypoint's own cap from caps[] in place of max_nn; without
// it the kernel is the one it was before caps existed (a cap read at run
// time in the common path made it slower on the H100)
template <bool kCaps>
__global__ void __launch_bounds__(kWarps * 32)
ume_moments_kernel(const float* __restrict__ kpts,
                   const float* __restrict__ packed,
                   const float* __restrict__ Z, float* __restrict__ out,
                   int M, int N, int P, int C4, float r2, int max_nn,
                   const int* __restrict__ caps) {
  __shared__ int queue[kWarps][kQueue];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= M) return;  // whole warps leave; no block-wide barrier follows
  const int64_t pair = blockIdx.y;
  kpts += pair * M * 3;
  packed += pair * 3 * P;
  Z += pair * N * C4;
  out += pair * M * C4;
  const int ld4 = C4 / 4;
  const int col4 = blockIdx.z * (kCols / 4) + lane;  // this lane's float4
  int* q = queue[warp];
  // this keypoint's cap: the caller's own when it gives caps (a block of a
  // cloud sharded over its points), else max_nn; uniform over the warp
  const int cap = kCaps ? caps[pair * M + k] : max_nn;
  const float kx = kpts[3 * (int64_t)k];
  const float ky = kpts[3 * (int64_t)k + 1];
  const float kz = kpts[3 * (int64_t)k + 2];
  const float* px = packed + lane;
  const float* py = px + P;
  const float* pz = py + P;
  const float4* Z4 = reinterpret_cast<const float4*>(Z) + col4;
  const unsigned below = (1u << lane) - 1u;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 cmp = make_float4(0.f, 0.f, 0.f, 0.f);
  int count = 0;  // indices queued so far, <= cap (uniform over the warp)
  int head = 0;   // indices drained so far

  float cx[kUnroll], cy[kUnroll], cz[kUnroll];
  float nx[kUnroll], ny[kUnroll], nz[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    cx[u] = __ldg(px + u * 32);
    cy[u] = __ldg(py + u * 32);
    cz[u] = __ldg(pz + u * 32);
  }
  for (int base = 0; base < N && count < cap; base += kChunk) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      nx[u] = __ldg(px + base + kChunk + u * 32);
      ny[u] = __ldg(py + base + kChunk + u * 32);
      nz[u] = __ldg(pz + base + kChunk + u * 32);
    }
    unsigned bits[kUnroll];
    unsigned any = 0u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bits[u] = __ballot_sync(
          0xffffffffu, umr_sqdist3(kx, ky, kz, cx[u], cy[u], cz[u]) <= r2);
      any |= bits[u];
    }
    if (any != 0u) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (bits[u] == 0u || count >= cap) continue;
        const int pos = count + __popc(bits[u] & below);
        if (((bits[u] >> lane) & 1u) && pos < cap)
          q[pos & (kQueue - 1)] = base + u * 32 + lane;
        count = min(count + __popc(bits[u]), cap);
        __syncwarp();
        while (count - head >= kBatch) {
          drain<true>(q, Z4, ld4, head, kBatch, acc, cmp);
          head += kBatch;
        }
        // the ring's next writes land ahead of every slot still unread
        __syncwarp();
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cx[u] = nx[u];
      cy[u] = ny[u];
      cz[u] = nz[u];
    }
  }
  if (count > head)
    drain<false>(q, Z4, ld4, head, count - head, acc, cmp);
  reinterpret_cast<float4*>(out)[(int64_t)k * ld4 + col4] = acc;
}

}  // namespace

// floats of scratch that umr_ume_moments needs a pair for a cloud of N
// points
UMR_EXPORT int umr_ume_moments_scratch(int N) { return 3 * packed_points(N); }

// B pairs: kpts (B,M,3), pts (B,N,3), Z (B,N,C4) f32, mask (B,N) bool ->
// out (B,M,C4) f32; scratch: B x umr_ume_moments_scratch(N) floats,
// overwritten. C4 must be a positive multiple of 128 (the wrapper pads).
// caps: null (every keypoint capped at max_nn) or (B,M) int32, keypoint
// k's own cap in place of max_nn (0: a zero row).
UMR_EXPORT int umr_ume_moments(const float* kpts, const float* pts,
                               const float* Z, const uint8_t* mask,
                               float* out, float* scratch, int B, int M,
                               int N, int C4, float r2, int max_nn,
                               const int* caps, void* stream) {
  if (C4 < kCols || C4 % kCols != 0 || C4 / kCols > 65535 || B < 1 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = packed_points(N);
  ume_pack_points_kernel<<<dim3((P + 255) / 256, B), 256, 0, st>>>(
      pts, mask, scratch, N, P);
  const int blocks = (M + kWarps - 1) / kWarps;
  const dim3 grid(blocks, B, C4 / kCols);
  if (caps != nullptr)
    ume_moments_kernel<true><<<grid, kWarps * 32, 0, st>>>(
        kpts, scratch, Z, out, M, N, P, C4, r2, max_nn, caps);
  else
    ume_moments_kernel<false><<<grid, kWarps * 32, 0, st>>>(
        kpts, scratch, Z, out, M, N, P, C4, r2, max_nn, caps);
  return static_cast<int>(cudaGetLastError());
}
