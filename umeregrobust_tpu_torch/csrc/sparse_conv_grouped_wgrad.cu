// The weight gradient of the grouped-window k=3 conv
// (sparse_conv_grouped.cu), one call a layer:
//   dW3[g] = sum over output rows o of x3_g[o]^T dY[o]     (3 Cin x Cout)
// where x3_g[o] is the window the forward reads for (g, o) (zero slots
// where the forward reads zeros; see grouped_window.cuh), and dW[3 g + p]
// is dW3[g]'s rows of the slot s with worder[s] = p: the (27, Cin, Cout)
// gradient in lexicographic tap order. fp32 sums. bf16 (the main path): X
// rounded to bf16 as the forward rounds it, dY taken unrounded as two bf16
// parts (hi = bf16(dY), lo = bf16(dY - hi): JAX's autodiff of the
// forward's casts takes the cotangent as it is), the result rounded to
// bf16 and held in fp32; or fp32 operands.
//
// Replaces: the backward of the grouped conv's window gathers (the
// gather_rows_backward kernel, 9 launches a conv, after the
// tools/exp_gather2.py `pg` gathers of the plain version's recompute) and
// its per-pair products, i.e. JAX's autodiff of
// umeregrobust_tpu/ops/sparse.py:480 sparse_conv_grouped (a lax.scan in
// plain XLA, no Pallas kernel).
//
// Bound on the H100: 2 x 3 Cin x Cout operations a window that some slot
// uses, at 989 TFLOP/s bf16, against the bytes of the X rows some slot
// reads, the dY rows, the map and dW written once, at 3.35 TB/s: a few
// hundredths of a ms a layer of ResUNetSmall2 at a B = 8 training batch.
// What sets the time is how many gathered rows are staged (a window no row
// uses is a waste), how often each is staged again, and how well their
// latency is hidden. The first design (csrc/bench/
// sparse_conv_grouped_wgrad_parent.cu) walked 32-row steps in code order,
// where nearly every step holds a user of every group, staged each dY row
// again for each 64 window columns and each window for each 64 channels,
// and had eight threads find each window.
//
// Design (bf16 operands), Hopper:
//  - the rows in the map's order (grouped_row_order.cu: sorted by their
//    9-bit used-group mask, and each 64-row tile's mask), and a unit is one
//    (group g, tile) with bit g in the tile's mask: group g visits only
//    those tiles, and a row of such a tile that does not use g stages a
//    zero window;
//  - one prep launch rounds X to bf16 rows of round8(Cin) columns, writes
//    each (g, row) window as one int32 code (its centre row and which
//    slots read; in code order, so the map's reads coalesce) and lists
//    each group's tiles in ascending order (a block a group, a block
//    scan);
//  - the units, group 0's list then group 1's and so on, are cut into
//    `ranges` equal contiguous runs fixed by the shapes (about one CTA an
//    SM), so the work is balanced whatever the map and no run depends on
//    timing; a CTA takes one run for one block of <= 192 window columns
//    (3 atoms of 64; 2 with two consumer warpgroups) and <= 128 output
//    channels;
//  - the product is dW3[g]^T = dY^T x3_g: M the CTA's output channels (one
//    or two consumer warpgroups of 64), N its window columns, K a unit's
//    64 rows; wgmma.m64n64k16 takes A (dY^T) from registers, read as fp32
//    from shared memory and split there into hi and lo (two products a K
//    step, no bf16 copy of dY), and B (the windows) from shared memory in
//    MN-major order; the accumulators stay in registers over the run and
//    are written out as a partial where the run's group changes;
//  - two producer warpgroups stage each unit with 16-byte cp.async pieces
//    (windows into the 128-byte swizzle wgmma reads, dY rows as fp32) over
//    a ring of up to four stages with full / empty mbarriers, reading the
//    order four units ahead and the codes two. Issuing those pieces, not
//    the bytes they move nor the products, sets the time on the H100
//    (zero-filling every piece, or skipping the products, moved it by
//    2-5%; dropping the copy instructions by 25%), hence two warpgroups
//    of producers;
//  - a sum launch adds, for each group, the partials of the runs that
//    touch it in run order and writes dW in tap order, rounded to bf16;
//  - Cin <= 2 (the stem) packs the 27 taps into one 64-column row: one
//    CTA covers every group, a row and its dY are staged once, in code
//    order (the rows' map reads coalesce, read a unit ahead), X read as
//    fp32 and rounded by the producer, a unit's dY rows one bulk copy
//    where the CTA holds every channel and Cout % 4 == 0.
// No atomics: the sums' order is fixed by the map and the shapes, so two
// launches give the same bits.
// fp32 operands take an FMA tile (64 x 64 of one group's gradient, 4 x 4
// outputs a thread, rows ascending in code order over splits of the
// output rows, steps no row uses skipped) and a sum launch over the
// splits in order.
#include "common.cuh"
#include "grouped_window.cuh"
#include "hopper.cuh"

namespace {

// ---- fp32 operands: the FMA tile over splits of the output rows
constexpr int kWM = 64;        // dW3 rows (window columns) a block
constexpr int kWN = 64;        // dW3 columns (output channels) a block
constexpr int kWR = 32;        // output rows a step
constexpr int kWSteps = 256;   // steps a block at most (one split's rows)
constexpr int kWThreads = 256;
static_assert(kWSteps == kWThreads, "the vote gives a thread one step");

// The steps of [row0, row0 + steps kWR) that some row uses group g in,
// ascending, into s_list; returns their count. Each warp votes on steps
// w, w + 8, ... (a lane a row); then the used ones are listed in order.
__device__ __forceinline__ int used_steps(
    const unsigned char* __restrict__ masks,
    const unsigned char* __restrict__ patho, int g, int64_t row0, int steps,
    int64_t N_out, unsigned char* s_flag, int* s_warp, int* s_list) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = warp; j < steps; j += kWThreads / 32) {
    const int64_t row = row0 + (int64_t)j * kWR + lane;
    const bool u = row < N_out && window_used(masks, patho, g, row, N_out);
    const unsigned any = __ballot_sync(0xffffffffu, u);
    if (lane == 0) s_flag[j] = any != 0u;
  }
  __syncthreads();
  const bool mine = tid < steps && s_flag[tid];
  const unsigned b = __ballot_sync(0xffffffffu, mine);
  if (lane == 0) s_warp[warp] = __popc(b);
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kWThreads / 32; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  if (mine) s_list[before + __popc(b & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  return total;
}

// fp32 operands: 64 x 64 tiles of one group's (3 round8(Cin) x
// round8(Cout)) gradient over splits of the output rows, 4 x 4 outputs a
// thread, each one fmaf chain over the rows in ascending order.
template <typename IdxT>
__global__ void __launch_bounds__(kWThreads)
    wgrad_fma_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     const IdxT* __restrict__ center,
                     const unsigned char* __restrict__ masks,
                     const unsigned char* __restrict__ patho,
                     float* __restrict__ part, int64_t N_in, int64_t N_out,
                     int Cin, int Cout, int split_rows, int n_tiles) {
  __shared__ float sA[kWR][kWM + 4];
  __shared__ __align__(16) float sY[kWR][kWN];
  __shared__ int s_win[3][kWR];
  __shared__ unsigned char s_flag[kWSteps];
  __shared__ int s_warp[kWThreads / 32];
  __shared__ int s_list[kWSteps];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int split = blockIdx.x, g = blockIdx.z;
  const int m0 = (blockIdx.y / n_tiles) * kWM;
  const int n0 = (blockIdx.y % n_tiles) * kWN;
  const int Cin8 = round8(Cin), Cout8 = round8(Cout), K3 = 3 * Cin8;
  const int64_t row0 = (int64_t)split * split_rows;
  const int64_t rows = N_out - row0 < split_rows ? N_out - row0 : split_rows;
  const int steps = (int)((rows + kWR - 1) / kWR);
  const int nsteps =
      used_steps(masks, patho, g, row0, steps, N_out, s_flag, s_warp, s_list);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < nsteps; ++i) {
    const int64_t r0 = row0 + (int64_t)s_list[i] * kWR;
    __syncthreads();  // the previous step is read
    if (tid < kWR) {
      int src[3] = {-1, -1, -1};
      if (r0 + tid < N_out)
        window_rows(center, masks, patho, g, r0 + tid, N_in, N_out, src);
#pragma unroll
      for (int s = 0; s < 3; ++s) s_win[s][tid] = src[s];
    }
    __syncthreads();
    for (int e = tid; e < kWR * kWM; e += kWThreads) {
      const int r = e / kWM, j = e % kWM, m = m0 + j;
      const int s = m / Cin8, c = m - s * Cin8;
      const int src = (m < K3 && c < Cin) ? s_win[s][r] : -1;
      sA[r][j] = src >= 0 ? x[(int64_t)src * Cin + c] : 0.f;
      const int64_t row = r0 + r;
      sY[r][j] = (row < N_out && n0 + j < Cout) ? dy[row * Cout + n0 + j]
                                                : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kWR; ++r) {
      float a[4], bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = sA[r][ty * 4 + q];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = sY[r][tx * 4 + q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], bv[q], acc[p][q]);
    }
  }
  float* dst = part + ((int64_t)split * kGroups + g) * K3 * Cout8;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int row = m0 + ty * 4 + p;
    if (row >= K3) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + tx * 4 + q;
      if (col < Cout8) dst[(int64_t)row * Cout8 + col] = acc[p][q];
    }
  }
}

// dW[k][c][n] = sum over splits, in order, of part[split][k / 3][slot s
// with worder[s] = k % 3][c][n] (the FMA tile's partials).
__global__ void wgrad_split_sum_kernel(const float* __restrict__ part,
                                       const long long* __restrict__ worder,
                                       float* __restrict__ dw, int splits,
                                       int Cin, int Cout) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = 27ll * Cin * Cout;
  if (t >= total) return;
  const int n = (int)(t % Cout);
  const int64_t kc = t / Cout;
  const int c = (int)(kc % Cin), k = (int)(kc / Cin);
  const int g = k / 3, dz = k - 3 * g;
  const int s = (int)worder[0] == dz ? 0 : (int)worder[1] == dz ? 1 : 2;
  const int Cin8 = round8(Cin), Cout8 = round8(Cout), K3 = 3 * Cin8;
  const int64_t stride = (int64_t)kGroups * K3 * Cout8;
  const float* p = part + ((int64_t)g * K3 + s * Cin8 + c) * Cout8 + n;
  float v = p[0];
  for (int sp = 1; sp < splits; ++sp) v += p[sp * stride];
  dw[t] = v;
}

// ---- bf16 operands
constexpr int kUnitRows = 64;     // rows a unit (grouped_row_order.cu's tile)
constexpr int kAtom = 64;         // window columns (or channels) an atom
constexpr int kAtomBytes = 8192;  // a unit's rows x an atom of bf16
constexpr int kMaxAtoms1 = 3;     // atoms a CTA of one consumer warpgroup
constexpr int kMaxAtoms2 = 2;     // of two
constexpr int kMaxStages = 4;
constexpr int kSMs = 132;         // H100 SXM (the plan's, fixed)
constexpr int kStemCin = 2;       // Cin at most of the packed stem
constexpr int kStemCtas = 2;      // stem CTAs an SM (one warpgroup)
constexpr int kListChunk = 512;   // units a CTA lists in shared memory
constexpr int kLookahead = 2;     // units the producers read ahead
constexpr int kYPad = 4;          // floats past a staged dY row
constexpr int kSumThreads = 1048576;  // the sum launch's threads at most
constexpr int kMaxRuns = 512;     // runs a sum launch takes at most
constexpr int kMaxSmem = 232448;  // bytes a block may have on the H100
constexpr int kProducers = 128;   // a producer warpgroup
constexpr int kProducerWGs = 2;   // producer warpgroups of a CTA
static_assert(kAtom * kUnitRows * 2 == kAtomBytes, "an atom is 128-byte rows");
static_assert(kUnitRows == 64 && 4 % kProducerWGs == 0,
              "a producer warpgroup covers a unit's rows in 16 blocks");
static_assert(kStemCtas * kSMs <= kMaxRuns, "a sum block lists every run");

// The plan of a bf16 call, from the shapes alone (ops/cuda_grouped.py
// wgrad_plan mirrors it).
struct Plan {
  bool stem;
  int mw, nb, nblk, mblk, ranges, stages, lanes;
  int stage_bytes, smem, Mtot, Ktot, slots;
};

inline Plan make_plan(int64_t N_out, int Cin, int Cout) {
  Plan p;
  const int cout8 = round8(Cout);
  const int64_t n_tiles = (N_out + kUnitRows - 1) / kUnitRows;
  p.stem = Cin <= kStemCin;
  p.mw = cout8 <= kAtom ? 1 : 2;
  p.mblk = (cout8 + kAtom * p.mw - 1) / (kAtom * p.mw);
  int ctas = 1;
  if (p.stem) {
    p.nb = p.nblk = 1;
    ctas = p.mw == 1 ? kStemCtas : 1;
    const int64_t r = (int64_t)ctas * kSMs / p.mblk;
    p.ranges = (int)(r < n_tiles ? (r > 1 ? r : 1) : n_tiles);
  } else {
    const int atoms = (3 * round8(Cin) + kAtom - 1) / kAtom;
    const int most = p.mw == 1 ? kMaxAtoms1 : kMaxAtoms2;
    p.nblk = (atoms + most - 1) / most;
    p.nb = (atoms + p.nblk - 1) / p.nblk;
    const int r = kSMs / (p.nblk * p.mblk);
    p.ranges = r > 1 ? r : 1;
  }
  p.stage_bytes =
      (p.nb * kAtomBytes + kUnitRows * (p.mw * kAtom + kYPad) * 4 + 1023) &
      ~1023;
  const int room = kMaxSmem / ctas - 4 * kListChunk - 1024 - 16 * kMaxStages;
  p.stages = room / p.stage_bytes < kMaxStages ? room / p.stage_bytes
                                                : kMaxStages;
  p.smem = 1024 + p.stages * p.stage_bytes + 16 * p.stages;
  p.Mtot = p.mblk * p.mw * kAtom;
  p.Ktot = p.nblk * p.nb * kAtom;
  p.slots = p.stem ? p.ranges : p.ranges + kGroups - 1;
  const int64_t outputs = 27ll * Cin * Cout;
  p.lanes = p.stem ? 32 : 1;  // the stem's outputs sum every run
  while (p.lanes > 1 && outputs * p.lanes > kSumThreads) p.lanes /= 2;
  return p;
}

// The window code of (g, row): 0 where no slot reads,
// else (c + 1) << 4 | bit s for each slot s that reads a row in [0, N_in)
// | 8 where slot 2 reads row c (patho), c = center[g, row] - 1: slot 0
// reads c - 1, slot 1 c, slot 2 c + 1 (or c).
__device__ __forceinline__ int slot_row(int code, int s) {
  if (s < 0 || !((code >> s) & 1)) return -1;
  return (code >> 4) - (s == 0 ? 2 : s == 1 ? 1 : ((code >> 3) & 1));
}

// One launch: blocks [0, bx) round X to bf16 rows (N_in, Cin8); blocks
// [bx, bx + bc) write the window codes (9, N_out), in code order (the
// map's reads coalesce); block bx + bc + g lists group g's tiles of the
// order in ascending order into lists[g] and their count into counts[g].
template <typename IdxT>
__global__ void __launch_bounds__(256)
    wgrad_prep_kernel(const float* __restrict__ x,
                      __nv_bfloat16* __restrict__ xb, int64_t x_pieces,
                      int Cin, const IdxT* __restrict__ center,
                      const unsigned char* __restrict__ masks,
                      const unsigned char* __restrict__ patho,
                      const int* __restrict__ tiles, int* __restrict__ counts,
                      int* __restrict__ lists, int* __restrict__ codes,
                      int64_t N_in, int64_t N_out, int n_tiles, int bx,
                      int bc) {
  const int b = blockIdx.x, tid = threadIdx.x;
  if (b < bx) {
    const int64_t t = (int64_t)b * 256 + tid;
    if (t < x_pieces) to_bf16_piece(x, xb, t, Cin);
    return;
  }
  if (b < bx + bc) {
    const int64_t e = (int64_t)(b - bx) * 256 + tid;
    if (e >= kGroups * N_out) return;
    const int g = (int)(e / N_out);
    const int64_t row = e - g * N_out;
    int win[3], code = 0;
    window_rows(center, masks, patho, g, row, N_in, N_out, win);
    if (win[0] >= 0 || win[1] >= 0 || win[2] >= 0) {
      const int64_t c = (int64_t)center[e] - 1;
      code = (int)((c + 1) << 4) | (win[0] >= 0 ? 1 : 0) |
             (win[1] >= 0 ? 2 : 0) | (win[2] >= 0 ? 4 : 0) |
             (win[2] >= 0 && win[2] == c ? 8 : 0);
    }
    codes[e] = code;
    return;
  }
  // group g's list: 1024 tiles a pass, 4 a thread, a block scan
  __shared__ int s_warp[8];
  __shared__ int s_base;
  const int g = b - bx - bc, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_base = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n_tiles; t0 += 1024) {
    int mine = 0, cnt = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = t0 + 4 * tid + q;
      if (t < n_tiles && ((tiles[t] >> g) & 1)) {
        mine |= 1 << q;
        ++cnt;
      }
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int at = s_base + incl - cnt, total = s_base;
    for (int w = 0; w < 8; ++w) {
      at += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((mine >> q) & 1)
        lists[(int64_t)g * n_tiles + at++] = t0 + 4 * tid + q;
    __syncthreads();  // s_warp and s_base are read
    if (tid == 0) s_base = total;
    __syncthreads();
  }
  if (tid == 0) counts[g] = s_base;
}

// A consumer warpgroup's product of one staged unit: A = the unit's dY
// (kUnitRows fp32 rows at Y, row pitch py) transposed, this
// warpgroup's 64 channels, split into hi and lo bf16 parts in registers
// (mma.m16n8k16's A layout a warp); B = NB atoms of windows at sa (64 K
// rows x 64 columns, MN-major, atoms kAtomBytes apart). K steps of 16
// rows ascending, hi then lo; returns when the products are done.
template <int NB>
__device__ __forceinline__ void multiply_unit(float (&acc)[NB][32],
                                              uint32_t sa,
                                              const float* __restrict__ Y,
                                              int py, int mrow, int tq) {
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k0 = kk * 16 + 2 * tq;
    const float* y = Y + k0 * py + mrow;
    const float v[8] = {y[0],           y[py],          y[8],
                        y[py + 8],      y[8 * py],      y[9 * py],
                        y[8 * py + 8],  y[9 * py + 8]};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float h0 = __bfloat162float(__float2bfloat16_rn(v[2 * q]));
      const float h1 = __bfloat162float(__float2bfloat16_rn(v[2 * q + 1]));
      ah[kk][q] = pack_bf16(h0, h1);
      al[kk][q] = pack_bf16(v[2 * q] - h0, v[2 * q + 1] - h1);  // exact
    }
  }
#pragma unroll
  for (int a = 0; a < NB; ++a) fence_acc(acc[a]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int a = 0; a < NB; ++a) {
      const uint64_t db =
          mn_sw128_desc(sa + a * kAtomBytes + kk * 2048, kAtomBytes);
      wgmma_n64_ra(acc[a], ah[kk], db);
      wgmma_n64_ra(acc[a], al[kk], db);
    }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int a = 0; a < NB; ++a) fence_acc(acc[a]);
}

// The consumers' loop over the nu staged units of a CTA: each unit's
// product, its stage released when it is done; group(i) names unit i's
// partial, and where it changes the partial so far is written (flush)
// and the sums start again from zero.
template <int NB, typename Group, typename Flush>
__device__ __forceinline__ void consume(float (&acc)[NB][32], int nu,
                                        int stages, int stage_bytes,
                                        uint32_t base, uint32_t bars,
                                        const unsigned char* smem_raw,
                                        uint32_t raw, int py, int mrow,
                                        int tq, int lane, Group group,
                                        Flush flush) {
  for (int i = 0; i < nu; ++i) {
    const int s = i % stages;
    const uint32_t sa = base + s * stage_bytes;
    mbar_wait(bars + 8 * s, (i / stages) & 1);
    fence_proxy_async();
    multiply_unit<NB>(acc,
                          sa, reinterpret_cast<const float*>(
                                  smem_raw + (sa - raw) + NB * kAtomBytes),
                          py, mrow, tq);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (stages + s));
    if (i + 1 == nu || group(i + 1) != group(i)) {
      flush(group(i));
#pragma unroll
      for (int a = 0; a < NB; ++a)
#pragma unroll
        for (int q = 0; q < 32; ++q) acc[a][q] = 0.f;
    }
  }
}

// The accumulators as partial `slot` (Ktot x Mtot fp32: a column's
// channels contiguous; this CTA's columns col0 + [0, NB 64) x channels m0
// + [0, MW 64)). D fragment i of thread (warp, lane): channel mrow + 8 ((i
// / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2 of its atom; the 8
// lanes of one column write 8 channels in a row.
template <int NB>
__device__ __forceinline__ void write_partial(const float (&acc)[NB][32],
                                              float* __restrict__ part,
                                              int64_t slot, int Mtot,
                                              int Ktot, int m0, int col0,
                                              int mrow, int tq) {
  float* dst = part + (slot * Ktot + col0 + 2 * tq) * Mtot + m0 + mrow;
#pragma unroll
  for (int a = 0; a < NB; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dst[(int64_t)(a * kAtom + 8 * (i >> 2) + (i & 1)) * Mtot +
          8 * ((i >> 1) & 1)] = acc[a][i];
}

// Stages one unit's dY rows (row[q] of unit rows rb + step q, -1: zeros),
// channels m0 + [0, MW 64), as fp32 rows of pitch MW 64 + kYPad at sy:
// thread piece j of 8 a row, 16-byte cp.async pieces where Cout % 4 ==
// 0, else 4-byte ones.
template <int MW, int RQ>
__device__ __forceinline__ void stage_dy(uint32_t sy,
                                         const float* __restrict__ dy,
                                         const int (&row)[RQ], int rb,
                                         int step, int j, int m0, int Cout) {
  constexpr int PY = MW * kAtom + kYPad;
  const bool vec = (Cout & 3) == 0;
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
    const int r = rb + step * q;
#pragma unroll
    for (int u = 0; u < 2 * MW; ++u) {
      const int col = (j + 8 * u) * 4, n = m0 + col;
      const uint32_t dst = sy + (uint32_t)(r * PY + col) * 4u;
      const float* src = dy + (int64_t)row[q] * Cout + n;
      if (vec) {
        const bool ok = row[q] >= 0 && n < Cout;
        cp_async16(dst, ok ? (const void*)src : (const void*)dy, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row[q] >= 0 && n + e < Cout;
          cp_async4(dst + 4 * e, ok ? (const void*)(src + e) : (const void*)dy,
                    ok ? 4 : 0);
        }
      }
    }
  }
}

// The bf16 kernel. blockIdx.x = run p x nblk + column block, blockIdx.y =
// channel block. Threads [0, 128 MW) the consumers (warpgroup w: channels
// 64 w + [0, 64) of the block's), the next 256 the producers (two
// warpgroups: each thread 2 rows of a unit).
template <int MW, int NB>
__global__ void __launch_bounds__(kProducers*(MW + kProducerWGs), 1)
    wgrad_wgmma_kernel(const __nv_bfloat16* __restrict__ xb,
                       const float* __restrict__ dy,
                       const long long* __restrict__ worder,
                       const int* __restrict__ order,
                       const int* __restrict__ counts,
                       const int* __restrict__ lists,
                       const int* __restrict__ codes,
                       float* __restrict__ part, int64_t N_out, int Cin8,
                       int Cout, int n_tiles, int nblk, int ranges,
                       int stages, int stage_bytes, int Mtot, int Ktot) {
  constexpr int kCons = kProducers * MW, kProd = kProducers * kProducerWGs;
  // rows a producer thread stages of a unit, and their step
  constexpr int RQ = 4 / kProducerWGs, STEP = 16 * kProducerWGs;
  __shared__ int s_list[kListChunk];  // the tiles of units
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + stages * stage_bytes;  // full, then empty
  const int tid = threadIdx.x, lane = tid & 31;
  const int p = blockIdx.x / nblk;
  const int col0 = (blockIdx.x % nblk) * NB * kAtom;
  const int m0 = blockIdx.y * MW * kAtom;
  // the units: the groups' tile lists one after another; this run takes
  // [lo, lo + nu)
  int off[kGroups + 1];
  off[0] = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) off[g + 1] = off[g] + counts[g];
  const int64_t U = off[kGroups];
  const int lo = (int)((int64_t)p * U / ranges);
  const int nu = (int)((int64_t)(p + 1) * U / ranges) - lo;
  auto group_of = [&](int v) {  // the last group with off[g] <= v
    int g = 0;
#pragma unroll
    for (int q = 1; q < kGroups; ++q) g += off[q] <= v ? 1 : 0;
    return g;
  };
  auto off_of = [&](int g) {
    int r = 0;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) r = q == g ? off[q] : r;
    return r;
  };

  // the window columns past 3 Cin8 stay zero
  for (int s = 0; s < stages; ++s)
    for (int e = tid; e < NB * kAtomBytes / 16; e += blockDim.x)
      *reinterpret_cast<uint4*>(smem_raw + (base - raw) + s * stage_bytes +
                                16 * e) = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, kProd);                 // the copies
      mbar_init(bars + 8 * (stages + s), MW * 4);     // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kCons) {
    // ---- producers: thread pt stages 16-byte piece j = pt % 8 of unit
    // rows rb + STEP q, q < RQ, of every atom and of dY
    const int pt = tid - kCons, j = pt & 7, rb = pt >> 3;
    int slot[NB], cc[NB];  // each atom's piece: its slot and channel
    const int w0 = (int)worder[0], w1 = (int)worder[1];
#pragma unroll
    for (int a = 0; a < NB; ++a) {
      const int m = col0 + a * kAtom + 8 * j, place = m / Cin8;
      cc[a] = m - place * Cin8;
      slot[a] = place > 2 ? -1 : w0 == place ? 0 : w1 == place ? 1 : 2;
    }
    int cbase = -kListChunk;  // s_list holds units [cbase, + kListChunk)
    // unit f's rows (the order at its tile's places; -1 past N_out)
    auto fetch_rows = [&](int f, int (&row)[RQ]) {
      if (f >= nu) return;
      if (f - cbase >= kListChunk) {  // the same for every producer
        asm volatile("bar.sync 1, %0;\n" ::"n"(kProd) : "memory");
        for (int e = pt; e < kListChunk && f + e < nu; e += kProd) {
          const int v = lo + f + e, g = group_of(v);
          s_list[e] = lists[(int64_t)g * n_tiles + v - off_of(g)];
        }
        asm volatile("bar.sync 1, %0;\n" ::"n"(kProd) : "memory");
        cbase = f;
      }
      const int64_t pos0 = (int64_t)s_list[f - cbase] * kUnitRows + rb;
#pragma unroll
      for (int q = 0; q < RQ; ++q)
        row[q] = pos0 + STEP * q < N_out ? order[pos0 + STEP * q] : -1;
    };
    // unit f's window codes, from its rows
    auto fetch_codes = [&](int f, const int (&row)[RQ], int (&code)[RQ]) {
      if (f >= nu) return;
      const int* cg = codes + (int64_t)group_of(lo + f) * N_out;
#pragma unroll
      for (int q = 0; q < RQ; ++q) code[q] = row[q] >= 0 ? cg[row[q]] : 0;
    };
    auto stage = [&](int i, const int (&code)[RQ], const int (&row)[RQ]) {
      const int s = i % stages;
      mbar_wait(bars + 8 * (stages + s), ((i / stages) & 1) ^ 1);
      const uint32_t sa = base + s * stage_bytes;
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        const int r = rb + STEP * q;
#pragma unroll
        for (int a = 0; a < NB; ++a) {
          if (slot[a] < 0) continue;  // past 3 Cin8: zero from the start
          const int src = slot_row(code[q], slot[a]);
          cp_async16(sa + a * kAtomBytes + r * 128 + ((j ^ (r & 7)) << 4),
                     src >= 0 ? (const void*)(xb + (int64_t)src * Cin8 + cc[a])
                              : (const void*)xb,
                     src >= 0 ? 16 : 0);
        }
      }
      stage_dy<MW, RQ>(sa + NB * kAtomBytes, dy, row, rb, STEP, j, m0, Cout);
      cp_async_arrive_noinc(bars + 8 * s);
    };
    // a unit's rows are read 2 kLookahead units ahead, its codes
    // kLookahead ahead, so no stage waits on the order and the codes
    int rcode[kLookahead][RQ], rrow[kLookahead][RQ], rnext[kLookahead][RQ];
#pragma unroll
    for (int k = 0; k < kLookahead; ++k) fetch_rows(k, rrow[k]);
#pragma unroll
    for (int k = 0; k < kLookahead; ++k) {
      fetch_codes(k, rrow[k], rcode[k]);
      fetch_rows(kLookahead + k, rnext[k]);
    }
    for (int i0 = 0; i0 < nu; i0 += kLookahead) {
#pragma unroll
      for (int k = 0; k < kLookahead; ++k) {
        const int i = i0 + k;
        if (i < nu) {
          stage(i, rcode[k], rrow[k]);
#pragma unroll
          for (int q = 0; q < RQ; ++q) rrow[k][q] = rnext[k][q];
          fetch_codes(i + kLookahead, rrow[k], rcode[k]);
          fetch_rows(i + 2 * kLookahead, rnext[k]);
        }
      }
    }
    cp_async_wait<0>();
  } else {
    // ---- consumers: warpgroup wg, warp wq of it
    const int wg = tid >> 7, wq = (tid >> 5) & 3, tq = lane & 3;
    const int mrow = wg * kAtom + wq * 16 + (lane >> 2);
    float acc[NB][32];
#pragma unroll
    for (int a = 0; a < NB; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
    consume<NB>(
        acc, nu, stages, stage_bytes, base, bars, smem_raw, raw,
        MW * kAtom + kYPad, mrow, tq, lane,
        [&](int i) { return group_of(lo + i); },
        [&](int g) {
          write_partial<NB>(acc, part, (int64_t)p + g, Mtot, Ktot, m0, col0,
                            mrow, tq);
        });
  }
}

// The packed stem (Cin <= 2): a unit is 64 rows in code order, its 27
// taps one 64-column atom (column tap Cin + c), every group at once.
// blockIdx.x = run p (tiles [p T / ranges, (p + 1) T / ranges)),
// blockIdx.y = channel block; its partial is slot p.
template <typename IdxT, int MW>
__global__ void __launch_bounds__(kProducers*(MW + 1),
                                  MW == 1 ? kStemCtas : 1)
    wgrad_stem_kernel(const float* __restrict__ x,
                      const float* __restrict__ dy,
                      const IdxT* __restrict__ center,
                      const unsigned char* __restrict__ masks,
                      const unsigned char* __restrict__ patho,
                      const long long* __restrict__ worder,
                      float* __restrict__ part, int64_t N_in, int64_t N_out,
                      int Cin, int Cout, int n_tiles, int ranges, int stages,
                      int stage_bytes, int Mtot, int Ktot) {
  constexpr int kCons = kProducers * MW;
  constexpr int kItems = kGroups * kUnitRows;  // (group, row) a unit
  constexpr int kPer = (kItems + kProducers - 1) / kProducers;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + stages * stage_bytes;
  const int tid = threadIdx.x, lane = tid & 31;
  const int p = blockIdx.x, m0 = blockIdx.y * MW * kAtom;
  const int lo = (int)((int64_t)p * n_tiles / ranges);
  const int nu = (int)((int64_t)(p + 1) * n_tiles / ranges) - lo;
  // one channel block and Cout % 4 == 0: a unit's dY rows are one
  // contiguous piece, staged by one bulk copy at pitch Cout
  const bool packed = gridDim.y == 1 && (Cout & 3) == 0;
  const int py = packed ? Cout : MW * kAtom + kYPad;

  // the atoms' columns past 27 Cin stay zero
  for (int s = 0; s < stages; ++s)
    for (int e = tid; e < kAtomBytes / 16; e += blockDim.x)
      *reinterpret_cast<uint4*>(smem_raw + (base - raw) + s * stage_bytes +
                                16 * e) = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // stores, copies, the bulk copy (or a plain arrival)
      mbar_init(bars + 8 * s, 2 * kProducers + 1);
      mbar_init(bars + 8 * (stages + s), MW * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kCons) {
    const int pt = tid - kCons, j = pt & 7, rb = pt >> 3;
    const int w[3] = {(int)worder[0], (int)worder[1], (int)worder[2]};
    // the map of this thread's (group, row) items of unit i, read one
    // unit ahead: centre, masks and patho bits
    int64_t mc[2][kPer];
    unsigned mb[2][kPer];
    auto read_map = [&](int i, int64_t (&c)[kPer], unsigned (&m)[kPer]) {
      if (i >= nu) return;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = pt + kProducers * k;
        const int64_t row =
            (lo + i) * (int64_t)kUnitRows + (e & (kUnitRows - 1));
        c[k] = 0;
        m[k] = 0u;
        if (e < kItems && row < N_out) {
          const int64_t gi = (int64_t)(e / kUnitRows) * N_out + row;
          const unsigned char* mk =
              masks + (int64_t)(e / kUnitRows) * 3 * N_out + row;
          c[k] = (int64_t)center[gi] - 1;
          m[k] = mk[0] | mk[N_out] << 1 | mk[2 * N_out] << 2 |
                 (unsigned)patho[gi] << 3;
        }
      }
    };
    // unit i from its map (c_cur, m_cur), reading unit i + 1's into
    // (c_nxt, m_nxt) first; the loop takes two units a turn so each set
    // keeps its registers
    auto produce = [&](int i, const int64_t (&c_cur)[kPer],
                       const unsigned (&m_cur)[kPer], int64_t (&c_nxt)[kPer],
                       unsigned (&m_nxt)[kPer]) {
      const int64_t t = lo + i;
      const int s = i % stages;
      read_map(i + 1, c_nxt, m_nxt);
      // the windows of this thread's items (window_rows' rule), then
      // their X values, all loads in flight together
      int win[kPer][3];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int64_t c = c_cur[k];
        const unsigned m = m_cur[k];
        const int64_t r[3] = {m & 1u ? c - 1 : -1, m & 2u ? c : -1,
                              m & 4u ? c + 1 : (m & 8u ? c : -1)};
#pragma unroll
        for (int sl = 0; sl < 3; ++sl)
          win[k][sl] = r[sl] >= 0 && r[sl] < N_in ? (int)r[sl] : -1;
      }
      float val[kPer][3][kStemCin];
#pragma unroll
      for (int k = 0; k < kPer; ++k)
#pragma unroll
        for (int sl = 0; sl < 3; ++sl)
#pragma unroll
          for (int c = 0; c < kStemCin; ++c)
            val[k][sl][c] = win[k][sl] >= 0 && c < Cin
                                ? x[(int64_t)win[k][sl] * Cin + c]
                                : 0.f;
      mbar_wait(bars + 8 * (stages + s), ((i / stages) & 1) ^ 1);
      const uint32_t sa = base + s * stage_bytes;
      unsigned char* atom = smem_raw + (sa - raw);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = pt + kProducers * k;
        if (e >= kItems) continue;
        const int r = e & (kUnitRows - 1), g = e / kUnitRows;
#pragma unroll
        for (int sl = 0; sl < 3; ++sl)
#pragma unroll
          for (int c = 0; c < kStemCin; ++c) {
            if (c >= Cin) continue;
            const int col = (3 * g + w[sl]) * Cin + c;
            *reinterpret_cast<__nv_bfloat16*>(
                atom + r * 128 + (((col >> 3) ^ (r & 7)) << 4) +
                (col & 7) * 2) = __float2bfloat16_rn(val[k][sl][c]);
          }
      }
      fence_proxy_async();
      mbar_arrive(bars + 8 * s);
      const uint32_t sy = sa + kAtomBytes;
      if (packed) {  // rows past N_out zero-filled by cp.async
        const int64_t r0 = t * kUnitRows;
        const int rows =
            N_out - r0 < kUnitRows ? (int)(N_out - r0) : kUnitRows;
        if (pt == 0) {
          mbar_arrive_expect_tx(bars + 8 * s, (uint32_t)(rows * Cout * 4));
          bulk_copy(sy, dy + r0 * Cout, (uint32_t)(rows * Cout * 4),
                    bars + 8 * s);
        }
        for (int e = pt; e < (kUnitRows - rows) * Cout / 4; e += kProducers)
          cp_async16(sy + (uint32_t)(rows * Cout + 4 * e) * 4u, dy, 0);
      } else {
        if (pt == 0) mbar_arrive(bars + 8 * s);
        int row[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t o = t * kUnitRows + rb + 16 * q;
          row[q] = o < N_out ? (int)o : -1;
        }
        stage_dy<MW, 4>(sy, dy, row, rb, 16, j, m0, Cout);
      }
      cp_async_arrive_noinc(bars + 8 * s);
    };
    read_map(0, mc[0], mb[0]);
    for (int i = 0; i < nu; i += 2) {
      produce(i, mc[0], mb[0], mc[1], mb[1]);
      if (i + 1 < nu) produce(i + 1, mc[1], mb[1], mc[0], mb[0]);
    }
    cp_async_wait<0>();
  } else {
    const int wg = tid >> 7, wq = (tid >> 5) & 3, tq = lane & 3;
    const int mrow = wg * kAtom + wq * 16 + (lane >> 2);
    float acc[1][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[0][i] = 0.f;
    auto flush = [&](int) {
      write_partial<1>(acc, part, p, Mtot, Ktot, m0, 0, mrow, tq);
    };
    consume<1>(acc, nu, stages, stage_bytes, base, bars, smem_raw, raw,
                   py, mrow, tq, lane, [](int) { return 0; }, flush);
    if (nu == 0) flush(0);  // a run without tiles: zeros
  }
}

// dW[k][c][n] = the sum of the partials that hold it, rounded to bf16
// (held in fp32). Stem: part[p][k Cin + c][n] over every run p. Else, for
// g = k / 3: part[p + g][(k % 3) Cin8 + c][n] over the runs p that touch
// group g's units [off_g, off_g + n_g) (runs in order; a run with no units
// left out; each block finds the runs once, in shared memory). `lanes`
// threads an output: lane l adds runs l, l + lanes, ... in order, then the
// lanes' sums meet in a fixed butterfly.
__global__ void __launch_bounds__(256)
    wgrad_range_sum_kernel(const float* __restrict__ part,
                           const int* __restrict__ counts,
                           float* __restrict__ dw, int Cin, int Cin8,
                           int Cout, int Mtot, int Ktot, int ranges,
                           int lanes, int stem) {
  __shared__ int s_first[kGroups], s_last[kGroups];
  __shared__ unsigned char s_units[kMaxRuns];  // whether run q has units
  const int tid = threadIdx.x;
  if (!stem) {
    int64_t U = 0;
    for (int q = 0; q < kGroups; ++q) U += counts[q];
    for (int q = tid; q < ranges; q += blockDim.x)
      s_units[q] = (q + 1) * U / ranges > q * U / ranges ? 1 : 0;
    if (tid < kGroups) {  // the runs holding units off and off + ng - 1
      int64_t off = 0;
      for (int q = 0; q < tid; ++q) off += counts[q];
      const int64_t ng = counts[tid];
      s_first[tid] = ng > 0 ? (int)(((off + 1) * ranges - 1) / U) : 0;
      s_last[tid] = ng > 0 ? (int)(((off + ng) * ranges - 1) / U) : -1;
    }
    __syncthreads();
  }
  const int t = blockIdx.x * blockDim.x + tid;
  const int l = t % lanes, o = t / lanes, outputs = 27 * Cin * Cout;
  const int n = o % Cout, c = (o / Cout) % Cin, k = o / (Cin * Cout);
  float v = 0.f;
  if (o < outputs) {
    if (stem) {
      for (int q = l; q < ranges; q += lanes)
        v += part[((int64_t)q * Ktot + k * Cin + c) * Mtot + n];
    } else {
      const int g = k / 3, col = (k - 3 * g) * Cin8 + c;
#pragma unroll 4
      for (int q = s_first[g] + l; q <= s_last[g]; q += lanes)
        if (s_units[q]) v += part[((int64_t)(q + g) * Ktot + col) * Mtot + n];
    }
  }
  for (int s = lanes >> 1; s > 0; s >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, s);
  if (o < outputs && l == 0) dw[o] = __bfloat162float(__float2bfloat16_rn(v));
}

template <int MW, int NB>
int launch_main(const Plan& pl, const __nv_bfloat16* xb, const float* dy,
                const long long* worder, const int* order, const int* counts,
                const int* lists, const int* codes, float* part,
                int64_t N_out, int Cin, int Cout, int n_tiles,
                cudaStream_t st) {
  auto kernel = wgrad_wgmma_kernel<MW, NB>;
  int code = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (code != 0) return code;
  dim3 grid((unsigned)(pl.ranges * pl.nblk), (unsigned)pl.mblk);
  kernel<<<grid, kProducers * (MW + kProducerWGs), pl.smem, st>>>(
      xb, dy, worder, order, counts, lists, codes, part, N_out, round8(Cin),
      Cout, n_tiles, pl.nblk, pl.ranges, pl.stages, pl.stage_bytes, pl.Mtot,
      pl.Ktot);
  return (int)cudaGetLastError();
}

template <int MW>
int launch_atoms(const Plan& pl, const __nv_bfloat16* xb, const float* dy,
                 const long long* worder, const int* order,
                 const int* counts, const int* lists, const int* codes,
                 float* part, int64_t N_out, int Cin, int Cout, int n_tiles,
                 cudaStream_t st) {
  static_assert(kMaxAtoms1 == 3 && kMaxAtoms2 == 2, "the instances below");
  switch (pl.nb) {
    case 1:
      return launch_main<MW, 1>(pl, xb, dy, worder, order, counts, lists,
                                codes, part, N_out, Cin, Cout, n_tiles, st);
    case 2:
      return launch_main<MW, 2>(pl, xb, dy, worder, order, counts, lists,
                                codes, part, N_out, Cin, Cout, n_tiles, st);
    default:
      return launch_main<MW, (MW == 1 ? 3 : 2)>(
          pl, xb, dy, worder, order, counts, lists, codes, part, N_out, Cin,
          Cout, n_tiles, st);
  }
}

template <typename IdxT, int MW>
int launch_stem(const Plan& pl, const float* x, const float* dy,
                const IdxT* ctr, const unsigned char* masks,
                const unsigned char* patho, const long long* worder,
                float* part, int64_t N_in, int64_t N_out, int Cin, int Cout,
                int n_tiles, cudaStream_t st) {
  auto kernel = wgrad_stem_kernel<IdxT, MW>;
  int code = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (code != 0) return code;
  kernel<<<dim3((unsigned)pl.ranges, (unsigned)pl.mblk),
           kProducers * (MW + 1), pl.smem, st>>>(
      x, dy, ctr, masks, patho, worder, part, N_in, N_out, Cin, Cout,
      n_tiles, pl.ranges, pl.stages, pl.stage_bytes, pl.Mtot, pl.Ktot);
  return (int)cudaGetLastError();
}

template <typename IdxT>
int launch_bf16(const float* x, const float* dy, const void* center,
                const unsigned char* masks, const unsigned char* patho,
                const long long* worder, const int* order, const int* tiles,
                void* xb, int* codes, float* part, float* dw, int64_t N_in,
                int64_t N_out, int Cin, int Cout, cudaStream_t st) {
  const IdxT* ctr = static_cast<const IdxT*>(center);
  const Plan pl = make_plan(N_out, Cin, Cout);
  const int n_tiles = (int)((N_out + kUnitRows - 1) / kUnitRows);
  int code;
  int* counts = codes;  // 16 ints, then the lists, then the codes
  if (pl.stem) {
    code = pl.mw == 1
               ? launch_stem<IdxT, 1>(pl, x, dy, ctr, masks, patho, worder,
                                      part, N_in, N_out, Cin, Cout, n_tiles,
                                      st)
               : launch_stem<IdxT, 2>(pl, x, dy, ctr, masks, patho, worder,
                                      part, N_in, N_out, Cin, Cout, n_tiles,
                                      st);
  } else {
    int* lists = codes + 16;
    int* wcodes = lists + ((kGroups * n_tiles + 3) & ~3);
    __nv_bfloat16* xh = static_cast<__nv_bfloat16*>(xb);
    const int64_t px = N_in * (round8(Cin) / 8);
    const int bx = (int)((px + 255) / 256);
    const int bc = (int)((kGroups * N_out + 255) / 256);
    wgrad_prep_kernel<IdxT><<<(unsigned)(bx + bc + kGroups), 256, 0, st>>>(
        x, xh, px, Cin, ctr, masks, patho, tiles, counts, lists, wcodes,
        N_in, N_out, n_tiles, bx, bc);
    code = pl.mw == 1
               ? launch_atoms<1>(pl, xh, dy, worder, order, counts, lists,
                                 wcodes, part, N_out, Cin, Cout, n_tiles, st)
               : launch_atoms<2>(pl, xh, dy, worder, order, counts, lists,
                                 wcodes, part, N_out, Cin, Cout, n_tiles, st);
  }
  if (code != 0) return code;
  const int64_t threads = 27ll * Cin * Cout * pl.lanes;
  wgrad_range_sum_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      part, counts, dw, Cin, round8(Cin), Cout, pl.Mtot, pl.Ktot, pl.ranges,
      pl.lanes, pl.stem ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename IdxT>
int launch_fp32(const float* x, const float* dy, const void* center,
                const unsigned char* masks, const unsigned char* patho,
                const long long* worder, float* part, float* dw,
                int64_t N_in, int64_t N_out, int Cin, int Cout,
                int split_rows, cudaStream_t st) {
  const IdxT* ctr = static_cast<const IdxT*>(center);
  const int K3 = 3 * round8(Cin), Cout8 = round8(Cout);
  const int splits = (int)((N_out + split_rows - 1) / split_rows);
  const int n_tiles = (Cout8 + kWN - 1) / kWN;
  dim3 grid((unsigned)splits, ((K3 + kWM - 1) / kWM) * n_tiles, kGroups);
  wgrad_fma_kernel<IdxT><<<grid, kWThreads, 0, st>>>(
      x, dy, ctr, masks, patho, part, N_in, N_out, Cin, Cout, split_rows,
      n_tiles);
  const int64_t total = 27ll * Cin * Cout;
  wgrad_split_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, worder, dw, splits, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The grouped conv's weight gradient (see above). x (N_in, Cin) f32, dy
// (N_out, Cout) f32, center (9, N_out) int32 (idx64 0) or int64 (idx64
// 1), masks (9, 3, N_out) and patho (9, N_out) bool bytes, worder (3,)
// int64 -> dw (27, Cin, Cout) f32; part: caller-allocated fp32 scratch.
// bf16 1: X rounded to bf16, dY unrounded (its hi and lo bf16 parts), the
// result rounded to bf16; the plan (make_plan) follows from N_out, Cin
// and Cout; part holds its slots x Mtot x Ktot partials. Cin <= 2: the
// packed stem (order, tiles, xb and codes unused). Else order (N_out,)
// int32 and tiles (ceil(N_out / 64),) int32 are the map's row order
// (grouped_row_order.cu), xb (max(N_in, 1), round8(Cin)) bf16 and codes
// (16 + round4(9 T) + 9 N_out int32, T = ceil(N_out / 64)) scratch; N_in <
// 2^27. bf16 0: fp32 operands (order, tiles, xb, codes unused); output
// rows reduced in splits of split_rows (a multiple of 32, at most 8192),
// part (ceil(N_out / split_rows), 9, 3 round8(Cin), round8(Cout)).
UMR_EXPORT int umr_sparse_conv_grouped_wgrad(
    const float* x, const float* dy, const void* center,
    const unsigned char* masks, const unsigned char* patho,
    const long long* worder, const int* order, const int* tiles, void* xb,
    int* codes, float* part, float* dw, long long N_in, long long N_out,
    int Cin, int Cout, int idx64, int bf16, int split_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_in < 0 || N_out < 1 || N_in >= (1ll << 31) - 8 ||
      N_out >= (1ll << 31) - kWSteps * kWR || Cin < 1 || Cout < 1 ||
      3ll * round8(Cin) >= (1ll << 31) - kWM || part == nullptr ||
      27ll * Cin * Cout >= (1ll << 31) / 32)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (Cin > kStemCin &&
        (order == nullptr || tiles == nullptr || xb == nullptr ||
         codes == nullptr || N_in >= (1ll << 27) - 4 ||
         (N_out + kUnitRows - 1) / kUnitRows >= (1 << 24)))
      return (int)cudaErrorInvalidValue;
    if (idx64)
      return launch_bf16<int64_t>(x, dy, center, masks, patho, worder, order,
                                  tiles, xb, codes, part, dw, N_in, N_out,
                                  Cin, Cout, st);
    return launch_bf16<int32_t>(x, dy, center, masks, patho, worder, order,
                                tiles, xb, codes, part, dw, N_in, N_out, Cin,
                                Cout, st);
  }
  const long long splits =
      split_rows > 0 ? (N_out + split_rows - 1) / split_rows : 0;
  if (split_rows < kWR || split_rows % kWR != 0 ||
      split_rows > kWSteps * kWR || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (idx64)
    return launch_fp32<int64_t>(x, dy, center, masks, patho, worder, part,
                                dw, N_in, N_out, Cin, Cout, split_rows, st);
  return launch_fp32<int32_t>(x, dy, center, masks, patho, worder, part, dw,
                              N_in, N_out, Cin, Cout, split_rows, st);
}
