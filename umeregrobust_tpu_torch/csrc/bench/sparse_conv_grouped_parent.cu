// The grouped k3 conv's bf16 kernel as it stood before its Hopper redesign
// (mma.sync on cp.async-gathered windows and weights, a block-wide vote of
// the groups a 128 / 64 / 32-row tile uses, the bf16 weight copy made every
// call), kept as a yardstick: chip_smoke.py builds it and times it in the
// same call beside ../sparse_conv_grouped.cu (grouped_layer's
// `parent_kernel_ms` and the B = 4 and dX sums). Not part of the kernel
// library (ops/_build.py compiles csrc/*.cu only). Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -shared
// -I csrc csrc/bench/sparse_conv_grouped_parent.cu -o libgrouped_parent.so
// Its entry umr_bench_grouped_parent takes the arguments the library's
// entry took then (scratch xb, wb and the tile rows from the caller).
//
// Grouped-window sparse k=3 convolution, one kernel a layer:
//   out[i] = bias + sum over groups g = 0..8 of
//            [f[r0] | f[r1] | f[r2]] @ w3[g]     (3 Cin x Cout)
// where, with c = center[g, i] - 1, slot 0 reads row c - 1 if masks[g, 0,
// i], slot 1 row c if masks[g, 1, i], slot 2 row c + 1 if masks[g, 2, i],
// else row c if patho[g, i]; any other slot, and any row outside [0,
// N_in), reads zeros. w3[g] = weights.reshape(9, 3, Cin, Cout)[g,
// worder]. fp32 sums; operands bf16 (the main path) or fp32.
//
// Replaces: the window gathers of tools/exp_gather2.py `pg` (the
// gather_rows kernel, 9 launches a conv) and the per-group products in
// ops/sparse.py sparse_conv_grouped, the port of
// umeregrobust_tpu/ops/sparse.py:480 sparse_conv_grouped (a lax.scan over
// the 9 groups in plain XLA, no Pallas kernel).
//
// Bound on the H100. A window's slots are consecutive code-sorted input
// rows, so a group's A operand is 3 Cin wide and its product suits the
// tensor cores. The work counted is 2 x 3 Cin x Cout a window that some
// slot uses, at 989 TFLOP/s bf16; the bytes are the bf16 input rows, the
// map, the weights once and the fp32 output once, at 3.35 TB/s. On
// ResUNetSmall2's 18 layers at one pair both bounds are a few hundredths
// of a ms a layer (chip_smoke.py's grouped_layer rows compute them from
// the maps), so the kernel is set by how well it keeps loads in flight,
// not by either peak.
//
// Design (bf16 operands):
//  - one launch rounds the features to bf16 rows of round8(Cin) columns
//    and the weights to slot-ordered bf16 (9, 3 round8(Cin), round8(Cout))
//    (`cp.async` cannot convert), made per call: the wrapper does not
//    cache them, so a parameter changed by training is always read anew;
//  - output-stationary blocks of 128 rows x 64 channels, 8 warps each 32 x
//    32, fp32 sums in registers until the one write (bias in the epilogue,
//    no atomics, no scratch). Where 128-row tiles would leave SMs idle
//    (the small levels: 16-80 blocks) the tiles have 64 or 32 rows: such
//    a layer is bound by the tensor rate of the SMs its blocks occupy;
//  - the groups run in order g = 0..8, each as K chunks of 64 in
//    ascending order over [slot 0 | slot 1 | slot 2] (each slot
//    round8(Cin) wide, zero past Cin); a group that no row of the tile
//    uses is skipped (a block-wide vote: it would add exact zeros);
//  - a chunk's A tile is staged with 16-byte `cp.async` pieces straight
//    from the window rows (a masked slot or an out-of-range row is a
//    zero-fill, src-size 0), its weight tile likewise, four stages deep
//    (108 KB of dynamic shared memory, two blocks an SM), so the next
//    three steps' copies, group g + 1's included, overlap this step's
//    `mma.sync.m16n8k16` products: a step waits on the latency of
//    gathered rows, so the steps are long and many are in flight; staged
//    rows are 8 bf16 longer than the chunk so that ldmatrix rows fall in
//    distinct banks;
//  - a row's sums run over the same (group, chunk) sequence whatever its
//    tile, its tile's size, the batch or the other rows (a skipped group
//    adds only zeros),
//    so a pair of a batch gets its one-pair bits and two launches agree.
// fp32 operands take an FMA tile of the same order (64 x 64 outputs a
// block, 16 K entries a step, each output one fmaf chain over g, then k
// ascending; no TF32).
// In training the same kernel gives the input's gradient: dX is dY's conv
// over the adjoint map (the pyramid builds it beside the map) with each
// tap's weights transposed, and for a self map the taps reversed; the
// `dx_taps` argument makes the weight copy read them so, and rounds dX to
// bf16 in the epilogue. The weights' gradient is
// sparse_conv_grouped_wgrad.cu.
#include "common.cuh"
#include "grouped_window.cuh"

namespace {

constexpr int kBM = 128;  // output rows a block (also 64 and 32: small grids)
constexpr int kBN = 64;   // output channels a block
constexpr int kKC = 64;   // K entries a step (four k16 products)
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kLdA = kKC + 8;  // bf16 a staged A row (144 B)
constexpr int kLdB = kBN + 8;  // bf16 a staged weight row (144 B)
constexpr size_t kMaxSmem = 232448;  // bytes a block may have on the H100
static_assert((size_t)kStages * (kBM * kLdA + kKC * kLdB) * 2 + 96 <= kMaxSmem,
              "the stages fit a block's shared memory");
constexpr int kFM = 64;        // FMA tile: output rows a block
constexpr int kFN = 64;        //   output channels a block
constexpr int kFK = 16;        //   K entries a step

// Bit g of the result: some row of [row0, row0 + rows) uses group g.
__device__ __forceinline__ unsigned used_groups(
    const unsigned char* __restrict__ masks,
    const unsigned char* __restrict__ patho, int64_t row0, int rows,
    int64_t N_out, unsigned* s_used) {
  if (threadIdx.x == 0) *s_used = 0u;
  __syncthreads();
  unsigned mine = 0u;
  for (int e = threadIdx.x; e < kGroups * rows; e += blockDim.x) {
    const int g = e / rows;
    const int64_t row = row0 + e % rows;
    if (row >= N_out) continue;
    if (window_used(masks, patho, g, row, N_out)) mine |= 1u << g;
  }
  if (mine) atomicOr(s_used, mine);
  __syncthreads();
  return *s_used;
}

// Features -> bf16 rows (N_in, Cin8); weights -> slot-ordered bf16 (9,
// K3 = 3 Cin8, Cout8): row g K3 + s Cin8 + c holds W[3 g + worder[s]][c]
// for c < Cin, zeros past Cin and past Cout, where W is w (dx_taps 0),
// or for a backward's dX, w holding (27, Cout, Cin), W[k] = w[k]^T
// (dx_taps 1) or w[26 - k]^T (dx_taps 2). One thread a 16-byte piece.
__global__ void grouped_prep_kernel(const float* __restrict__ feats,
                                    __nv_bfloat16* __restrict__ xb,
                                    int64_t x_pieces, int Cin,
                                    const float* __restrict__ w,
                                    const long long* __restrict__ worder,
                                    __nv_bfloat16* __restrict__ wb,
                                    int64_t w_pieces, int Cout,
                                    int dx_taps) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < x_pieces) {
    to_bf16_piece(feats, xb, t, Cin);
    return;
  }
  if (t >= x_pieces + w_pieces) return;
  const int Cin8 = round8(Cin), Cout8 = round8(Cout), P = Cout8 / 8;
  const int64_t u = t - x_pieces, row = u / P;
  const int n0 = (int)(u - row * P) * 8;
  const int K3 = 3 * Cin8;
  const int g = (int)(row / K3), k = (int)(row % K3);
  const int s = k / Cin8, c = k - s * Cin8;
  int tap = 3 * g + (int)worder[s];
  if (dx_taps == 2) tap = 26 - tap;
  float v[8];
  if (dx_taps != 0) {
    const float* src = w + (int64_t)tap * Cout * Cin + c;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (c < Cin && n0 + j < Cout) ? src[(int64_t)(n0 + j) * Cin] : 0.f;
  } else {
    const float* src = w + ((int64_t)tap * Cin + c) * Cout;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (c < Cin && n0 + j < Cout) ? src[n0 + j] : 0.f;
  }
  *reinterpret_cast<uint4*>(wb + row * Cout8 + n0) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// The bf16 kernel on BM-row tiles (128, 64 or 32: the wrapper takes the
// largest whose grid fills the SMs). 8 warps: BM / 32 along the rows (32
// rows each), the rest along the 64 channels (CW each).
template <typename IdxT, int BM>
__global__ void __launch_bounds__(kThreads)
    grouped_mma_kernel(const __nv_bfloat16* __restrict__ xb,
                       const __nv_bfloat16* __restrict__ wb,
                       const IdxT* __restrict__ center,
                       const unsigned char* __restrict__ masks,
                       const unsigned char* __restrict__ patho,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int64_t N_in, int64_t N_out,
                       int Cin8, int Cout, int Cout8, int round_out) {
  constexpr int WM = BM / 32, WN = 8 / WM, CW = kBN / WN, NI = CW / 8;
  constexpr int AP = BM / 32;  // A pieces a thread a step
  constexpr int kStage = BM * kLdA + kKC * kLdB;  // bf16 a stage
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ int s_glist[kGroups];
  __shared__ unsigned s_used;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int K3 = 3 * Cin8;
  const int nK = (K3 + kKC - 1) / kKC;

  const unsigned used = used_groups(masks, patho, row0, BM, N_out, &s_used);
  int ng = 0;
  for (int g = 0; g < kGroups; ++g)
    if ((used >> g) & 1u) {
      if (tid == 0) s_glist[ng] = g;
      ++ng;
    }
  __syncthreads();
  const int nsteps = ng * nK;

  // a stage: A [BM][kLdA], then the weights [kKC][kLdB]
  auto sA = [&](int b, int r, int c) {
    return stages + (size_t)b * kStage + r * kLdA + c;
  };
  auto sB = [&](int b, int r, int c) {
    return stages + (size_t)b * kStage + BM * kLdA + r * kLdB + c;
  };
  // copies: A pieces (rows ra + 32 h; 8 columns q8), weight pieces (rows
  // ra + 32 h; 8 channels q8)
  const int ra = tid >> 3, q8 = (tid & 7) * 8;
  int win[AP][3];
  int win_g = -1;
  auto stage_step = [&](int step) {
    const int gi = step / nK, kc = step - gi * nK, g = s_glist[gi];
    if (g != win_g) {
#pragma unroll
      for (int h = 0; h < AP; ++h) {
        const int64_t row = row0 + ra + 32 * h;
        if (row < N_out) {
          window_rows(center, masks, patho, g, row, N_in, N_out, win[h]);
        } else {
          win[h][0] = win[h][1] = win[h][2] = -1;
        }
      }
      win_g = g;
    }
    const int b = step % kStages;
    const int kcol = kc * kKC + q8;
    const int s = kcol / Cin8, c = kcol - s * Cin8;
#pragma unroll
    for (int h = 0; h < AP; ++h) {
      const int src = s == 0 ? win[h][0] : s == 1 ? win[h][1]
                      : s == 2 ? win[h][2] : -1;
      cp_async16(smem_u32(sA(b, ra + 32 * h, q8)),
                 src >= 0 ? (const void*)(xb + (int64_t)src * Cin8 + c)
                          : (const void*)xb,
                 src >= 0 ? 16 : 0);
    }
    const int n = n0 + q8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int krow = kc * kKC + ra + 32 * h;
      const bool wv = krow < K3 && n < Cout8;
      cp_async16(smem_u32(sB(b, ra + 32 * h, q8)),
                 wv ? (const void*)(wb + ((int64_t)g * K3 + krow) * Cout8 + n)
                    : (const void*)wb,
                 wv ? 16 : 0);
    }
  };

  const int wm = warp % WM, wn = warp / WM;  // 32 rows x CW channels
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  float acc[2][NI][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) stage_step(s);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step's stage landed; step - 1's stage is read
    if (step + kStages - 1 < nsteps) stage_step(step + kStages - 1);
    cp_async_commit();
    const int b = step % kStages;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t bf[NI][2];
      if constexpr (NI == 1) {
        ldsm_x2_trans(bf[0], smem_u32(sB(b, kk + (lane & 15), wn * CW)));
      } else {
#pragma unroll
        for (int j = 0; j < NI / 2; ++j) {  // channels 16 j + [0, 16)
          uint32_t r[4];
          ldsm_x4_trans(r, smem_u32(sB(b, kk + (lane & 15),
                                       wn * CW + 16 * j + (lane >> 4) * 8)));
          bf[2 * j][0] = r[0];
          bf[2 * j][1] = r[1];
          bf[2 * j + 1][0] = r[2];
          bf[2 * j + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t a[4];
        ldsm_x4(a, smem_u32(sA(b, wm * 32 + mi * 16 + a_row, kk + a_col)));
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a, bf[ni]);
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight when the block ends

  const int gq = lane >> 2, tq = lane & 3;
  const bool pairs = (Cout & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + wm * 32 + mi * 16 + gq + 8 * h;
      if (row >= N_out) continue;
      float* dst = out + row * Cout;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + wn * CW + ni * 8 + 2 * tq;
        float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (bias != nullptr) {
          if (col < Cout) v0 += bias[col];
          if (col + 1 < Cout) v1 += bias[col + 1];
        }
        if (round_out) {  // a gradient, held in fp32 at bf16 precision
          v0 = __bfloat162float(__float2bfloat16_rn(v0));
          v1 = __bfloat162float(__float2bfloat16_rn(v1));
        }
        if (pairs && col + 1 < Cout) {
          *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
        } else {
          if (col < Cout) dst[col] = v0;
          if (col + 1 < Cout) dst[col + 1] = v1;
        }
      }
    }
}

// fp32 operands: 64 x 64 outputs a block, 4 x 4 a thread, steps of 16 K
// entries over (group, slot, input channel) in that order.
template <typename IdxT>
__global__ void __launch_bounds__(kThreads)
    grouped_fma_kernel(const float* __restrict__ feats,
                       const float* __restrict__ w,
                       const IdxT* __restrict__ center,
                       const unsigned char* __restrict__ masks,
                       const unsigned char* __restrict__ patho,
                       const long long* __restrict__ worder,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int64_t N_in, int64_t N_out,
                       int Cin, int Cout, int dx_taps) {
  __shared__ float sA[kFK][kFM + 4];
  __shared__ __align__(16) float sB[kFK][kFN];
  __shared__ int s_win[3][kFM];
  __shared__ unsigned s_used;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t row0 = (int64_t)blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  const int K3 = 3 * Cin;
  const int w0 = (int)worder[0], w1 = (int)worder[1], w2 = (int)worder[2];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const unsigned used = used_groups(masks, patho, row0, kFM, N_out, &s_used);
  for (int g = 0; g < kGroups; ++g) {
    if (!((used >> g) & 1u)) continue;  // block-uniform
    __syncthreads();  // the previous group's windows are read
    if (tid < kFM) {
      int src[3] = {-1, -1, -1};
      if (row0 + tid < N_out)
        window_rows(center, masks, patho, g, row0 + tid, N_in, N_out, src);
#pragma unroll
      for (int s = 0; s < 3; ++s) s_win[s][tid] = src[s];
    }
    for (int k0 = 0; k0 < K3; k0 += kFK) {
      __syncthreads();  // windows written; the previous step is read
      for (int e = tid; e < kFM * kFK; e += kThreads) {
        const int r = e >> 4, j = e & 15, k = k0 + j;
        const int s = k / Cin, c = k - s * Cin;
        const int src = k < K3 ? s_win[s][r] : -1;
        sA[j][r] = src >= 0 ? feats[(int64_t)src * Cin + c] : 0.f;
      }
      for (int e = tid; e < kFK * kFN; e += kThreads) {
        const int j = e >> 6, n = e & 63, k = k0 + j;
        const int s = k / Cin, c = k - s * Cin;
        int tap = 3 * g + (s == 0 ? w0 : s == 1 ? w1 : w2);
        if (dx_taps == 2) tap = 26 - tap;
        sB[j][n] = (k < K3 && n0 + n < Cout)
                       ? w[dx_taps != 0
                               ? ((int64_t)tap * Cout + n0 + n) * Cin + c
                               : ((int64_t)tap * Cin + c) * Cout + n0 + n]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kFK; ++j) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sA[j][ty * 4 + i];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = sB[j][tx * 4 + q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], bv[q], acc[i][q]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + ty * 4 + i;
    if (row >= N_out) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = n0 + tx * 4 + q;
      if (col < Cout)
        out[row * Cout + col] = bias != nullptr ? acc[i][q] + bias[col]
                                                : acc[i][q];
    }
  }
}

template <typename IdxT, int BM>
int launch_mma(const __nv_bfloat16* xh, const __nv_bfloat16* wh,
               const IdxT* ctr, const unsigned char* masks,
               const unsigned char* patho, const float* bias, float* out,
               int64_t N_in, int64_t N_out, int Cin8, int Cout, int Cout8,
               int round_out, cudaStream_t st) {
  const size_t smem = (size_t)kStages * (BM * kLdA + kKC * kLdB) * 2;
  const int code = (int)cudaFuncSetAttribute(
      grouped_mma_kernel<IdxT, BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (code != 0) return code;
  dim3 grid((unsigned)((N_out + BM - 1) / BM), (Cout + kBN - 1) / kBN);
  grouped_mma_kernel<IdxT, BM><<<grid, kThreads, smem, st>>>(
      xh, wh, ctr, masks, patho, bias, out, N_in, N_out, Cin8, Cout, Cout8,
      round_out);
  return 0;
}

template <typename IdxT>
int launch_grouped(const float* feats, const float* w, const void* center,
                   const unsigned char* masks, const unsigned char* patho,
                   const long long* worder, const float* bias, void* xb,
                   void* wb, float* out, int64_t N_in, int64_t N_out,
                   int Cin, int Cout, bool bf16, int tile_rows,
                   int dx_taps, cudaStream_t st) {
  const IdxT* ctr = static_cast<const IdxT*>(center);
  if (!bf16) {
    dim3 grid((unsigned)((N_out + kFM - 1) / kFM), (Cout + kFN - 1) / kFN);
    grouped_fma_kernel<IdxT><<<grid, kThreads, 0, st>>>(
        feats, w, ctr, masks, patho, worder, bias, out, N_in, N_out, Cin,
        Cout, dx_taps);
    return static_cast<int>(cudaGetLastError());
  }
  const int Cin8 = round8(Cin), Cout8 = round8(Cout);
  __nv_bfloat16* xh = static_cast<__nv_bfloat16*>(xb);
  __nv_bfloat16* wh = static_cast<__nv_bfloat16*>(wb);
  const int64_t px = N_in * (Cin8 / 8);
  const int64_t pw = (int64_t)kGroups * 3 * Cin8 * (Cout8 / 8);
  grouped_prep_kernel<<<(unsigned)((px + pw + 255) / 256), 256, 0, st>>>(
      feats, xh, px, Cin, w, worder, wh, pw, Cout, dx_taps);
  const int round_out = dx_taps != 0;  // a gradient: rounded as autograd
                                       // through the operands' rounding
  const int code =
      tile_rows == 32
          ? launch_mma<IdxT, 32>(xh, wh, ctr, masks, patho, bias, out, N_in,
                                 N_out, Cin8, Cout, Cout8, round_out, st)
      : tile_rows == 64
          ? launch_mma<IdxT, 64>(xh, wh, ctr, masks, patho, bias, out, N_in,
                                 N_out, Cin8, Cout, Cout8, round_out, st)
          : launch_mma<IdxT, kBM>(xh, wh, ctr, masks, patho, bias, out, N_in,
                                  N_out, Cin8, Cout, Cout8, round_out, st);
  if (code != 0) return code;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The grouped k=3 conv (see above). feats (N_in, Cin) f32, weights (27,
// Cin, Cout) f32, center (9, N_out) int32 (idx64 0) or int64 (idx64 1),
// masks (9, 3, N_out) and patho (9, N_out) bool bytes, worder (3,) int64,
// bias (Cout,) f32 or null -> out (N_out, Cout) f32. bf16 1: operands
// rounded to bf16, with caller-allocated scratch xb (max(N_in, 1),
// round8(Cin)) and wb (9, 3 round8(Cin), round8(Cout)) bf16, on row
// tiles of tile_rows (128, 64 or 32; a row's sums run in the same order
// on any); bf16 0: fp32 operands (xb, wb, tile_rows unused). dx_taps 0:
// the conv; 1 or 2: a backward's dX, dY's conv over the adjoint map, with
// weights (27, Cout, Cin) of the forward read as each tap transposed (2:
// also the taps reversed, a self map's adjoint) by the weight copy, and
// with bf16 the output rounded to bf16 (held in fp32).
UMR_EXPORT int umr_bench_grouped_parent(const float* feats, const float* w,
                                        const void* center,
                                        const unsigned char* masks,
                                        const unsigned char* patho,
                                        const long long* worder,
                                        const float* bias, void* xb, void* wb,
                                        float* out, long long N_in,
                                        long long N_out, int Cin, int Cout,
                                        int idx64, int bf16, int tile_rows,
                                        int dx_taps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N_in < 0 || N_out < 1 || N_in >= (1ll << 31) - 8 ||
      N_out >= (1ll << 31) - kBM || Cin < 1 || Cout < 1 ||
      3ll * round8(Cin) >= (1ll << 31) - kKC ||
      (Cout + kBN - 1) / kBN > 65535 || dx_taps < 0 || dx_taps > 2 ||
      (bf16 && (xb == nullptr || wb == nullptr ||
                (tile_rows != 32 && tile_rows != 64 && tile_rows != kBM))))
    return (int)cudaErrorInvalidValue;
  if (idx64)
    return launch_grouped<int64_t>(feats, w, center, masks, patho, worder,
                                   bias, xb, wb, out, N_in, N_out, Cin, Cout,
                                   bf16 != 0, tile_rows, dx_taps, st);
  return launch_grouped<int32_t>(feats, w, center, masks, patho, worder, bias,
                                 xb, wb, out, N_in, N_out, Cin, Cout,
                                 bf16 != 0, tile_rows, dx_taps, st);
}
