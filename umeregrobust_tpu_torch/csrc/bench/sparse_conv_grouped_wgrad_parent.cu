// The grouped k3 conv's weight-gradient kernel as it stood before its
// Hopper redesign (64 x 64 tiles of one group's gradient over splits of
// the output rows in code order, dY rounded to bf16, cp.async stages,
// ldmatrix.trans + mma.sync, a sum launch over the splits), kept as a
// yardstick: chip_smoke.py builds it and times it in the same call beside
// ../sparse_conv_grouped_wgrad.cu (grouped_bwd_layer's
// `parent_dw_kernel_ms` and grouped_bwd_summary). It rounds dY, so only
// its time is compared. Not part of the kernel library (ops/_build.py
// compiles csrc/*.cu only). Build: nvcc -gencode arch=compute_90a,
// code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -shared -I csrc
// csrc/bench/sparse_conv_grouped_wgrad_parent.cu -o libwgrad_parent.so
// Its entry umr_bench_grouped_wgrad_parent takes the arguments the
// library's entry took then (scratch xb, yb, part and split_rows from the
// caller).
//
// The weight gradient of the grouped-window k=3 conv
// (sparse_conv_grouped.cu), one call a layer:
//   dW3[g] = sum over output rows o of x3_g[o]^T dY[o]     (3 Cin x Cout)
// where x3_g[o] = [f[r0] | f[r1] | f[r2]] is the window the forward reads
// for (g, o) (zero slots where the forward reads zeros; see
// grouped_window.cuh), and dW[3 g + worder[s]] = dW3[g][slot s], the
// (27, Cin, Cout) gradient in lexicographic tap order. fp32 sums; operands
// (X and dY) bf16 (the main path) or fp32; with bf16 the result is
// rounded to bf16 and held in fp32.
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
// reads, the dY rows, the map and dW written once, at 3.35 TB/s. On
// ResUNetSmall2's layers at a B = 8 training batch both are a few
// hundredths of a ms a layer, so what sets the time is how well the
// gathered rows' latency is hidden.
//
// Design (bf16 operands):
//  - one launch rounds X to bf16 rows of round8(Cin) columns and dY to
//    bf16 rows of round8(Cout) columns (cp.async cannot convert), made
//    per call;
//  - a block owns a (64 window columns x 64 channels) tile of one group's
//    dW3 and a fixed range of output rows (at most 256 steps of 32 rows:
//    the split over N_out, chosen from the shapes alone), reduces over it
//    in ascending steps, and writes its fp32 partial to scratch; a second
//    launch adds the splits' partials in split order and writes dW in tap
//    order (undoing worder), so no atomics, and two launches agree;
//  - a step is 32 output rows: the rows' windows (a window's slots are
//    consecutive code-sorted input rows, so one window is a contiguous
//    3 round8(Cin) piece of the bf16 copy) and the rows of dY are staged
//    with 16-byte cp.async (masked slots and rows out of range are
//    zero-fills), four stages deep; the products are mma.sync m16n8k16
//    with both operands through ldmatrix.trans (the window rows are the
//    reduction, so A = x3^T is read transposed);
//  - steps in which no row uses the group are skipped (a vote before the
//    loop; the transposed convs use 7-19% of their windows): they would
//    add only zeros, and the order of the others does not change.
// fp32 operands take an FMA tile of the same order (4 x 4 outputs a
// thread, rows ascending, the same splits and the same sum launch).
#include "common.cuh"
#include "grouped_window.cuh"

namespace {

constexpr int kWM = 64;        // dW3 rows (window columns) a block
constexpr int kWN = 64;        // dW3 columns (output channels) a block
constexpr int kWR = 32;        // output rows a step
constexpr int kWStages = 4;
constexpr int kWSteps = 256;   // steps a block at most (one split's rows)
constexpr int kWThreads = 256;
constexpr int kWLd = kWM + 8;  // bf16 a staged row (144 B: ldmatrix rows in
                               // distinct banks)
static_assert(kWN + 8 == kWLd, "A and dY stages share a row pitch");
static_assert(kWSteps == kWThreads, "the vote gives a thread one step");

// X -> bf16 rows (N_in, Cin8), dY -> bf16 rows (N_out, Cout8). One thread
// a 16-byte piece.
__global__ void wgrad_prep_kernel(const float* __restrict__ x,
                                  __nv_bfloat16* __restrict__ xb,
                                  int64_t x_pieces, int Cin,
                                  const float* __restrict__ dy,
                                  __nv_bfloat16* __restrict__ yb,
                                  int64_t y_pieces, int Cout) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < x_pieces) {
    to_bf16_piece(x, xb, t, Cin);
  } else if (t < x_pieces + y_pieces) {
    to_bf16_piece(dy, yb, t - x_pieces, Cout);
  }
}

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

// bf16 operands. Grid (splits, m tiles x n tiles, 9 groups). 8 warps: 2
// along the window columns (32 each), 4 along the channels (16 each).
template <typename IdxT>
__global__ void __launch_bounds__(kWThreads)
    wgrad_mma_kernel(const __nv_bfloat16* __restrict__ xb,
                     const __nv_bfloat16* __restrict__ yb,
                     const IdxT* __restrict__ center,
                     const unsigned char* __restrict__ masks,
                     const unsigned char* __restrict__ patho,
                     float* __restrict__ part, int64_t N_in, int64_t N_out,
                     int Cin8, int Cout8, int split_rows, int n_tiles) {
  __shared__ __align__(16) __nv_bfloat16 sA[kWStages][kWR][kWLd];
  __shared__ __align__(16) __nv_bfloat16 sY[kWStages][kWR][kWLd];
  __shared__ unsigned char s_flag[kWSteps];
  __shared__ int s_warp[kWThreads / 32];
  __shared__ int s_list[kWSteps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, g = blockIdx.z;
  const int m0 = (blockIdx.y / n_tiles) * kWM;
  const int n0 = (blockIdx.y % n_tiles) * kWN;
  const int K3 = 3 * Cin8;
  const int64_t row0 = (int64_t)split * split_rows;
  const int64_t rows = N_out - row0 < split_rows ? N_out - row0 : split_rows;
  const int steps = (int)((rows + kWR - 1) / kWR);
  const int nsteps =
      used_steps(masks, patho, g, row0, steps, N_out, s_flag, s_warp, s_list);

  // copies: a thread one 16-byte piece of the A tile (row ra, window
  // columns m0 + q8 ..) and one of the dY tile (row ra, channels n0 + q8)
  const int ra = tid >> 3, q8 = (tid & 7) * 8;
  const int m = m0 + q8, s = m / Cin8, c = m - s * Cin8;
  const int n = n0 + q8;
  auto issue = [&](int i) {
    const int b = i % kWStages;
    const int64_t row = row0 + (int64_t)s_list[i] * kWR + ra;
    int src = -1;
    if (row < N_out && m < K3) {
      int win[3];
      window_rows(center, masks, patho, g, row, N_in, N_out, win);
      src = win[s];
    }
    cp_async16(smem_u32(&sA[b][ra][q8]),
               src >= 0 ? (const void*)(xb + (int64_t)src * Cin8 + c)
                        : (const void*)xb,
               src >= 0 ? 16 : 0);
    const bool yv = row < N_out && n < Cout8;
    cp_async16(smem_u32(&sY[b][ra][q8]),
               yv ? (const void*)(yb + row * Cout8 + n) : (const void*)yb,
               yv ? 16 : 0);
  };

  const int wm = warp & 1, wn = warp >> 1;  // 32 columns x 16 channels
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  // ldmatrix.trans addresses: A's four 8 x 8 pieces are (columns 0-7 /
  // 8-15) x (rows 0-7 / 8-15), rows being the reduction; dY's as in the
  // forward's weight tile
  const int a_row = (lane & 7) + ((lane >> 4) << 3);
  const int a_col = ((lane >> 3) & 1) * 8;
  const int y_row = lane & 15, y_col = (lane >> 4) * 8;

#pragma unroll
  for (int i = 0; i < kWStages - 1; ++i) {
    if (i < nsteps) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<kWStages - 2>();
    __syncthreads();  // step i's stage landed; step i - 1's stage is read
    if (i + kWStages - 1 < nsteps) issue(i + kWStages - 1);
    cp_async_commit();
    const int b = i % kWStages;
#pragma unroll
    for (int kk = 0; kk < kWR; kk += 16) {
      uint32_t bf[2][2], r[4];
      ldsm_x4_trans(r, smem_u32(&sY[b][kk + y_row][wn * 16 + y_col]));
      bf[0][0] = r[0];
      bf[0][1] = r[1];
      bf[1][0] = r[2];
      bf[1][1] = r[3];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t a[4];
        ldsm_x4_trans(a, smem_u32(&sA[b][kk + a_row]
                                     [wm * 32 + mi * 16 + a_col]));
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma_bf16(acc[mi][ni], a, bf[ni]);
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight when the block ends

  // the partial: (split, g, K3, Cout8) fp32, every entry of the tile that
  // lies in [0, K3) x [0, Cout8) written (zeros where no step ran)
  const int gq = lane >> 2, tq = lane & 3;
  float* dst = part + ((int64_t)split * kGroups + g) * K3 * Cout8;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + mi * 16 + gq + 8 * h;
      if (row >= K3) continue;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int col = n0 + wn * 16 + ni * 8 + 2 * tq;
        if (col < Cout8)
          *reinterpret_cast<float2*>(dst + (int64_t)row * Cout8 + col) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

// fp32 operands: the same tiles and splits, 4 x 4 outputs a thread, each
// one fmaf chain over the rows in ascending order.
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
// with worder[s] = k % 3][c][n]; rounded to bf16 (held in fp32) if bf16.
__global__ void wgrad_grouped_sum_kernel(const float* __restrict__ part,
                                         const long long* __restrict__ worder,
                                         float* __restrict__ dw, int splits,
                                         int Cin, int Cout, int bf16) {
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
  dw[t] = bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <typename IdxT>
int launch_wgrad(const float* x, const float* dy, const void* center,
                 const unsigned char* masks, const unsigned char* patho,
                 const long long* worder, void* xb, void* yb, float* part,
                 float* dw, int64_t N_in, int64_t N_out, int Cin, int Cout,
                 bool bf16, int split_rows, cudaStream_t st) {
  const IdxT* ctr = static_cast<const IdxT*>(center);
  const int Cin8 = round8(Cin), Cout8 = round8(Cout), K3 = 3 * Cin8;
  const int splits = (int)((N_out + split_rows - 1) / split_rows);
  const int n_tiles = (Cout8 + kWN - 1) / kWN;
  dim3 grid((unsigned)splits, ((K3 + kWM - 1) / kWM) * n_tiles, kGroups);
  if (bf16) {
    __nv_bfloat16* xh = static_cast<__nv_bfloat16*>(xb);
    __nv_bfloat16* yh = static_cast<__nv_bfloat16*>(yb);
    const int64_t px = N_in * (Cin8 / 8), py = N_out * (Cout8 / 8);
    wgrad_prep_kernel<<<(unsigned)((px + py + 255) / 256), 256, 0, st>>>(
        x, xh, px, Cin, dy, yh, py, Cout);
    wgrad_mma_kernel<IdxT><<<grid, kWThreads, 0, st>>>(
        xh, yh, ctr, masks, patho, part, N_in, N_out, Cin8, Cout8,
        split_rows, n_tiles);
  } else {
    wgrad_fma_kernel<IdxT><<<grid, kWThreads, 0, st>>>(
        x, dy, ctr, masks, patho, part, N_in, N_out, Cin, Cout, split_rows,
        n_tiles);
  }
  const int64_t total = 27ll * Cin * Cout;
  wgrad_grouped_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, worder, dw, splits, Cin, Cout, bf16 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The grouped conv's weight gradient (see above). x (N_in, Cin) f32, dy
// (N_out, Cout) f32, center (9, N_out) int32 (idx64 0) or int64 (idx64
// 1), masks (9, 3, N_out) and patho (9, N_out) bool bytes, worder (3,)
// int64 -> dw (27, Cin, Cout) f32. Output rows are reduced in splits of
// split_rows (a multiple of 32, at most 8192) into caller-allocated fp32
// scratch part (ceil(N_out / split_rows), 9, 3 round8(Cin),
// round8(Cout)). bf16 1: operands rounded to bf16 into caller-allocated
// xb (max(N_in, 1), round8(Cin)) and yb (N_out, round8(Cout)) bf16, the
// result rounded to bf16; bf16 0: fp32 operands (xb, yb unused).
UMR_EXPORT int umr_bench_grouped_wgrad_parent(
    const float* x, const float* dy, const void* center,
    const unsigned char* masks, const unsigned char* patho,
    const long long* worder, void* xb, void* yb, float* part, float* dw,
    long long N_in, long long N_out, int Cin, int Cout, int idx64, int bf16,
    int split_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long splits =
      split_rows > 0 ? (N_out + split_rows - 1) / split_rows : 0;
  if (N_in < 0 || N_out < 1 || N_in >= (1ll << 31) - 8 ||
      N_out >= (1ll << 31) - kWSteps * kWR || Cin < 1 || Cout < 1 ||
      3ll * round8(Cin) >= (1ll << 31) - kWM || split_rows < kWR ||
      split_rows % kWR != 0 || split_rows > kWSteps * kWR ||
      splits > 65535 || part == nullptr ||
      (bf16 && (xb == nullptr || yb == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (idx64)
    return launch_wgrad<int64_t>(x, dy, center, masks, patho, worder, xb, yb,
                                 part, dw, N_in, N_out, Cin, Cout, bf16 != 0,
                                 split_rows, st);
  return launch_wgrad<int32_t>(x, dy, center, masks, patho, worder, xb, yb,
                               part, dw, N_in, N_out, Cin, Cout, bf16 != 0,
                               split_rows, st);
}
