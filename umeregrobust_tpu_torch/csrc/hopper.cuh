// Hopper pieces of the grouped conv's weight gradient
// (sparse_conv_grouped_wgrad.cu): mbarriers, the cp.async arrivals on them,
// bulk (TMA) copies, and wgmma m64n64k16 with A from registers and B read
// from shared memory in MN-major order (128-byte swizzle). The forward
// kernel (sparse_conv_grouped.cu) keeps its own copies of the barrier and
// bulk-copy pieces.
#pragma once
#include <stdint.h>

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// A release arrival: the thread's earlier shared-memory writes are seen by
// the threads that wait on the phase.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}
// An arrival that also expects `bytes` more of asynchronous copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], "
      "%1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// One bulk copy (TMA) of `bytes` (a multiple of 16, 16-byte aligned ends)
// global -> shared, its bytes counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Arrives on `bar` when the thread's earlier cp.async copies have landed
// (counted in the barrier's arrivals: noinc).
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits for the phase of `bar` with this parity to complete. A wait that
// never ends is a fault of the kernel: it traps (the launch fails) rather
// than hold the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2;\nselp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}
// 4 bytes global -> shared; bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A shared-memory matrix descriptor of an MN-major operand: 64 elements
// (128 bytes) of N contiguous a K row, K rows 128 bytes apart in 8-row
// groups of 1024 bytes (SBO), 128-byte swizzle (16-byte piece j of K row
// r at place j ^ (r % 8)); N atoms of 64 `lbo` bytes apart. The base is
// 1024-aligned.
__device__ __forceinline__ uint64_t mn_sw128_desc(uint32_t addr,
                                                  uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 64 fp32, the warpgroup's fragments) += a (64 x 16 bf16 from
// registers: warp w rows 16 w + [0, 16), mma.m16n8k16's A layout) x b
// (16 x 64 bf16, MN-major in shared memory: imm-trans-b 1).
__device__ __forceinline__ void wgmma_n64_ra(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator reads and writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
