// Hopper (sm_90a) building blocks, as inline PTX: the asynchronous tensor
// core (wgmma), the tensor memory accelerator (TMA), transaction barriers
// (mbarrier) and named barriers.
//
//  * mbar_*: a 64-bit barrier in shared memory. ``init`` sets how many
//    arrivals complete a phase; ``arrive_expect_tx`` arrives and adds the
//    bytes a TMA copy will deliver, so the phase completes only when they
//    have landed; ``wait`` spins until the phase of the given parity has
//    completed (a fresh barrier is in phase 0, so waiting on parity 1
//    passes at once: the idiom for "the buffer starts empty");
//  * tma_load_4d: one thread asks for a box of a tensor (a CUtensorMap
//    built on the host, passed as a __grid_constant__ kernel parameter)
//    at coordinates {c0 innermost, c1, c2, c3}; the bytes arrive in shared
//    memory, swizzled as the map says, and complete on ``bar``. Elements
//    outside the tensor's extent arrive as zeros;
//  * gmma_desc_sw128: the 64-bit shared-memory matrix descriptor of a
//    wgmma operand stored in 128-byte swizzled rows (the layout a TMA copy
//    with CU_TENSOR_MAP_SWIZZLE_128B writes: row r of 128 bytes at r * 128,
//    its 16-byte chunk c at chunk c ^ (r % 8), tiles 1024-byte aligned).
//    ``lbo`` / ``sbo`` are the leading and stride byte offsets: for a
//    K-major operand the stride between 8-row groups is sbo and lbo is
//    unused; for an MN-major operand lbo steps 64 elements along MN (the
//    next 128-byte column block) and sbo steps 8 rows along K;
//  * wgmma_m64n128k16_ss / _rs: D[64 x 128] (+)= A[64 x 16] B[16 x 128] in
//    bf16 with f32 accumulators, issued by a whole warpgroup (128 threads)
//    and run asynchronously. ``ss``: A and B from shared memory, both
//    K-major. ``rs``: A from registers (the mma.sync m16n8k16 A fragment of
//    each warp's 16 rows), B from shared memory MN-major (N contiguous).
//    The accumulator of thread t (warp w = t / 32, lane l) holds, for
//    n-chunk j (8 columns), d[4j + 0, 1] at row 16w + l/4, columns
//    8j + 2(l%4) + {0, 1}, and d[4j + 2, 3] at row 16w + l/4 + 8: each
//    warp's 16 rows in the mma.sync m16n8 accumulator layout. So two
//    adjacent n-chunks of an f32 accumulator, packed to bf16 pairs, are
//    directly the A fragment of the next product over those 16 columns.
//    scale_d = 0 ignores D's old value. wgmma_fence before the first
//    product of a group (and whenever registers it reads were written by
//    other instructions), commit closes a group, wait<N> blocks until at
//    most N groups are in flight;
//  * fence_regs: an empty asm that "modifies" the registers, so the
//    compiler orders their uses after a wgmma wait (the products write
//    them asynchronously, which the compiler cannot see);
//  * named_bar_sync / _arrive: barrier ``id`` (1..15; 0 is
//    __syncthreads) over ``n`` threads, where an arrive does not wait;
//  * fence_proxy_async: makes this thread's ordinary shared-memory writes
//    visible to the async proxy (wgmma operands, TMA), before the barrier
//    arrive that publishes them.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "mma.cuh"  // smem_addr

// -- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// A wait that has spun ~2^35 cycles (over 15 s at the H100's clocks) has
// lost an arrival: trap, so the launch fails with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// -- TMA --------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch_desc(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// -- wgmma ------------------------------------------------------------------

__device__ __forceinline__ uint64_t gmma_desc_sw128(const void* smem, uint32_t lbo,
                                                    uint32_t sbo) {
  const uint64_t addr = smem_addr(smem);
  return ((addr & 0x3FFFFull) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WGMMA_D64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "      \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define WGMMA_OUT64(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),       \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),       \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),       \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// D (+)= A B, A and B K-major in shared memory (bf16, f32 accumulators)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_OUT64(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (+)= A B, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

#undef WGMMA_D64
#undef WGMMA_OUT64

// -- named barriers, proxies ------------------------------------------------

__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
