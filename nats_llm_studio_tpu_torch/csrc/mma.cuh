// Warp-level tensor-core and asynchronous-copy building blocks (sm_80+,
// built here for sm_90a), as inline PTX:
//
//  * cp_async16: one 16-byte cp.async.cg global -> shared copy (L2 only,
//    bypassing L1), zero-filling the destination when ``valid`` is false;
//    cp_async4 the same for 4 bytes (cp.async.ca: .cg takes 16 only), for
//    operands that are 4-byte but not always 16-byte aligned;
//    cp_async_commit / cp_async_wait<N> close a group of copies and wait
//    until at most N groups are still in flight;
//  * ldmatrix_x4 / ldmatrix_x4_trans: four 8x8 b16 matrices from shared
//    memory into the fragment layout of mma.sync; lanes 8i..8i+7 give the
//    row addresses (16-byte aligned) of matrix i, and register i receives
//    matrix i (transposed with ``_trans``);
//  * mma_bf16_16816: D = A B + D with A 16x16 bf16 (row), B 16x8 bf16
//    (col), D 16x8 f32. With g = lane / 4 and t = lane % 4, lane holds
//    A {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)},
//    B {(2t..2t+1, g), (2t+8.., g)} and D {(g, 2t), (g, 2t+1), (g+8, 2t),
//    (g+8, 2t+1)}; so a 16x16 block of two D tiles, packed to bf16 pairs,
//    is the A operand of the next product without moving between lanes
//    (pack_bf16 packs a pair);
//  * fast_exp2: 2^x on the SFU, for softmax probabilities;
//  * dequant8_bf16: 8 int8 codes times an f32 scale, rounded to bf16.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU's ex2.approx (relative error ~2^-22). Results below 2^-126
// flush to 0: as softmax probabilities they sit beside a 1 (the row's max)
// in every sum they enter, so nothing an f32 sum can hold is lost.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to bf16 (nearest even), ``lo`` in the low half:
// the order of an mma operand register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Byte i of ``wx`` (a word of int8 codes, each XORed with 0x80) as the
// code's value in f32, exactly: the byte becomes the low mantissa bits of
// 2^23 (one PRMT), and 2^23 + 128 is subtracted (one FADD); two plain ALU
// instructions in place of an I2F conversion.
template <int I>
__device__ __forceinline__ float code_value(uint32_t wx) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7650 + I)) - 8388736.f;
}

// The 8 int8 codes of ``w`` (little-endian: code 0 in the low byte of
// w.x) times ``scale`` in f32, each rounded to bf16 (nearest even): the
// JAX kernels' (codes.astype(f32) * scales[:, None]).astype(bf16), bit
// for bit. Returned as the 16 bytes of 8 consecutive bf16 values.
__device__ __forceinline__ uint4 dequant8_bf16(uint2 w, float scale) {
  const uint32_t a = w.x ^ 0x80808080u, b = w.y ^ 0x80808080u;
  uint4 o;
  o.x = pack_bf16(code_value<0>(a) * scale, code_value<1>(a) * scale);
  o.y = pack_bf16(code_value<2>(a) * scale, code_value<3>(a) * scale);
  o.z = pack_bf16(code_value<0>(b) * scale, code_value<1>(b) * scale);
  o.w = pack_bf16(code_value<2>(b) * scale, code_value<3>(b) * scale);
  return o;
}
