// Helpers shared by the attention kernels of this package.
//
// Element access is templated over the compute type T (float or bf16):
// tiles live in shared memory in T, every product and every softmax
// statistic is computed in f32, and probabilities are rounded to T before
// the PV product, as the JAX kernels do with ``p.astype(v.dtype)``. K and V
// may instead be stored as int8 codes with one f32 scale per row (the KVQ
// cache); such a tile is dequantized as it is copied into shared memory:
// code (signed) -> f32, times the row's scale, rounded to T, as the JAX
// kernels do with ``(codes.astype(f32) * scales[:, None]).astype(q.dtype)``.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF_F (-1e30f)

// dtype codes passed from the Python wrappers
#define DTYPE_F32 0
#define DTYPE_BF16 1
#define DTYPE_INT8 2

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
  // f32 -> storage type -> f32 (round to nearest even, like astype)
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// Copy ``rows`` rows of ``d`` elements from global memory (row stride
// ``g_stride`` elements; each row 16-byte aligned) into shared memory at row
// stride ``s_stride`` elements. Rows at or past ``valid`` are zero-filled.
// Global reads are 16-byte vectors; shared writes are 4-byte words, because
// the padded shared row stride (d + 2) keeps rows in distinct banks but is
// only 4-byte aligned.
template <typename T>
__device__ __forceinline__ void load_tile(T* s, int s_stride, const T* g,
                                          int64_t g_stride, int rows,
                                          int valid, int d) {
  const int chunks = d * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      v = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const char*>(g + (int64_t)r * g_stride) + c * 16);
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        reinterpret_cast<char*>(s + (int64_t)r * s_stride) + c * 16);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

// Byte i of w as a signed int8 code, in f32.
__device__ __forceinline__ float code_f(uint32_t w, int i) {
  return (float)(int8_t)(uint8_t)(w >> (8 * i));
}

// Store the 16 int8 codes of ``raw`` times ``scale`` into dst[0..16) in T
// (round to nearest even). dst is 4-byte aligned; it is written in 4-byte
// words, like load_tile's stores.
template <typename T>
__device__ __forceinline__ void store_dequant16(T* dst, uint4 raw, float scale);

template <>
__device__ __forceinline__ void store_dequant16<float>(float* dst, uint4 raw, float scale) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[4 * j + i] = code_f(w[j], i) * scale;
}

template <>
__device__ __forceinline__ void store_dequant16<__nv_bfloat16>(__nv_bfloat16* dst,
                                                               uint4 raw, float scale) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    d2[2 * j] = __floats2bfloat162_rn(code_f(w[j], 0) * scale, code_f(w[j], 1) * scale);
    d2[2 * j + 1] = __floats2bfloat162_rn(code_f(w[j], 2) * scale, code_f(w[j], 3) * scale);
  }
}

// load_tile for an int8 tile: ``rows`` rows of ``d`` codes (row stride
// ``g_stride`` bytes, 16-byte aligned) and their scales (``sc``, stride 1)
// into shared memory in T at row stride ``s_stride`` elements. Rows at or
// past ``valid`` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile_dequant(T* s, int s_stride, const int8_t* g,
                                                  int64_t g_stride, const float* sc,
                                                  int rows, int valid, int d) {
  const int chunks = d / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    float scale = 0.f;
    if (r < valid) {
      v = *reinterpret_cast<const uint4*>(g + (int64_t)r * g_stride + c * 16);
      scale = sc[r];
    }
    store_dequant16<T>(s + (int64_t)r * s_stride + c * 16, v, scale);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once per
// kernel instantiation and size).
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
