// Causal flash attention for prefill on Hopper (sm_90a): three entry
// points over one kernel template.
//
// Replaces the TPU kernels of nats_llm_studio_tpu/ops/flash_attention.py:
//  * flash_attention (body _flash_kernel): causal self-attention over a
//    fresh [B, T] block; q head h reads kv head h // group;
//  * flash_attention_chunk (body _flash_chunk_kernel): chunked-prefill
//    continuation, queries at positions [start, start + C) over the
//    heads-major cache slab [B, Hkv, KW, D] with mask k_pos <= q_pos.
//    ``start`` is a kernel argument, so one build serves every offset, and
//    the ragged KW edge is masked here (the JAX path needs a tileable
//    window or falls back to dense attention; this kernel takes any KW);
//  * flash_attention_chunk_kvq (body _flash_chunk_kvq_kernel): the same
//    continuation over the int8 cache, codes [B, Hkv, KW, D] with f32
//    scales [B, Hkv, KW], each K/V tile dequantized as it is copied into
//    shared memory (code x scale in f32, rounded to q's dtype, as the JAX
//    kernel does), so no dequantized slab ever reaches device memory.
// All three are the same computation with different strides, a query
// offset and a storage type KV for K and V (q's dtype, or int8_t with a
// scale pointer that is null otherwise), so all launch flash_fwd_kernel;
// only the wrappers (and their launch counters) differ.
//
// What bounds it on the H100: operations. Prefill attention does
// 4 x Tq x Tk x D x Hq / 2 flops (causal) on O((Tq + Tk) x D) bytes, far
// above the ~295 flops/byte where the memory stops being the limit.
//
// What the design does about it (FA2-style): one CTA per (query tile of 64
// rows, q-head, batch row); the CTA loops over 64-key tiles with the
// f32 running max / sum / accumulator of the online softmax kept in
// registers and shared memory, so the [Tq, Tk] score matrix never reaches
// device memory; causally dead key tiles are never loaded (the loop stops at
// the tile holding the last real query's position). Each thread computes a
// 4 x 4 block of scores and a 4 x D/16 block of the output from padded
// shared-memory tiles. This first kernel uses f32 FMAs, not the tensor
// cores; mma / wgmma with TMA-fed tile rings is the next step for speed.
//
// Numerics follow the JAX kernels: dots accumulated in f32 and scaled
// after, -1e30 mask, probabilities rounded to V's dtype before the PV
// product, output acc / max(l, 1e-30).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per CTA

// Strided operand views: element strides of batch, sequence and head (the
// last axis is contiguous); ``s`` with ``s_sb`` / ``s_sh`` are the f32
// scales of an int8 K or V (sequence stride 1), null for a K or V in T.
template <typename KV>
struct Operand {
  const KV* p;
  int64_t sb, ss, sh;
  const float* s;
  int64_t s_sb, s_sh;
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_st, int64_t q_sh,
                 const Operand<KV> k, const Operand<KV> v,
                 T* __restrict__ out,  // [B, Lq, Hq, D] contiguous
                 int Lq, int Hq, int Hkv, int kv_len, int start, float scale) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int DS = D + 2;   // padded tile row stride (elements)
  constexpr int SS = BK + 1;  // padded score row stride (floats)
  constexpr int CPT = D / 16; // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* sS = reinterpret_cast<float*>(smem);  // [BQ, SS]
  float* sM = sS + BQ * SS;
  float* sL = sM + BQ;
  float* sC = sL + BQ;
  T* sQ = reinterpret_cast<T*>(sC + BQ);  // BQ*SS + 3*BQ floats: 16B aligned
  T* sK = sQ + BQ * DS;
  T* sV = sK + BK * DS;

  const int qt = blockIdx.x;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int q0 = qt * BQ;
  const int q_valid = min(BQ, Lq - q0);

  load_tile(sQ, DS, q + b * q_sb + (int64_t)q0 * q_st + hq * q_sh, q_st, BQ,
            q_valid, D);
  for (int r = tid; r < BQ; r += NT) {
    sM[r] = NEG_INF_F;
    sL[r] = 0.f;
  }

  const int tr = tid >> 4;  // rows tr*4 .. tr*4+3
  const int tc = tid & 15;  // score cols tc + 16j, output cols tc + 16c
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  // keys past the tile's last real query position are causally dead
  const int q_last = start + q0 + q_valid - 1;
  const int n_keys = min(kv_len, q_last + 1);
  const int n_kt = (n_keys + BK - 1) / BK;
  const KV* kb = k.p + b * k.sb + hk * k.sh;
  const KV* vb = v.p + b * v.sb + hk * v.sh;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const int k_valid = min(BK, kv_len - k0);
    __syncthreads();  // previous tile done with sK / sV / sS
    if constexpr (QUANT) {
      load_tile_dequant(sK, DS, kb + (int64_t)k0 * k.ss, k.ss,
                        k.s + b * k.s_sb + hk * k.s_sh + k0, BK, k_valid, D);
      load_tile_dequant(sV, DS, vb + (int64_t)k0 * v.ss, v.ss,
                        v.s + b * v.s_sb + hk * v.s_sh + k0, BK, k_valid, D);
    } else {
      load_tile(sK, DS, kb + (int64_t)k0 * k.ss, k.ss, BK, k_valid, D);
      load_tile(sV, DS, vb + (int64_t)k0 * v.ss, v.ss, BK, k_valid, D);
    }
    __syncthreads();

    // scores: rows tr*4+i, cols tc+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
      float2 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Elem<T>::load2(sQ + (tr * 4 + i) * DS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = Elem<T>::load2(sK + (tc + 16 * j) * DS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tr * 4 + i;
      const int qp = start + q0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tc + 16 * j;
        const int kp = k0 + col;
        float val = s[i][j] * scale;
        if (kp > qp || kp >= kv_len) val = NEG_INF_F;
        sS[row * SS + col] = val;
      }
    }
    __syncthreads();

    // online softmax: four lanes per row, 16 columns each
    {
      const int row = tid >> 2;
      const int part = tid & 3;
      float* sr = sS + row * SS + part * 16;
      float mx = NEG_INF_F;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, sr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sM[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(sr[c] - m_new);
        sum += p;
        sr[c] = Elem<T>::round(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        sC[row] = corr;
        sL[row] = sL[row] * corr + sum;
        sM[row] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sC[tr * 4 + i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sS[(tr * 4 + i) * SS + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = Elem<T>::to_f(sV[kk * DS + tc + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tr * 4 + i;
    if (row >= q_valid) continue;
    const float l = fmaxf(sL[row], 1e-30f);
    T* orow = out + ((int64_t)(b * Lq + q0 + row) * Hq + hq) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tc + 16 * c] = Elem<T>::from_f(acc[i][c] / l);
  }
}

template <typename T, int D>
size_t flash_smem_bytes() {
  return (size_t)(BQ * (BK + 1) + 3 * BQ) * 4 + (size_t)(BQ + 2 * BK) * (D + 2) * sizeof(T);
}

template <typename T, typename KV, int D>
int launch_flash(const void* q, int64_t q_sb, int64_t q_st, int64_t q_sh,
                 const Operand<KV>& k, const Operand<KV>& v, void* out, int B, int Lq,
                 int Hq, int Hkv, int kv_len, int start, float scale,
                 cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<T, D>();
  cudaError_t e = allow_smem(flash_fwd_kernel<T, KV, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, KV, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_st, q_sh, k, v, static_cast<T*>(out), Lq, Hq,
      Hkv, kv_len, start, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int dispatch_d(int D, const void* q, int64_t q_sb, int64_t q_st, int64_t q_sh,
               const Operand<KV>& k, const Operand<KV>& v, void* out, int B, int Lq,
               int Hq, int Hkv, int kv_len, int start, float scale, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch_flash<T, KV, 64>(q, q_sb, q_st, q_sh, k, v, out, B, Lq, Hq, Hkv,
                                     kv_len, start, scale, s);
    case 128:
      return launch_flash<T, KV, 128>(q, q_sb, q_st, q_sh, k, v, out, B, Lq, Hq, Hkv,
                                      kv_len, start, scale, s);
    case 256:
      return launch_flash<T, KV, 256>(q, q_sb, q_st, q_sh, k, v, out, B, Lq, Hq, Hkv,
                                      kv_len, start, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K and V in q's dtype (K2, K3)
int dispatch(int dtype, int D, const void* q, int64_t q_sb, int64_t q_st,
             int64_t q_sh, const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
             const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh, void* out,
             int B, int Lq, int Hq, int Hkv, int kv_len, int start, float scale,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) {
    using T = __nv_bfloat16;
    const Operand<T> ko{static_cast<const T*>(k), k_sb, k_ss, k_sh, nullptr, 0, 0};
    const Operand<T> vo{static_cast<const T*>(v), v_sb, v_ss, v_sh, nullptr, 0, 0};
    return dispatch_d<T, T>(D, q, q_sb, q_st, q_sh, ko, vo, out, B, Lq, Hq, Hkv, kv_len,
                            start, scale, s);
  }
  if (dtype == DTYPE_F32) {
    const Operand<float> ko{static_cast<const float*>(k), k_sb, k_ss, k_sh, nullptr, 0, 0};
    const Operand<float> vo{static_cast<const float*>(v), v_sb, v_ss, v_sh, nullptr, 0, 0};
    return dispatch_d<float, float>(D, q, q_sb, q_st, q_sh, ko, vo, out, B, Lq, Hq, Hkv,
                                    kv_len, start, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K2: fresh causal prefill. q [B, T, Hq, D], k/v [B, T, Hkv, D] given by
// strides (elements; the last axis is contiguous); out [B, T, Hq, D].
int flash_attention(int dtype, int D, const void* q, int64_t q_sb, int64_t q_st,
                    int64_t q_sh, const void* k, int64_t k_sb, int64_t k_ss,
                    int64_t k_sh, const void* v, int64_t v_sb, int64_t v_ss,
                    int64_t v_sh, void* out, int B, int T, int Hq, int Hkv,
                    float scale, void* stream) {
  return dispatch(dtype, D, q, q_sb, q_st, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss,
                  v_sh, out, B, T, Hq, Hkv, T, 0, scale, stream);
}

// K3: chunk continuation. q [B, C, Hq, D] at positions [start, start + C);
// k/v the cache slab [B, Hkv, KW, D] given by strides; out [B, C, Hq, D].
int flash_attention_chunk(int dtype, int D, const void* q, int64_t q_sb,
                          int64_t q_st, int64_t q_sh, const void* k, int64_t k_sb,
                          int64_t k_sh, int64_t k_ss, const void* v, int64_t v_sb,
                          int64_t v_sh, int64_t v_ss, void* out, int B, int C,
                          int Hq, int Hkv, int KW, int start, float scale,
                          void* stream) {
  return dispatch(dtype, D, q, q_sb, q_st, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss,
                  v_sh, out, B, C, Hq, Hkv, KW, start, scale, stream);
}

// K4: chunk continuation over the int8 cache. kq/vq: codes [B, Hkv, KW, D]
// given by strides in elements (= bytes; 16-byte aligned rows); ks/vs: f32
// scales [B, Hkv, KW] given by batch and head strides (sequence stride 1).
// q and out in ``dtype``, as K3.
int flash_attention_chunk_kvq(int dtype, int D, const void* q, int64_t q_sb,
                              int64_t q_st, int64_t q_sh, const void* kq, int64_t k_sb,
                              int64_t k_sh, int64_t k_ss, const float* ks, int64_t ks_sb,
                              int64_t ks_sh, const void* vq, int64_t v_sb, int64_t v_sh,
                              int64_t v_ss, const float* vs, int64_t vs_sb,
                              int64_t vs_sh, void* out, int B, int C, int Hq, int Hkv,
                              int KW, int start, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operand<int8_t> ko{static_cast<const int8_t*>(kq), k_sb, k_ss, k_sh, ks, ks_sb,
                           ks_sh};
  const Operand<int8_t> vo{static_cast<const int8_t*>(vq), v_sb, v_ss, v_sh, vs, vs_sb,
                           vs_sh};
  if (ks == nullptr || vs == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return dispatch_d<__nv_bfloat16, int8_t>(D, q, q_sb, q_st, q_sh, ko, vo, out, B, C,
                                             Hq, Hkv, KW, start, scale, s);
  if (dtype == DTYPE_F32)
    return dispatch_d<float, int8_t>(D, q, q_sb, q_st, q_sh, ko, vo, out, B, C, Hq, Hkv,
                                     KW, start, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
