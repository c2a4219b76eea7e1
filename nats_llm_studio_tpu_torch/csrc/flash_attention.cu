// Causal flash attention for prefill on Hopper (sm_90a): three entry
// points over two kernel bodies.
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
//    scales [B, Hkv, KW], each K/V tile dequantized in shared memory (code
//    x scale in f32, rounded to q's dtype, as the JAX kernels do), so no
//    dequantized slab ever reaches device memory.
// All three are the same computation with different strides, a query
// offset and a storage type KV for K and V; only the wrappers (and their
// launch counters) differ.
//
// What bounds it on the H100: operations. Prefill attention does
// 4 x Tq x Tk x D x Hq / 2 flops (causal) on O((Tq + Tk) x D) bytes, far
// above the ~295 flops/byte where the memory stops being the limit, so the
// products belong on the tensor cores.
//
// Which body serves which (q dtype, K/V storage), chosen by type in
// dispatch(), with no fallback between them (D in {64, 128, 256} for all):
//  * (bf16, bf16), K2 and K3, and (bf16, int8), K4:
//    flash_fwd_mma_kernel<KV, D>, the tensor-core body. One CTA of 4 warps
//    per (64-row query tile, q-head, batch row); each warp owns 16 query
//    rows. Q (once) and each 64-key K and V tile arrive by 16-byte cp.async
//    copies into a three-stage ring: tiles kt+1 and kt+2 load while tile kt
//    is in the tensor cores. Shared rows are unpadded with an XOR swizzle of
//    their 16-byte chunks, so ldmatrix and the copies are free of bank
//    conflicts. QK^T and PV are mma.sync m16n8k16 bf16 products with f32
//    accumulators, fed by ldmatrix (V by ldmatrix.trans); Q's fragments
//    stay in registers across the key loop for D <= 128 and are reloaded
//    from shared memory per k-step at D = 256 (the O accumulator there is
//    already 128 f32 registers a thread). Scores stay in the accumulator
//    registers: the mask (only on tiles that straddle the diagonal or the
//    kv_len edge) and the online softmax run on the fragments, with row max
//    and sum reduced over the 4-lane quad that shares a row; the output is
//    rescaled only when a row's max moved; and the probabilities, rounded
//    to bf16 in registers, are directly the A operand of the PV product.
//    Query tiles launch with the most keys first. Only the load stage
//    depends on KV:
//      - bf16: the ring holds the bf16 K and V tiles themselves, with one
//        block barrier per tile (112 KB a CTA at D = 128: two CTAs an SM);
//      - int8: the ring holds codes (16-byte copies, half a bf16 tile) and
//        their f32 row scales (4-byte copies: a scales view of a row cache
//        need not be 16-byte aligned) in one commit group a tile. The
//        operands are two bf16 K and two bf16 V tiles: while the warps run
//        tile kt's products from one pair, they dequantize tile kt + 1's
//        codes into the other (code -> f32 by a byte permute and one add,
//        times the row scale, rounded to nearest even: the JAX kernel's
//        (codes.astype(f32) * scales[:, None]).astype(q.dtype), bit for
//        bit; 8 codes a thread at a time, K and V interleaved and
//        unrolled), with one block barrier per tile (faster on the card
//        than one bf16 pair and two barriers a tile: PERF.md). 129.5 KB a CTA at
//        D = 128 (Q 16 KB, bf16 tiles 64 KB, code ring 3 x 16.5 KB): one CTA
//        an SM, which the main path's chunk (128 CTAs) fills in one wave;
//        at D = 256 the code ring has two stages (225 KB).
//    Bounded by operations, as above; the int8 body moves half the K/V
//    bytes and adds ~3.5 instructions a key element to dequantize.
//  * (f32, f32) and (f32, int8), f32 K2/K3/K4: flash_fwd_kernel<T, KV, D>,
//    f32 FMAs from padded shared-memory tiles (TF32 mma would miss the f32
//    tests' 1e-4); each thread computes a 4 x 4 block of scores and a
//    4 x D/16 block of the output, the score tile goes through shared
//    memory, and an int8 tile is dequantized as it is copied.
// Both are FA2-style: the f32 running max / sum / accumulator of the online
// softmax never leave the CTA, so the [Tq, Tk] score matrix never reaches
// device memory, and causally dead key tiles are never loaded (the loop
// stops at the tile holding the last real query's position).
//
// Numerics follow the JAX kernels: dots accumulated in f32 and scaled
// after, -1e30 mask, row sums of the unrounded probabilities, probabilities
// rounded to V's dtype before the PV product, output acc / max(l, 1e-30).
// The tensor-core body folds log2(e) into the scale and takes ex2.approx of
// (s - max) in base 2, which is exp(s - max) to ~2^-22 relative, far below
// the bf16 rounding of p that follows.

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

// -- tensor-core body: (bf16, bf16) and (bf16, int8) ------------------------

using bf16 = __nv_bfloat16;

constexpr int MMA_NT = 128;    // 4 warps, 16 query rows each (BQ = 64)
constexpr int MMA_STAGES = 3;  // copy ring: tiles kt + 1 and kt + 2 load during tile kt
constexpr float LOG2E = 1.4426950408889634f;

// Shared tiles are unpadded, D elements a row, with the 16-byte chunk c of
// row r stored at chunk c ^ (r % 8): the 8 rows one ldmatrix reads, and the
// row chunks a warp's cp.async copies write, fall in 8 distinct 16-byte
// bank groups. Offset (elements) of chunk ``c`` of row ``r``:
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// Shared memory of the tensor-core body. bf16 K/V: Q, then the K and V
// rings of MMA_STAGES bf16 tiles. int8 K/V: Q, two bf16 K and two bf16 V
// tiles (the mma operands of tile kt and, being written, of tile kt + 1),
// then the code ring: CODE_STAGES stages of K codes, V codes (BK x D bytes
// each), K scales and V scales (BK f32 each); two stages at D = 256, where
// three would not fit.
template <typename KV, int D>
struct MmaSmem {
  static constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  static constexpr int TILE = BK * D;  // elements of one K or V tile
  static constexpr int BUFS = QUANT ? 2 : 1;  // int8: bf16 operand tiles
  static constexpr int CODE_STAGES = D == 256 ? 2 : 3;
  static constexpr int CODE_STAGE = 2 * TILE + 2 * BK * 4;  // bytes of one code stage
  static constexpr size_t bytes =
      QUANT ? (size_t)(BQ + 2 * BUFS * BK) * D * sizeof(bf16) +
                  (size_t)CODE_STAGES * CODE_STAGE
            : (size_t)(BQ + 2 * MMA_STAGES * BK) * D * sizeof(bf16);
};

// Start the 16-byte cp.async copies of a ROWS x D tile (global row stride
// ``g_stride`` elements) into swizzled shared memory; rows at or past
// ``valid`` are zero-filled (no global read).
template <int D, int ROWS>
__device__ __forceinline__ void cp_async_tile(bf16* s, const bf16* g, int64_t g_stride,
                                              int valid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CH % MMA_NT == 0, "tile chunks must divide among the threads");
#pragma unroll
  for (int it = 0; it < ROWS * CH / MMA_NT; ++it) {
    const int i = it * MMA_NT + threadIdx.x;
    const int r = i / CH;
    const int c = i - r * CH;
    const bool ok = r < valid;
    cp_async16(s + swz<D>(r, c), g + (int64_t)(ok ? r : 0) * g_stride + c * 8, ok);
  }
}

// The same for a BK x D tile of int8 codes into an unswizzled code stage
// (row stride D bytes), and its BK f32 scales (sequence stride 1; 4-byte
// copies, since a scales view need not be 16-byte aligned): thread i < BK
// copies K scale i, thread BK + i V scale i. Rows at or past ``valid``:
// codes and scale zero-filled.
template <int D>
__device__ __forceinline__ void cp_async_code_tile(int8_t* s, const int8_t* g,
                                                   int64_t g_stride, int valid) {
  constexpr int CH = D / 16;
  static_assert(BK * CH % MMA_NT == 0, "code chunks must divide among the threads");
#pragma unroll
  for (int it = 0; it < BK * CH / MMA_NT; ++it) {
    const int i = it * MMA_NT + threadIdx.x;
    const int r = i / CH;
    const int c = i - r * CH;
    const bool ok = r < valid;
    cp_async16(s + r * D + c * 16, g + (int64_t)(ok ? r : 0) * g_stride + c * 16, ok);
  }
}

// Dequantize a landed code stage into the swizzled bf16 tile ``s``: each
// thread turns 8 codes (one 8-byte shared read) into one 16-byte bf16 chunk,
// so a quarter warp writes 8 distinct chunks of one row (no bank conflict).
// Dequantize a landed code stage into the swizzled bf16 K and V tiles
// ``sk`` / ``sv``: each thread turns 8 codes (one 8-byte shared read) into
// one 16-byte bf16 chunk, so a quarter warp writes 8 distinct chunks of one
// row (no bank conflict). K and V chunks alternate and the loop is
// unrolled, so one warp has many independent conversions in flight.
template <int D>
__device__ __forceinline__ void dequant_kv(bf16* sk, bf16* sv, const int8_t* st,
                                           const float* sc) {
  constexpr int CH = D / 8;
  constexpr int TILE = BK * D;
  static_assert(BK * CH % MMA_NT == 0, "tile chunks must divide among the threads");
#pragma unroll
  for (int it = 0; it < BK * CH / MMA_NT; ++it) {
    const int i = it * MMA_NT + threadIdx.x;
    const int r = i / CH;
    const int c = i - r * CH;
    const uint2 wk = *reinterpret_cast<const uint2*>(st + r * D + c * 8);
    const uint2 wv = *reinterpret_cast<const uint2*>(st + TILE + r * D + c * 8);
    *reinterpret_cast<uint4*>(sk + swz<D>(r, c)) = dequant8_bf16(wk, sc[r]);
    *reinterpret_cast<uint4*>(sv + swz<D>(r, c)) = dequant8_bf16(wv, sc[BK + r]);
  }
}

template <typename KV, int D>
__global__ void __launch_bounds__(MMA_NT)
flash_fwd_mma_kernel(const bf16* __restrict__ q, int64_t q_sb, int64_t q_st, int64_t q_sh,
                     const Operand<KV> k, const Operand<KV> v,
                     bf16* __restrict__ out,  // [B, Lq, Hq, D] contiguous
                     int Lq, int Hq, int Hkv, int kv_len, int start, float scale_log2) {
  using S = MmaSmem<KV, D>;
  constexpr bool QUANT = S::QUANT;
  constexpr int TILE = S::TILE;
  constexpr int KSTEPS = D / 16;  // k-steps of QK^T
  constexpr int NS = BK / 8;      // 8-key n-tiles of a warp's scores
  constexpr int NO = D / 8;       // 8-column n-tiles of a warp's output
  // Q's fragments stay in registers across the key loop up to D = 128; at
  // D = 256 the output tile alone takes 128 registers a thread, so they
  // are reloaded from shared memory per k-step
  constexpr bool Q_IN_REGS = D <= 128;
  static_assert(BQ == 16 * (MMA_NT / 32), "one warp per 16 query rows");
  static_assert(MMA_STAGES == 3, "tile kt + 2 refills the stage of tile kt - 1");
  static_assert(2 * BK == MMA_NT, "one scale copy a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [BQ][D]
  // bf16: the K and V rings [MMA_STAGES][BK][D]; int8: two bf16 tiles each
  bf16* sK = sQ + BQ * D;
  bf16* sV = sK + (QUANT ? S::BUFS : MMA_STAGES) * TILE;
  int8_t* sCodes = reinterpret_cast<int8_t*>(sV + S::BUFS * TILE);  // int8: the code ring
  constexpr int CS = S::CODE_STAGES;
  // int8: codes and scales of ring stage ``code_stage`` -> bf16 buffer ``buf``
  auto dequant = [&](int code_stage, int buf) {
    const int8_t* st = sCodes + code_stage * S::CODE_STAGE;
    dequant_kv<D>(sK + buf * TILE, sV + buf * TILE, st,
                  reinterpret_cast<const float*>(st + 2 * TILE));
  };

  const int qt = gridDim.x - 1 - blockIdx.x;  // the tiles with the most keys first
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qt * BQ;
  const int q_valid = min(BQ, Lq - q0);

  // keys past the tile's last real query position are causally dead
  const int q_last = start + q0 + q_valid - 1;
  const int n_keys = min(kv_len, q_last + 1);
  const int n_kt = (n_keys + BK - 1) / BK;
  const KV* kb = k.p + b * k.sb + hk * k.sh;
  const KV* vb = v.p + b * v.sb + hk * v.sh;
  // the copies of tile kt into ring stage ``stage``: bf16 tiles, or codes
  // and scales
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * BK;
    const int valid = min(BK, kv_len - k0);
    if constexpr (QUANT) {
      int8_t* st = sCodes + stage * S::CODE_STAGE;
      cp_async_code_tile<D>(st, kb + (int64_t)k0 * k.ss, k.ss, valid);
      cp_async_code_tile<D>(st + TILE, vb + (int64_t)k0 * v.ss, v.ss, valid);
      // thread i < BK copies K scale i, thread BK + i V scale i: the K and
      // V scales sit one after the other at the end of the stage
      const int r = threadIdx.x & (BK - 1);
      const bool ok = r < valid;
      const Operand<KV>& o = threadIdx.x < BK ? k : v;
      cp_async4(st + 2 * TILE + threadIdx.x * 4,
                o.s + b * o.s_sb + hk * o.s_sh + k0 + (ok ? r : 0), ok);
    } else {
      cp_async_tile<D, BK>(sK + stage * TILE, kb + (int64_t)k0 * k.ss, k.ss, valid);
      cp_async_tile<D, BK>(sV + stage * TILE, vb + (int64_t)k0 * v.ss, v.ss, valid);
    }
  };

  // ring prologue: Q with tile 0, then tile 1 (int8: tiles 1 .. CS - 1), one
  // copy group each
  cp_async_tile<D, BQ>(sQ, q + b * q_sb + (int64_t)q0 * q_st + hq * q_sh, q_st, q_valid);
  if (n_kt > 0) load_kv(0, 0);
  cp_async_commit();
  if constexpr (QUANT) {  // tiles 1 .. CS - 1, then tile 0's bf16 tiles
#pragma unroll
    for (int j = 1; j < CS; ++j) {
      if (j < n_kt) load_kv(j, j);
      cp_async_commit();
    }
    cp_async_wait<CS - 1>();
    __syncthreads();
    if (n_kt > 0) dequant(0, 0);
  } else {
    if (n_kt > 1) load_kv(1, 1);
    cp_async_commit();
  }

  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {NEG_INF_F, NEG_INF_F};  // running max of rows g and g + 8 (base 2)
  float l[2] = {0.f, 0.f};              // this lane's share of their running sums
  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];
  // q position of this lane's row g (accumulator elements 0, 1); g + 8 holds 2, 3
  const int qp0 = start + q0 + warp * 16 + (lane >> 2);
  // ldmatrix row addresses: every row this lane addresses is 8-aligned plus
  // lane % 8, so its chunk swizzle is a per-lane XOR
  const int x_qv = (lane >> 4) ^ (lane & 7);        // Q and V: chunk 2 * step + lane / 16
  const int x_k = ((lane >> 3) & 1) ^ (lane & 7);   // K: chunk 2 * step + (lane / 8) % 2
  const bf16* sQw = sQ + (warp * 16 + (lane & 15)) * D;
  const int k_row = ((lane >> 4) * 8 + (lane & 7)) * D;         // + 16 keys per n-pair
  const int v_row = (((lane >> 3) & 1) * 8 + (lane & 7)) * D;   // + 16 keys per k-step

  int stage = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const bf16* sKs = sK;
    const bf16* sVs = sV;
    if constexpr (QUANT) {
      cp_async_wait<CS - 2>();  // the codes of tile kt + 1 have landed
      __syncthreads();  // ... for every thread; tile kt's bf16 tiles are complete, and
                        // every warp is done with buffer (kt + 1) % 2 (tile kt - 1)
      if (kt + CS < n_kt) load_kv(kt + CS, stage);  // tile kt's code stage
      cp_async_commit();
      sKs += (kt & 1) * TILE;
      sVs += (kt & 1) * TILE;
    } else {
      cp_async_wait<1>();  // tile kt has landed; tile kt + 1 may still be in flight
      __syncthreads();     // ... for every thread, and every warp is done with tile kt - 1
      if (kt + 2 < n_kt) load_kv(kt + 2, stage == 0 ? 2 : stage - 1);  // tile kt - 1's stage
      cp_async_commit();
      sKs += stage * TILE;
      sVs += stage * TILE;
    }
    const int k0 = kt * BK;
    if constexpr (Q_IN_REGS) {
      if (kt == 0) {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) ldmatrix_x4(qf[ks], sQw + (((2 * ks) ^ x_qv) << 3));
      }
    }
    // S = Q K^T: this warp's 16 rows x BK keys, in NS accumulator tiles
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        ldmatrix_x4(a, sQw + (((2 * ks) ^ x_qv) << 3));
      }
      const int kc = ((2 * ks) ^ x_k) << 3;
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];  // keys np*16 .. +7 and +8 .. +15, dims ks*16 .. +15
        ldmatrix_x4(kf, sKs + np * 16 * D + k_row + kc);
        mma_bf16_16816(s[2 * np], a, kf[0], kf[1]);
        mma_bf16_16816(s[2 * np + 1], a, kf[2], kf[3]);
      }
    }

    // scale (base 2) and mask; only tiles that straddle the diagonal or the
    // kv_len edge need the mask
    const bool edge = k0 + BK - 1 > start + q0 || k0 + BK > kv_len;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int kp = k0 + nt * 8 + (lane & 3) * 2 + (e & 1);
          if (kp > qp0 + (e >> 1) * 8 || kp >= kv_len) x = NEG_INF_F;
        }
        s[nt][e] = x;
      }

    // online softmax on the fragments: row h of this lane is g + 8h
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[h] = fast_exp2(m[h] - mx);
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float p0 = fast_exp2(s[nt][2 * h] - mx);
        const float p1 = fast_exp2(s[nt][2 * h + 1] - mx);
        s[nt][2 * h] = p0;
        s[nt][2 * h + 1] = p1;
        sum += p0 + p1;
      }
      l[h] = l[h] * corr[h] + sum;
    }
    // rescale the output only when some row's max moved (x 1 is exact)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int dt = 0; dt < NO; ++dt) {
        o[dt][0] *= corr[0];
        o[dt][1] *= corr[0];
        o[dt][2] *= corr[1];
        o[dt][3] *= corr[1];
      }
    }

    // O += P V: P rounded to bf16 in registers, two score tiles per A operand
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];  // keys j*16 .. +15, dims dp*16 .. +7 and +8 .. +15
        ldmatrix_x4_trans(vf, sVs + j * 16 * D + v_row + (((2 * dp) ^ x_qv) << 3));
        mma_bf16_16816(o[2 * dp], a, vf[0], vf[1]);
        mma_bf16_16816(o[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
    if constexpr (QUANT) {
      // tile kt + 1's codes -> the other bf16 buffer, while tile kt's mma
      // work may still be in flight
      if (kt + 1 < n_kt) dequant((kt + 1) % CS, (kt + 1) & 1);
      stage = stage == CS - 1 ? 0 : stage + 1;
    } else {
      stage = stage == MMA_STAGES - 1 ? 0 : stage + 1;
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = warp * 16 + (lane >> 2) + 8 * h;
    if (row >= q_valid) continue;
    const float den = fmaxf(lt, 1e-30f);
    bf16* orow = out + ((int64_t)(b * Lq + q0 + row) * Hq + hq) * D + (lane & 3) * 2;
#pragma unroll
    for (int dt = 0; dt < NO; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
          __floats2bfloat162_rn(o[dt][2 * h] / den, o[dt][2 * h + 1] / den);
  }
}

// The kernel's attributes, set once a device: its dynamic shared memory, and
// all of the SM's 228 KB to shared memory, so two CTAs fit at D = 128 (112 KB
// each with bf16 K/V, 97.5 KB with int8).
template <typename KV, int D>
cudaError_t flash_mma_attributes() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = allow_smem(flash_fwd_mma_kernel<KV, D>, MmaSmem<KV, D>::bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_fwd_mma_kernel<KV, D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return e;
}

template <typename KV, int D>
int launch_flash_mma(const void* q, int64_t q_sb, int64_t q_st, int64_t q_sh,
                     const Operand<KV>& k, const Operand<KV>& v, void* out, int B,
                     int Lq, int Hq, int Hkv, int kv_len, int start, float scale,
                     cudaStream_t stream) {
  const cudaError_t e = flash_mma_attributes<KV, D>();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + BQ - 1) / BQ, Hq, B);
  flash_fwd_mma_kernel<KV, D><<<grid, MMA_NT, MmaSmem<KV, D>::bytes, stream>>>(
      static_cast<const bf16*>(q), q_sb, q_st, q_sh, k, v, static_cast<bf16*>(out), Lq,
      Hq, Hkv, kv_len, start, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename KV>
int dispatch_mma(int D, const void* q, int64_t q_sb, int64_t q_st, int64_t q_sh,
                 const Operand<KV>& k, const Operand<KV>& v, void* out, int B, int Lq,
                 int Hq, int Hkv, int kv_len, int start, float scale, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch_flash_mma<KV, 64>(q, q_sb, q_st, q_sh, k, v, out, B, Lq, Hq, Hkv,
                                      kv_len, start, scale, s);
    case 128:
      return launch_flash_mma<KV, 128>(q, q_sb, q_st, q_sh, k, v, out, B, Lq, Hq, Hkv,
                                       kv_len, start, scale, s);
    case 256:
      return launch_flash_mma<KV, 256>(q, q_sb, q_st, q_sh, k, v, out, B, Lq, Hq, Hkv,
                                       kv_len, start, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// -- dispatch by type ---------------------------------------------------------

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

// K and V in q's dtype (K2, K3): bf16 to the tensor-core body, f32 to the
// FMA body
int dispatch(int dtype, int D, const void* q, int64_t q_sb, int64_t q_st,
             int64_t q_sh, const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
             const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh, void* out,
             int B, int Lq, int Hq, int Hkv, int kv_len, int start, float scale,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) {  // the tensor-core body
    const Operand<bf16> ko{static_cast<const bf16*>(k), k_sb, k_ss, k_sh, nullptr, 0, 0};
    const Operand<bf16> vo{static_cast<const bf16*>(v), v_sb, v_ss, v_sh, nullptr, 0, 0};
    return dispatch_mma<bf16>(D, q, q_sb, q_st, q_sh, ko, vo, out, B, Lq, Hq, Hkv, kv_len,
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
  if (dtype == DTYPE_BF16)  // the tensor-core body
    return dispatch_mma<int8_t>(D, q, q_sb, q_st, q_sh, ko, vo, out, B, C, Hq, Hkv, KW,
                                start, scale, s);
  if (dtype == DTYPE_F32)
    return dispatch_d<float, int8_t>(D, q, q_sb, q_st, q_sh, ko, vo, out, B, C, Hq, Hkv,
                                     KW, start, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
