// Causal flash attention for prefill on Hopper (sm_90a): three entry
// points over three kernel bodies.
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
// products belong on the tensor cores, and on Hopper that means wgmma.
//
// Which body serves which, by body_of(q dtype, D), with no fallback
// between them (a failed build or launch raises in the wrapper):
//  * bf16 q at D = 128 (every main-path model), K2, K3 and K4 alike:
//    flash_fwd_wgmma_kernel<QUANT>, the Hopper body below;
//  * bf16 q at D = 64 and 256 (no main-path model): flash_fwd_mma_kernel<KV,
//    D>, mma.sync m16n8k16 tiles fed by a cp.async ring;
//  * f32 q: flash_fwd_kernel<T, KV, D>, f32 FMAs (TF32 mma would miss the
//    f32 tests' 1e-4).
//
// The Hopper body (FlashAttention-3's shape, with the departures below):
//  * Work tiles of 128 query rows of one q head of one batch row, the tiles
//    with the most keys first; K/V tiles of 128 keys. A CTA is two consumer
//    warpgroups (64 rows each) and a producer: one warp for bf16 K/V, a
//    warpgroup for int8. bf16 runs a persistent grid of one CTA an SM that
//    walks the work tiles in rounds of one tile a CTA, forward in even
//    rounds and backward in odd ones (tile_of), so every CTA's tiles add up
//    to about the same work; the producer loads the next tile's Q into the
//    second Q buffer and keeps the K/V ring full across the boundary, so a
//    tile's first loads and its epilogue hide behind its neighbour's
//    products. Against one CTA a tile, as the hardware schedules them, K2
//    at [4, 256] takes 0.0159 ms and not 0.0176, and at T = 4096 0.2415
//    and not 0.2562; plain rounds (CTA j takes j, j + grid, ...) leave it at
//    0.268 there (scripts/flash_variants_ms.py; PERF.md). int8 has room for
//    one Q buffer only and runs one CTA a tile.
//  * Loads by TMA (cp.async.bulk.tensor, mbarrier complete_tx): one thread
//    issues Q once a tile and each K and V tile into a ring of full/empty
//    mbarrier pairs. The tensor maps are encoded on the host each call
//    (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so no -lcuda)
//    over the operands' real strides: K2's [B, T, H, D], K3/K4's strided
//    slab views of the row cache read in place. bf16 boxes are 64 columns
//    (128 bytes) with the 128-byte swizzle that wgmma's descriptors read;
//    the sequence extent is T or KW, so TMA zero-fills past the ragged edge
//    (the mask still drops those keys).
//  * S = Q K^T by wgmma.m64n128k16 with Q and K from shared memory
//    (K-major); O += P V with P from registers (the f32 score accumulator
//    packed to bf16 pairs is wgmma's A fragment as it stands) and V from
//    shared memory MN-major, so nothing is transposed. The online softmax
//    runs on the accumulator fragments; the scale (base 2) folds into the
//    exponent's FFMA.
//  * The consumers take turns at the tensor cores (named barriers): a turn
//    issues P V of tile n - 1 and then S of tile n, and hands over, so one
//    consumer's softmax runs beside the other's products (the no_turns
//    variant of scripts/flash_variants_ms.py measures what that buys).
//    Within a consumer, P V finishes before S is issued: at 168 registers a
//    thread (384 threads), or 224 (288), ptxas cannot hold S, P and O of
//    two products in flight and serializes every wgmma of the kernel (its
//    warning C7512). setmaxnreg raises no budget that ptxas allocates
//    against (it keeps the launch bound's cap), so the body does not use
//    it.
//  * int8 (K4): TMA brings each tile's K and V codes (unswizzled 128-byte
//    rows); the scales arrive by 4-byte cp.async (a scales view of a row
//    cache need not be 16-byte aligned); the producer warpgroup
//    dequantizes them, with dequant8_bf16's rounding, into the swizzled
//    bf16 ring and arrives on the stage's full barrier: the consumers see
//    bf16 tiles only.
//  * Epilogue: normalise, round to bf16, stage each consumer's rows in its
//    own Q rows (swizzled, free of bank conflicts), 16-byte stores clipped
//    at the ragged T or C edge.
//  * Shared memory at D = 128 (of the 227 KB a CTA may use): bf16 Q 2 x 32
//    KB + K and V 2 stages x 2 x 32 KB = 192 KB (a third stage bought 0.5%);
//    int8 Q 32 KB + bf16 ring 128 KB + code ring 2 x 32 KB + scales 2 x 1
//    KB = 226 KB. Either way one CTA an SM.
//  * What sets the pace (PERF.md, by scripts/flash_variants_ms.py's
//    no_softmax, half_s and no_turns variants): at K2 T = 4096 each
//    consumer's serial chain a tile, its products and then its softmax,
//    which the other consumer's turn only partly covers; neither a third
//    ring stage nor sharing each K/V tile between two q heads of a kv head
//    moved it. The short rows ([4, 256], T = 512: one or two waves of CTAs
//    with one to four key tiles) are paced by each CTA's first loads and
//    that chain. int8 adds the producer's dequantization (~32 ALU
//    instructions per 8 codes), off the consumers' path.
//
// Numerics follow the JAX kernels: dots accumulated in f32 and scaled
// after, -1e30 mask, row sums of the unrounded probabilities, probabilities
// rounded to V's dtype before the PV product, output acc / max(l, 1e-30).
// The tensor-core bodies take ex2.approx of (s - max) in base 2, which is
// exp(s - max) to ~2^-22 relative, far below the bf16 rounding of p that
// follows.
//
// The mma.sync body (bf16 at D = 64 and 256): one CTA of 4 warps per
// (64-row query tile, q-head, batch row); each warp owns 16 query rows. Q
// (once) and each 64-key K and V tile arrive by 16-byte cp.async copies into
// a three-stage ring, with an XOR swizzle of 16-byte chunks, so ldmatrix and
// the copies are free of bank conflicts. QK^T and PV are mma.sync m16n8k16
// bf16 products with f32 accumulators, fed by ldmatrix (V by
// ldmatrix.trans); Q's fragments stay in registers at D = 64 and are
// reloaded from shared memory per k-step at D = 256. For int8
// the ring holds codes and their f32 row scales (4-byte copies), and the
// warps dequantize tile kt + 1 into a second pair of bf16 tiles while tile
// kt's products run, bit for bit as above.
//
// The FMA body (f32 q): padded shared-memory tiles; each thread computes a
// 4 x 4 block of scores and a 4 x D/16 block of the output, the score tile
// goes through shared memory, and an int8 tile is dequantized as it is
// copied. All three bodies are FA2-style: the f32 running max / sum /
// accumulator of the online softmax never leave the CTA, so the [Tq, Tk]
// score matrix never reaches device memory, and causally dead key tiles are
// never loaded (the loop stops at the tile holding the last real query's
// position).

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
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
    case 256:
      return launch_flash_mma<KV, 256>(q, q_sb, q_st, q_sh, k, v, out, B, Lq, Hq, Hkv,
                                       kv_len, start, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// -- Hopper body: bf16 q at D = 128, bf16 or int8 K/V ------------------------

constexpr int WG_BQ = 128;         // query rows a work tile: two consumers of 64
constexpr int WG_BK = 128;         // keys a K/V tile
constexpr int WG_D = 128;          // head dim (bytes of an int8 code row)
constexpr int WG_CODE_STAGES = 2;  // int8 code ring
// named barriers (0 is __syncthreads): the consumers' turns at the tensor
// cores (1, 2), each consumer's epilogue (3, 4), the producer warpgroup (5)
constexpr int BAR_TURN = 1;
constexpr int BAR_EPI = 3;
constexpr int BAR_PRODUCER = 5;

// Shared memory of the Hopper body, byte offsets. Every tile is a stack of
// 128-byte swizzled rows (gmma_desc_sw128): Q as two 64-column halves of
// WG_BQ rows, each bf16 K or V tile as two 64-column halves of WG_BK rows.
// int8: the code ring (K codes, then V codes, WG_BK rows of 128 bytes each,
// unswizzled) and the scale ring (K, then V, WG_BK f32 each).
template <bool QUANT>
struct WgSmem {
  // two consumer warpgroups, then the producer: one warp for bf16 (TMA
  // only), a warpgroup for int8 (it dequantizes)
  static constexpr int THREADS = 256 + (QUANT ? 128 : 32);
  // Q buffers: bf16 loads the next work tile's Q during this one's key
  // loop; int8 has no room for a second
  static constexpr int QBUF = QUANT ? 1 : 2;
  static constexpr int STAGES = 2;  // K/V ring of bf16 tiles
  static constexpr int HALF_Q = WG_BQ * 128;
  static constexpr int HALF_T = WG_BK * 128;
  static constexpr int TILE = 2 * HALF_T;  // one bf16 K or V tile
  static constexpr int CODE_TILE = WG_BK * WG_D;
  static constexpr int Q = 0;
  static constexpr int K = Q + QBUF * 2 * HALF_Q;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int CODES = V + STAGES * TILE;
  static constexpr int SCALES = CODES + (QUANT ? WG_CODE_STAGES * 2 * CODE_TILE : 0);
  static constexpr int BARS = SCALES + (QUANT ? WG_CODE_STAGES * 2 * WG_BK * 4 : 0);
  static constexpr int N_BARS = 2 * QBUF + 4 * STAGES + (QUANT ? WG_CODE_STAGES : 0);
  static constexpr int bytes = BARS + N_BARS * 8;
  static_assert(bytes <= 232448, "over the 227 KB a CTA may use");
};

// Dequantize one landed code tile (WG_BK rows of 128 int8 codes) and its
// row scales into a swizzled bf16 tile, by the producer warpgroup's 128
// threads: thread t converts 8-code chunk t % 16 of rows t / 16 + 8i, so a
// warp reads 256 contiguous code bytes and each quarter warp writes 8
// distinct 16-byte chunks of one row (no bank conflict).
__device__ __forceinline__ void wg_dequant_tile(unsigned char* dst, const unsigned char* codes,
                                                const float* sc) {
  const int tid = threadIdx.x & 127;
  const int cc = tid & 15;  // chunk of the row: columns 8cc .. 8cc + 7
  const int rr = tid >> 4;  // the row within each group of 8 rows
  unsigned char* d = dst + (cc >> 3) * WgSmem<true>::HALF_T + (((cc & 7) ^ rr) << 4);
  const unsigned char* c = codes + cc * 8;
#pragma unroll 8
  for (int it = 0; it < WG_BK / 8; ++it) {
    const int r = it * 8 + rr;
    const uint2 w = *reinterpret_cast<const uint2*>(c + r * WG_D);
    *reinterpret_cast<uint4*>(d + r * 128) = dequant8_bf16(w, sc[r]);
  }
}

template <bool QUANT>
__global__ void __launch_bounds__(WgSmem<QUANT>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const float* __restrict__ ks, int64_t ks_sb, int64_t ks_sh,
                       const float* __restrict__ vs, int64_t vs_sb, int64_t vs_sh,
                       bf16* __restrict__ out,  // [B, Lq, Hq, 128] contiguous
                       int B, int Lq, int Hq, int Hkv, int kv_len, int start, float scale_log2,
                       int n_qt, int n_tiles) {
  using S = WgSmem<QUANT>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* q_empty = q_full + S::QBUF;
  uint64_t* k_full = q_empty + S::QBUF;
  uint64_t* k_empty = k_full + S::STAGES;
  uint64_t* v_full = k_empty + S::STAGES;
  uint64_t* v_empty = v_full + S::STAGES;
  uint64_t* code_full = v_empty + S::STAGES;  // int8 only

  // Work tile t of the launch:
  // a 128-row query tile of one q head of one batch row, the query tiles
  // with the most keys first
  struct Tile {
    int q0, hq, b, hk, q_valid, n_kt;
  };
  auto tile_at = [&](int t) {
    Tile x;
    const int bh = t % (B * Hq);
    x.q0 = (n_qt - 1 - t / (B * Hq)) * WG_BQ;
    x.b = bh / Hq;
    x.hq = bh - x.b * Hq;
    x.hk = x.hq / (Hq / Hkv);
    x.q_valid = min(WG_BQ, Lq - x.q0);
    // keys past the tile's last real query position are causally dead
    const int n_keys = min(kv_len, start + x.q0 + x.q_valid);
    x.n_kt = (n_keys + WG_BK - 1) / WG_BK;
    return x;
  };
  // The CTA's i-th work tile: rounds of gridDim.x tiles, walked forward in
  // even rounds and backward in odd ones, so that with the tiles heaviest
  // first every CTA's tiles add up to about the same work
  auto tile_of = [&](int i) {
    return i * (int)gridDim.x + ((i & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  // 0 and 1: the consumers, 2: the producer (read through a shuffle, so
  // the compiler sees it uniform across the warp)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::QBUF; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 8);  // every consumer warp, after its epilogue
    }
    for (int s = 0; s < S::STAGES; ++s) {
      // bf16: one arrival with the TMA bytes; int8: every producer warp
      // arrives once its threads have written their share of the tile
      mbar_init(k_full + s, QUANT ? 4 : 1);
      mbar_init(v_full + s, QUANT ? 4 : 1);
      mbar_init(k_empty + s, 8);  // every consumer warp
      mbar_init(v_empty + s, 8);
    }
    if (QUANT)
      for (int s = 0; s < WG_CODE_STAGES; ++s) mbar_init(code_full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: TMA for Q and each K/V tile (int8: codes by TMA,
    // scales by 4-byte cp.async, and the dequantization into the bf16 ring).
    // ``it`` counts the K/V tiles of this CTA: ring stage it % STAGES.
    if (tid == 0) {
      tma_prefetch_desc(&tm_q);
      tma_prefetch_desc(&tm_k);
      tma_prefetch_desc(&tm_v);
    }
    // Q of the CTA's i-th work tile, once its buffer is free
    auto load_q = [&](const Tile& x, int i) {
      const int qb = i % S::QBUF;
      unsigned char* qd = smem + S::Q + qb * 2 * S::HALF_Q;
      mbar_wait(q_empty + qb, ((i / S::QBUF) & 1) ^ 1);
      mbar_arrive_expect_tx(q_full + qb, 2 * S::HALF_Q);
      tma_load_4d(qd, &tm_q, q_full + qb, 0, x.q0, x.hq, x.b);
      tma_load_4d(qd + S::HALF_Q, &tm_q, q_full + qb, 64, x.q0, x.hq, x.b);
    };
    int it = 0;
    for (int i = 0; i * (int)gridDim.x < n_tiles; ++i) {
      const int t = tile_of(i);
      if (t >= n_tiles) break;  // the last round is short
      const Tile x = tile_at(t);
      const int hk = x.hk, b = x.b, n_kt = x.n_kt;
      if constexpr (!QUANT) {
        if (tid == 0) {
          load_q(x, i);
          for (int n = 0; n < n_kt; ++n, ++it) {
            const int s = it % S::STAGES;
            const uint32_t free_parity = ((it / S::STAGES) & 1) ^ 1;
            unsigned char* kd = smem + S::K + s * S::TILE;
            unsigned char* vd = smem + S::V + s * S::TILE;
            mbar_wait(k_empty + s, free_parity);
            mbar_arrive_expect_tx(k_full + s, S::TILE);
            tma_load_4d(kd, &tm_k, k_full + s, 0, n * WG_BK, hk, b);
            tma_load_4d(kd + S::HALF_T, &tm_k, k_full + s, 64, n * WG_BK, hk, b);
            mbar_wait(v_empty + s, free_parity);
            mbar_arrive_expect_tx(v_full + s, S::TILE);
            tma_load_4d(vd, &tm_v, v_full + s, 0, n * WG_BK, hk, b);
            tma_load_4d(vd + S::HALF_T, &tm_v, v_full + s, 64, n * WG_BK, hk, b);
          }
        }
      } else {
        if (tid == 0) load_q(x, i);
        float* scales = reinterpret_cast<float*>(smem + S::SCALES);
        // key tile n's codes (thread 0) and its K and V scales (thread t:
        // key row t) into code stage cs
        auto load_tile = [&](int n, int cs) {
          if (tid == 0) {
            unsigned char* cd = smem + S::CODES + cs * 2 * S::CODE_TILE;
            mbar_arrive_expect_tx(code_full + cs, 2 * S::CODE_TILE);
            tma_load_4d(cd, &tm_k, code_full + cs, 0, n * WG_BK, hk, b);
            tma_load_4d(cd + S::CODE_TILE, &tm_v, code_full + cs, 0, n * WG_BK, hk, b);
          }
          const int key = n * WG_BK + tid;
          const bool ok = key < kv_len;
          const int64_t r = ok ? key : 0;
          float* sc = scales + cs * 2 * WG_BK;
          cp_async4(sc + tid, ks + b * ks_sb + hk * ks_sh + r, ok);
          cp_async4(sc + WG_BK + tid, vs + b * vs_sb + hk * vs_sh + r, ok);
        };
        // one cp.async group a key tile, empty past the last: the scales
        // of key tile n are the (CS - 1)-th newest group at its turn
#pragma unroll
        for (int j = 0; j < WG_CODE_STAGES; ++j) {
          if (j < n_kt) load_tile(j, (it + j) % WG_CODE_STAGES);
          cp_async_commit();
        }
        for (int n = 0; n < n_kt; ++n, ++it) {
          const int cs = it % WG_CODE_STAGES;
          const int s = it % S::STAGES;
          const uint32_t free_parity = ((it / S::STAGES) & 1) ^ 1;
          cp_async_wait<WG_CODE_STAGES - 1>();  // this thread's scales of key tile n
          named_bar_sync(BAR_PRODUCER, 128);    // ... and every thread's
          mbar_wait(code_full + cs, (it / WG_CODE_STAGES) & 1);
          const unsigned char* cd = smem + S::CODES + cs * 2 * S::CODE_TILE;
          const float* sc = scales + cs * 2 * WG_BK;
          mbar_wait(k_empty + s, free_parity);
          wg_dequant_tile(smem + S::K + s * S::TILE, cd, sc);
          fence_proxy_async();  // the bf16 tile, to the tensor cores
          __syncwarp();
          if ((tid & 31) == 0) mbar_arrive(k_full + s);
          mbar_wait(v_empty + s, free_parity);
          wg_dequant_tile(smem + S::V + s * S::TILE, cd + S::CODE_TILE, sc + WG_BK);
          fence_proxy_async();
          __syncwarp();
          if ((tid & 31) == 0) mbar_arrive(v_full + s);
          named_bar_sync(BAR_PRODUCER, 128);  // every thread is done with code stage cs
          if (n + WG_CODE_STAGES < n_kt) load_tile(n + WG_CODE_STAGES, cs);
          cp_async_commit();
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    const int c = wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    float s[64];   // scores, then probabilities, of one key tile
    float o[64];   // the output accumulator
    uint32_t p[32];  // probabilities in bf16, the A fragment of P V
    float m[2], l[2], corr[2];
    // a warp is done with a ring stage or a Q buffer
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    int it = 0;  // K/V tiles of this CTA so far: ring stage it % STAGES
    for (int i = 0; i * (int)gridDim.x < n_tiles; ++i) {
      const int t = tile_of(i);
      if (t >= n_tiles) break;  // the last round is short
      const Tile x = tile_at(t);
      const int q0 = x.q0, hq = x.hq, b = x.b, q_valid = x.q_valid, n_kt = x.n_kt;
      const int qb = i % S::QBUF;
      // this warpgroup's rows of the Q buffer
      unsigned char* sQ = smem + S::Q + qb * 2 * S::HALF_Q + c * 64 * 128;
      // q position of this lane's row g (accumulator elements 4j, 4j + 1);
      // row g + 8 holds 4j + 2, 4j + 3
      const int qp0 = start + q0 + 64 * c + warp * 16 + (lane >> 2);
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] = 0.f;
      m[0] = m[1] = NEG_INF_F;  // running max of rows g and g + 8 (base 2)
      l[0] = l[1] = 0.f;        // this lane's share of their running sums

      // Descriptors of Q and of ring stage 0's K and V; a k-step, another
      // stage or the other 64-column half adds its byte offset / 16 to the
      // address field
      const uint64_t desc_q = gmma_desc_sw128(sQ, 16, 1024);
      const uint64_t desc_k = gmma_desc_sw128(smem + S::K, 16, 1024);
      const uint64_t desc_v = gmma_desc_sw128(smem + S::V, S::HALF_T, 1024);
      // S = Q K^T over key tile in ring stage st
      auto issue_s = [&](int st) {
        const uint64_t dk = desc_k + (uint64_t)(st * S::TILE >> 4);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_D / 16; ++kk) {
          const int off = (kk & 3) * 32;  // 16 columns of a 64-column half
          wgmma_m64n128k16_ss(s, desc_q + (uint64_t)(((kk >> 2) * S::HALF_Q + off) >> 4),
                              dk + (uint64_t)(((kk >> 2) * S::HALF_T + off) >> 4), kk > 0);
        }
        wgmma_commit();
      };
      // O += P V over the V tile in ring stage st (V MN-major: the two
      // 64-column halves are lbo apart, 8-key row groups 1024 bytes)
      auto issue_pv = [&](int st) {
        const uint64_t dv = desc_v + (uint64_t)(st * S::TILE >> 4);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
          wgmma_m64n128k16_rs(o, a, dv + (uint64_t)(kk * 16 * 128 >> 4), 1);
        }
        wgmma_commit();
      };
      // mask and the online softmax of key tile n on the score fragments:
      // only tiles that straddle this warpgroup's diagonal or the kv_len
      // edge need the mask, and the scale (base 2) folds into the exponent's
      // FFMA: p = 2^(s * scale_log2 - m), m the running max of s * scale_log2
      auto softmax = [&](int n) {
        const int k0 = n * WG_BK;
        if (k0 + WG_BK - 1 > start + q0 + 64 * c || k0 + WG_BK > kv_len) {
          // the last key rows g and g + 8 may see, less this lane's column
          const int lim0 = min(qp0, kv_len - 1) - k0 - (lane & 3) * 2;
          const int lim1 = min(qp0 + 8, kv_len - 1) - k0 - (lane & 3) * 2;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[4 * j + e] = j * 8 + (e & 1) > ((e & 2) ? lim1 : lim0) ? NEG_INF_F : s[4 * j + e];
        }
        // row max and sum in four partial chains each, for ILP: a warp is
        // alone on its scheduler while the other consumer waits on its
        // products
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mp[4] = {NEG_INF_F, NEG_INF_F, NEG_INF_F, NEG_INF_F};
#pragma unroll
          for (int j = 0; j < 16; ++j)
            mp[j & 3] = fmaxf(mp[j & 3], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
          float mx = fmaxf(fmaxf(mp[0], mp[1]), fmaxf(mp[2], mp[3]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(m[h], mx * scale_log2);
          corr[h] = fast_exp2(m[h] - mx);
          m[h] = mx;
          float ps[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float p0 = fast_exp2(fmaf(s[4 * j + 2 * h], scale_log2, -mx));
            const float p1 = fast_exp2(fmaf(s[4 * j + 2 * h + 1], scale_log2, -mx));
            s[4 * j + 2 * h] = p0;
            s[4 * j + 2 * h + 1] = p1;
            ps[j & 3] += p0 + p1;
          }
          l[h] = l[h] * corr[h] + ((ps[0] + ps[1]) + (ps[2] + ps[3]));
        }
      };
      auto pack_p = [&]() {
#pragma unroll
        for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      };
      // rescale the output only when some row's max moved (x 1 is exact)
      auto rescale_o = [&]() {
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            o[4 * j] *= corr[0];
            o[4 * j + 1] *= corr[0];
            o[4 * j + 2] *= corr[1];
            o[4 * j + 3] *= corr[1];
          }
        }
      };

      // The two consumers take turns at the tensor cores (named barriers
      // BAR_TURN + c): a turn issues this consumer's products of a tile and
      // hands the tensor cores to the other consumer, whose products then run
      // while this one runs its softmax. Consumer 1 opens consumer 0's first
      // turn and skips its own last hand-over, so every barrier phase is
      // whole. Tile 0's turn issues S alone.
      if (c == 1) named_bar_arrive(BAR_TURN, 256);
      mbar_wait(q_full + qb, (i / S::QBUF) & 1);
      mbar_wait(k_full + it % S::STAGES, (it / S::STAGES) & 1);
      named_bar_sync(BAR_TURN + c, 256);
      issue_s(it % S::STAGES);
      if (c == 0 || n_kt > 1) named_bar_arrive(BAR_TURN + 1 - c, 256);
      wgmma_wait<0>();
      fence_regs(s);
      release(k_empty + it % S::STAGES);
      softmax(0);
      pack_p();
      for (int n = 1; n < n_kt; ++n) {
        const int st = (it + n) % S::STAGES;
        const int sp = (it + n - 1) % S::STAGES;
        mbar_wait(k_full + st, ((it + n) / S::STAGES) & 1);
        mbar_wait(v_full + sp, ((it + n - 1) / S::STAGES) & 1);
        named_bar_sync(BAR_TURN + c, 256);
        // P V of tile n - 1 finishes before S of tile n is issued: with both
        // in flight the compiler runs out of registers and serializes every
        // product (the source note)
        issue_pv(sp);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        release(v_empty + sp);
        issue_s(st);
        if (c == 0 || n < n_kt - 1) named_bar_arrive(BAR_TURN + 1 - c, 256);
        wgmma_wait<0>();
        fence_regs(s);
        release(k_empty + st);
        softmax(n);
        rescale_o();
        pack_p();
      }
      {
        const int sp = (it + n_kt - 1) % S::STAGES;
        mbar_wait(v_full + sp, ((it + n_kt - 1) / S::STAGES) & 1);
        issue_pv(sp);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        release(v_empty + sp);
      }
      // epilogue: normalise, round to bf16 and stage the rows in this
      // warpgroup's Q rows (swizzled as Q, so the writes are free of bank
      // conflicts), then 16-byte stores, one 256-byte row per 16 threads
      named_bar_sync(BAR_EPI + c, 128);  // every warp's last S product has read Q
      unsigned char* so = sQ;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lt = l[h];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float den = fmaxf(lt, 1e-30f);
        const int r = warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(so + (j >> 3) * S::HALF_Q + r * 128 +
                                       (((j & 7) ^ (r & 7)) << 4) + (lane & 3) * 4) =
              pack_bf16(o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den);
      }
      named_bar_sync(BAR_EPI + c, 128);
#pragma unroll
      for (int it = 0; it < 64 * 16 / 128; ++it) {
        const int i = it * 128 + tid;
        const int r = i >> 4;
        const int cc = i & 15;
        if (64 * c + r >= q_valid) continue;
        const uint4 val = *reinterpret_cast<const uint4*>(so + (cc >> 3) * S::HALF_Q + r * 128 +
                                                          (((cc & 7) ^ (r & 7)) << 4));
        *reinterpret_cast<uint4*>(out + ((int64_t)(b * Lq + q0 + 64 * c + r) * Hq + hq) * WG_D +
                                  cc * 8) = val;
      }
      // this warp has read its staged rows; the generic proxy's accesses
      // to them come before the TMA that refills the buffer
      fence_proxy_async();
      release(q_empty + qb);
      it += n_kt;
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, found through the runtime (no
// -lcuda at link time)
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// The map of a [B, rows, H, 128] view given by element strides (a strided
// view of a row cache is fine): dims {128, rows, H, B} innermost first,
// boxes of box_cols x box_rows of one head of one batch row. bf16 boxes are
// 64 columns (128 bytes, 128-byte swizzle); int8 boxes whole 128-byte rows,
// unswizzled. Rows past ``rows`` arrive as zeros.
bool encode_view(CUtensorMap* map, bool int8, const void* p, int rows, int H, int B,
                 int64_t s_row, int64_t s_h, int64_t s_b, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const int64_t es = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)WG_D, (cuuint64_t)rows, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(s_row * es), (cuuint64_t)(s_h * es),
                                 (cuuint64_t)(s_b * es)};
  const cuuint32_t box[4] = {int8 ? 128u : 64u, (cuuint32_t)box_rows, 1u, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return fn(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(p), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The SMs of the current device (read once a device)
cudaError_t sm_count(int* n) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> count[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*n = count[dev].load(std::memory_order_acquire)) > 0)
    return cudaSuccess;
  e = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kMaxDevices) count[dev].store(*n, std::memory_order_release);
  return e;
}

template <bool QUANT>
cudaError_t flash_wgmma_attributes() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = allow_smem(flash_fwd_wgmma_kernel<QUANT>, WgSmem<QUANT>::bytes);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return e;
}

template <typename KV>
int launch_flash_wgmma(const void* q, int64_t q_sb, int64_t q_st, int64_t q_sh,
                       const Operand<KV>& k, const Operand<KV>& v, void* out, int B, int Lq,
                       int Hq, int Hkv, int kv_len, int start, float scale,
                       cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  CUtensorMap tq, tk, tv;
  if (!encode_view(&tq, false, q, Lq, Hq, B, q_st, q_sh, q_sb, WG_BQ) ||
      !encode_view(&tk, QUANT, k.p, kv_len, Hkv, B, k.ss, k.sh, k.sb, WG_BK) ||
      !encode_view(&tv, QUANT, v.p, kv_len, Hkv, B, v.ss, v.sh, v.sb, WG_BK))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = flash_wgmma_attributes<QUANT>();
  if (e != cudaSuccess) return (int)e;
  // bf16: a persistent grid, one CTA an SM walking the work tiles; int8
  // (one Q buffer, so no prefetch across tiles): one CTA a tile
  const int n_qt = (Lq + WG_BQ - 1) / WG_BQ;
  const int n_tiles = n_qt * Hq * B;
  int grid = n_tiles;
  if (!QUANT) {
    int sms = 0;
    const cudaError_t es = sm_count(&sms);
    if (es != cudaSuccess) return (int)es;
    grid = min(n_tiles, sms);
  }
  flash_fwd_wgmma_kernel<QUANT><<<grid, WgSmem<QUANT>::THREADS, WgSmem<QUANT>::bytes, stream>>>(
      tq, tk, tv, k.s, k.s_sb, k.s_sh, v.s, v.s_sb, v.s_sh, static_cast<bf16*>(out), B, Lq,
      Hq, Hkv, kv_len, start, scale * LOG2E, n_qt, n_tiles);
  return (int)cudaGetLastError();
}

// -- dispatch by entry point and type ------------------------------------------

// The body that serves a (q dtype, head dim), for K2, K3 and K4 alike; the
// wrappers read it (flash_body) to count their launches by body.
enum Body { BODY_FMA = 0, BODY_MMA = 1, BODY_WGMMA = 2 };

int body_of(int dtype, int D) {
  if (dtype == DTYPE_F32) return BODY_FMA;
  if (dtype != DTYPE_BF16) return -1;
  return D == 128 ? BODY_WGMMA : BODY_MMA;
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

// K and V in q's dtype (K2, K3) by body_of: bf16 to the Hopper or the
// mma.sync body, f32 to the FMA body
int dispatch(int dtype, int D, const void* q, int64_t q_sb, int64_t q_st,
             int64_t q_sh, const void* k, int64_t k_sb, int64_t k_ss, int64_t k_sh,
             const void* v, int64_t v_sb, int64_t v_ss, int64_t v_sh, void* out,
             int B, int Lq, int Hq, int Hkv, int kv_len, int start, float scale,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int body = body_of(dtype, D);
  if (body == BODY_WGMMA || body == BODY_MMA) {
    const Operand<bf16> ko{static_cast<const bf16*>(k), k_sb, k_ss, k_sh, nullptr, 0, 0};
    const Operand<bf16> vo{static_cast<const bf16*>(v), v_sb, v_ss, v_sh, nullptr, 0, 0};
    if (body == BODY_WGMMA)
      return launch_flash_wgmma<bf16>(q, q_sb, q_st, q_sh, ko, vo, out, B, Lq, Hq, Hkv,
                                      kv_len, start, scale, s);
    return dispatch_mma<bf16>(D, q, q_sb, q_st, q_sh, ko, vo, out, B, Lq, Hq, Hkv, kv_len,
                              start, scale, s);
  }
  if (body == BODY_FMA) {
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
  return dispatch(dtype, D, q, q_sb, q_st, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, v_sh,
                  out, B, T, Hq, Hkv, T, 0, scale, stream);
}

// K3: chunk continuation. q [B, C, Hq, D] at positions [start, start + C);
// k/v the cache slab [B, Hkv, KW, D] given by strides; out [B, C, Hq, D].
int flash_attention_chunk(int dtype, int D, const void* q, int64_t q_sb,
                          int64_t q_st, int64_t q_sh, const void* k, int64_t k_sb,
                          int64_t k_sh, int64_t k_ss, const void* v, int64_t v_sb,
                          int64_t v_sh, int64_t v_ss, void* out, int B, int C,
                          int Hq, int Hkv, int KW, int start, float scale,
                          void* stream) {
  return dispatch(dtype, D, q, q_sb, q_st, q_sh, k, k_sb, k_ss, k_sh, v, v_sb, v_ss, v_sh,
                  out, B, C, Hq, Hkv, KW, start, scale, stream);
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
  switch (body_of(dtype, D)) {
    case BODY_WGMMA:
      return launch_flash_wgmma<int8_t>(q, q_sb, q_st, q_sh, ko, vo, out, B, C, Hq, Hkv, KW,
                                        start, scale, s);
    case BODY_MMA:
      return dispatch_mma<int8_t>(D, q, q_sb, q_st, q_sh, ko, vo, out, B, C, Hq, Hkv, KW,
                                  start, scale, s);
    case BODY_FMA:
      return dispatch_d<float, int8_t>(D, q, q_sb, q_st, q_sh, ko, vo, out, B, C, Hq, Hkv,
                                       KW, start, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The body K2, K3 and K4 run for q in ``dtype`` at head dim D: 0 the FMA
// body, 1 the mma.sync body, 2 the Hopper body; -1 for a dtype they refuse.
int flash_body(int dtype, int D) { return body_of(dtype, D); }

}  // extern "C"
