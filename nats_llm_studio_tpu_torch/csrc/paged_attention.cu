// Paged-attention decode for Hopper (sm_90a).
//
// Replaces the TPU kernel nats_llm_studio_tpu/ops/paged_attention.py:
// paged_decode_attention (body _paged_kernel), both branches of its
// pallas_call: attention of W new tokens per slot over the slot's whole
// paged history, read block by block through the block table, straight out
// of the pool [NB, L, Hkv, T, D]. K1 reads a pool in q's dtype; K1q reads
// int8 codes [NB, L, Hkv, T, D] with f32 scales [NB, L, Hkv, T] (the KVQ
// cache) and dequantizes each tile as it copies it into shared memory
// (code x scale in f32, rounded to q's dtype, as the JAX kernel's
// quantized branch does).
//
// What bounds it on the H100: bytes. Each decode step reads every live K/V
// row of every slot once (2 x context x Hkv x D x 2 bytes per slot per
// layer in bf16; D + 4 bytes per row in int8: the codes and one f32 scale,
// 0.52x the bf16 bytes at D = 128) and does ~2 flops per byte read in bf16
// (~4 in int8), far below the ~295 flops/byte where the tensor cores would
// become the limit.
//
// Which body serves which (q dtype, pool storage, D), chosen by type in
// paged_decode_plan() and paged_decode_attention(), with no fallback:
//  * (bf16, bf16, D in {64, 128, 256}), K1: paged_decode_mma_kernel<bf16, D,
//    MT> (plan body 1);
//  * (bf16, int8, D in {64, 128, 256}), K1q: paged_decode_mma_kernel<int8_t,
//    D, MT> (plan body 2);
//    MT, the m16 tiles a CTA holds, is 2 for a bundle of more than 16 rows
//    at D <= 128, else 1;
//  * every other pair, by an explicit rule (plan body 0): (f32, f32) and
//    bf16 at any other D <= 256 with D % 8 == 0 (K1), and (f32, int8) and
//    bf16 at any other D with D % 16 == 0 over int8 (K1q):
//    paged_decode_kernel<T, KV>.
//
// Shared by both bodies:
//  * one CTA per (slot, kv-head, split): each K/V tile is read from device
//    memory once and serves the whole GQA row bundle (group x W query
//    rows), so the grouped heads cost no extra bytes;
//  * the CTA reads its own block-table row and position and walks only its
//    share of the live blocks 0..(pos+W-1)//T, so a slot's cost follows its
//    context, not the table width (no scalar prefetch, no dead grid cells);
//  * split-K (flash-decoding): each split leaves its unnormalized
//    accumulator and (max, sum), and a second kernel merges them
//    (paged_combine_mma_kernel for the tensor-core body, paged_combine_kernel
//    for the FMA body);
//  * the layer is a runtime argument indexed inside the kernel: the pool is
//    never sliced or copied per layer.
//
// paged_decode_mma_kernel<KV, D, MT> (tensor cores, cp.async ring):
//  * 4 warps; the bundle's rows, padded to 16, are m16 A fragments of Q.
//    At D <= 128 one CTA holds up to two of them (mma_tiles_per_cta): a
//    bundle of 17 to 32 rows, as a speculative verify's 28 (W = 7, group
//    4), is one CTA, and each K and V fragment a warp loads by ldmatrix
//    feeds the products of both m-tiles, so a tile is read from device
//    memory, and under int8 dequantized, once whatever W is. Q stays in
//    registers when it is one fragment at D <= 128 or two at D = 64, and is
//    read from shared memory a k-step otherwise (two tiles' output
//    fragments take 128 registers a lane at D = 128). A bundle of more than
//    32 rows takes one CTA per pair of m-tiles; at D = 256 one CTA per
//    m-tile (two tiles' 256 output registers a lane would spill);
//  * 64-key tiles are gathered through the block table, key row by key row
//    (block tbl[key / T], row key % T: any T, and a tile may span blocks),
//    by cp.async into a three-stage ring: tiles t+1 and t+2 are in flight
//    while tile t is computed. The CTA first copies its split's slice of
//    the table row into shared memory. Only this load stage depends on KV:
//      - bf16: the ring holds the swizzled bf16 K and V tiles themselves,
//        16-byte copies by the whole CTA, one block barrier a tile;
//      - int8: the ring holds codes (16-byte copies) and their f32 scales
//        (4-byte copies, one a key row, through the same table slice) in one
//        commit group a tile; keys past the split's end get codes and scale
//        0. Since warp w reads only key rows 16w..16w+15 of K and of V, each
//        warp copies its own 16 rows (two lanes a row: one row index a lane)
//        and dequantizes them (code -> f32 by a byte permute and one add,
//        times the scale in f32, rounded to nearest even: the JAX kernel's
//        (codes.astype(f32) * scales[:, None]).astype(bf16), bit for bit)
//        into its rows of one bf16 K and one bf16 V tile, which the
//        ldmatrix reads below take as they are. The key loop then needs
//        only cp.async waits and warp barriers, no block barrier. 87.5 KB
//        a CTA at D = 128 (code ring 3 x 16.5 KB, bf16 tiles 32 KB, Q 4 KB)
//        keeps two CTAs an SM, as the bf16 ring (101 KB) does: decode is a
//        chain of latencies, so occupancy is worth more than overlap inside
//        a CTA. The int8 pool halves the bytes; the conversion adds ~3.5
//        instructions a K/V element;
//  * each warp takes 16 keys of every tile: S = Q K^T (16 x 16, D/16
//    k-steps of mma.sync m16n8k16 fed by ldmatrix), then scale, mask and
//    online softmax on the fragments, P rounded to bf16 in registers (the
//    JAX p.astype(v.dtype)) and O += P V with V by ldmatrix.trans. Each warp
//    keeps its own (m, l, O); at the end the 4 warps merge in shared memory.
//    The tensor cores are not the bound (128 mma.sync a 32 KB tile); they
//    bring the operands in by ldmatrix rather than one shared load per FMA;
//  * splits are sized by work: paged_decode_plan() gives each split a fixed
//    number of tiles, as many splits as the table's width needs. CTAs past
//    a slot's live tiles exit at once; a slot with one live split writes
//    its output directly, and the combine step reads only the splits that
//    held keys. A warp or split that saw no live key carries (m, l) =
//    (-1e30, 0) and weighs 0. The attributes are set once a device. The
//    merge gives each CTA 8 rows of the bundle (COMBINE_ROWS), so a
//    verify's 28 rows spread over four CTAs a (slot, kv head);
//  * why not TMA at D = 128: a body with a TMA/mbarrier K/V ring under
//    tensor maps cached per pool, dequant warps for int8, and a split
//    balanced on the card from ``pos`` (one wave of CTAs over chunks of
//    every live (slot, kv head)) was built and measured on the H100 against
//    this one (PERF.md section 6). It won only on a skewed batch at W = 7;
//    at the decode step's own shape (8 slots of 512 tokens) its fixed cost
//    a CTA (barrier set-up, ring fill, the chunked merge) made each call
//    slower (paged attention 0.425 -> 0.594 ms a bf16 step of 32 layers),
//    and the W = 7 loss it aimed at was the second m-tile's CTAs, which the
//    two-tile CTA above removes. Decode does 2-4 flops a byte, so the
//    tensor cores stay on mma.sync m16n8k16 (a wgmma tile's 64 rows would
//    be 56-94% padding for a 4- or 28-row bundle).
//
// paged_decode_kernel<T, KV> (f32 FMAs): a tile is 64 keys (several
// 16-token blocks), loaded with 16-byte vector loads issued four per thread
// before their shared-memory stores; scores and PV products are scalar f32
// FMAs from padded shared-memory tiles; the table's tiles are divided among
// about two CTAs an SM. Over int8 (f32 K1q) it dequantizes each tile as it
// stores it.
//
// Numerics follow the JAX kernel: f32 scores and online-softmax state,
// -1e30 mask, probabilities rounded to the pool dtype before the PV product,
// l clamped at 1e-30. Row r of the bundle is (query offset r / group,
// q-head r % group); its causal frontier is key_pos <= pos + r / group.
// Tables that point at the null block 0 give finite junk.

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NTH = 128;        // threads per CTA
constexpr int TILE_KEYS = 64;   // keys per iteration
constexpr int LOAD_UNROLL = 4;  // 16-byte loads in flight per thread
constexpr int SMEM_MAX = 232448;  // bytes of shared memory one H100 block can use

int tile_blocks_for(int Tb) { return Tb >= TILE_KEYS ? 1 : TILE_KEYS / Tb; }

size_t smem_bytes(int rows, int D, int KT, int itemsize) {
  size_t nf = (size_t)rows * (KT + 1) + (size_t)rows * D + 3 * (size_t)rows;
  nf = (nf + 3) & ~(size_t)3;
  return nf * 4 + (size_t)(rows + 2 * KT) * (D + 2) * itemsize;
}

template <typename T, typename KV>
__global__ void __launch_bounds__(NTH)
paged_decode_kernel(const T* __restrict__ q,         // [B, W, Hq, D]
                    const KV* __restrict__ k_pool,   // [NB, L, Hkv, Tb, D]
                    const KV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,  // [NB, L, Hkv, Tb] (int8 KV)
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tbl,     // [B, nbt]
                    const int* __restrict__ pos,   // [B]
                    T* __restrict__ out,           // [B, W, Hq, D]
                    float* __restrict__ part_acc,  // [B, Hkv, S, rows, D]
                    float* __restrict__ part_ml,   // [B, Hkv, S, rows, 2]
                    int W, int Hq, int Hkv, int D, int Tb, int L, int nbt,
                    int layer, int n_splits, int tile_blocks, float scale) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int EPC = 16 / (int)sizeof(KV);  // K/V elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int group = Hq / Hkv;
  const int rows = group * W;
  const int KT = tile_blocks * Tb;  // keys per tile
  const int ds = D + 2;             // padded shared row stride (elements)
  const int ss = KT + 1;            // padded score row stride (floats)

  float* sS = reinterpret_cast<float*>(smem);  // [rows, ss] scores, then p
  float* sAcc = sS + rows * ss;                // [rows, D]
  float* sM = sAcc + rows * D;                 // [rows] running max
  float* sL = sM + rows;                       // [rows] running sum
  float* sC = sL + rows;                       // [rows] correction
  int nf = rows * ss + rows * D + 3 * rows;
  nf = (nf + 3) & ~3;  // 16-byte align the tile region
  T* sQ = reinterpret_cast<T*>(reinterpret_cast<float*>(smem) + nf);
  T* sK = sQ + rows * ds;
  T* sV = sK + KT * ds;

  const int tid = threadIdx.x;
  const int p0 = pos[b];
  const int cpr = D * (int)sizeof(T) / 16;  // 16-byte chunks per row

  // the row bundle: row r reads q[b, r / group, h * group + r % group, :]
  for (int i = tid; i < rows * cpr; i += NTH) {
    const int r = i / cpr;
    const int c = i - r * cpr;
    const int w = r / group;
    const int g = r - w * group;
    const T* src = q + ((int64_t)(b * W + w) * Hq + h * group + g) * D;
    const uint4 v = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const char*>(src) + c * 16);
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        reinterpret_cast<char*>(sQ + r * ds) + c * 16);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  for (int i = tid; i < rows * D; i += NTH) sAcc[i] = 0.f;
  for (int r = tid; r < rows; r += NTH) {
    sM[r] = NEG_INF_F;
    sL[r] = 0.f;
  }

  // this split's share of the live blocks, in whole tiles
  const int live = min(max(p0 + W - 1, 0) / Tb, nbt - 1) + 1;
  const int n_tiles = (live + tile_blocks - 1) / tile_blocks;
  const int per_split = (n_tiles + n_splits - 1) / n_splits;
  const int j_begin = split * per_split * tile_blocks;
  const int j_end = min(live, j_begin + per_split * tile_blocks);

  const int64_t sblk_stride = (int64_t)L * Hkv * Tb;  // scales: one per row
  const int64_t shead_off = ((int64_t)layer * Hkv + h) * Tb;
  const int64_t blk_stride = sblk_stride * D;
  const int64_t head_off = shead_off * D;
  const int* trow = tbl + (int64_t)b * nbt;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kcpr = D / EPC;  // 16-byte chunks per K/V row
  const int total = KT * kcpr;

  for (int j0 = j_begin; j0 < j_end; j0 += tile_blocks) {
    __syncthreads();  // the previous tile is done with sK / sV / sS
    for (int base = 0; base < total; base += NTH * LOAD_UNROLL) {
      uint4 kr[LOAD_UNROLL], vr[LOAD_UNROLL];
      float ksc[LOAD_UNROLL], vsc[LOAD_UNROLL];
#pragma unroll
      for (int u = 0; u < LOAD_UNROLL; ++u) {
        const int i = base + u * NTH + tid;
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = kr[u];
        ksc[u] = 0.f;
        vsc[u] = 0.f;
        if (i < total) {
          const int key = i / kcpr;
          const int c = i - key * kcpr;
          const int blk = key / Tb;
          const int j = j0 + blk;
          if (j < j_end) {
            const int64_t row = (int64_t)trow[j] * sblk_stride + shead_off + (key - blk * Tb);
            kr[u] = *reinterpret_cast<const uint4*>(k_pool + row * D + c * EPC);
            vr[u] = *reinterpret_cast<const uint4*>(v_pool + row * D + c * EPC);
            if constexpr (QUANT) {
              ksc[u] = k_scale[row];
              vsc[u] = v_scale[row];
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < LOAD_UNROLL; ++u) {
        const int i = base + u * NTH + tid;
        if (i < total) {
          const int key = i / kcpr;
          const int c = i - key * kcpr;
          T* dk = sK + key * ds + c * EPC;
          T* dv = sV + key * ds + c * EPC;
          if constexpr (QUANT) {
            store_dequant16<T>(dk, kr[u], ksc[u]);
            store_dequant16<T>(dv, vr[u], vsc[u]);
          } else {
            uint32_t* wk = reinterpret_cast<uint32_t*>(dk);
            uint32_t* wv = reinterpret_cast<uint32_t*>(dv);
            wk[0] = kr[u].x;
            wk[1] = kr[u].y;
            wk[2] = kr[u].z;
            wk[3] = kr[u].w;
            wv[0] = vr[u].x;
            wv[1] = vr[u].y;
            wv[2] = vr[u].z;
            wv[3] = vr[u].w;
          }
        }
      }
    }
    __syncthreads();

    // scores [rows, KT]; keys of blocks past this split's end are masked
    for (int i = tid; i < rows * KT; i += NTH) {
      const int r = i / KT;
      const int t = i - r * KT;
      const T* qr = sQ + r * ds;
      const T* kr = sK + t * ds;
      float acc = 0.f;
      for (int d = 0; d < D; d += 2) {
        const float2 a = Elem<T>::load2(qr + d);
        const float2 c = Elem<T>::load2(kr + d);
        acc = fmaf(a.x, c.x, acc);
        acc = fmaf(a.y, c.y, acc);
      }
      float s = acc * scale;
      if (j0 + t / Tb >= j_end || j0 * Tb + t > p0 + r / group) s = NEG_INF_F;
      sS[r * ss + t] = s;
    }
    __syncthreads();

    // online-softmax update, one warp per row
    for (int r = warp; r < rows; r += NTH / 32) {
      float* sr = sS + r * ss;
      float mx = NEG_INF_F;
      for (int t = lane; t < KT; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < KT; t += 32) {
        const float p = expf(sr[t] - m_new);
        sum += p;
        sr[t] = Elem<T>::round(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v
    for (int i = tid; i < rows * D; i += NTH) {
      const int r = i / D;
      const int d = i - r * D;
      const float* pr = sS + r * ss;
      float a = 0.f;
      for (int t = 0; t < KT; ++t) a = fmaf(pr[t], Elem<T>::to_f(sV[t * ds + d]), a);
      sAcc[i] = sAcc[i] * sC[r] + a;
    }
  }
  __syncthreads();

  if (n_splits == 1) {
    for (int i = tid; i < rows * D; i += NTH) {
      const int r = i / D;
      const int d = i - r * D;
      const int w = r / group;
      const int g = r - w * group;
      out[((int64_t)(b * W + w) * Hq + h * group + g) * D + d] =
          Elem<T>::from_f(sAcc[i] / fmaxf(sL[r], 1e-30f));
    }
    return;
  }
  // a split with no live tile leaves (m, l) = (-1e30, 0): weight 0 below
  const int64_t prow = (((int64_t)b * Hkv + h) * n_splits + split) * rows;
  for (int i = tid; i < rows * D; i += NTH) part_acc[prow * D + i] = sAcc[i];
  for (int r = tid; r < rows; r += NTH) {
    part_ml[(prow + r) * 2] = sM[r];
    part_ml[(prow + r) * 2 + 1] = sL[r];
  }
}

// Merge the splits of one (slot, kv-head): rescale each split's
// accumulator and sum by exp(m_s - max_s m_s), then normalize.
template <typename T>
__global__ void __launch_bounds__(NTH)
paged_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, T* __restrict__ out,
                     int W, int Hq, int Hkv, int D, int n_splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int group = Hq / Hkv;
  const int rows = group * W;
  const int64_t base = ((int64_t)b * Hkv + h) * n_splits * rows;
  for (int i = threadIdx.x; i < rows * D; i += NTH) {
    const int r = i / D;
    const int d = i - r * D;
    float mx = NEG_INF_F;
    for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, part_ml[(base + s * rows + r) * 2]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const int64_t pr = base + s * rows + r;
      const float wgt = expf(part_ml[pr * 2] - mx);
      l = fmaf(part_ml[pr * 2 + 1], wgt, l);
      a = fmaf(part_acc[pr * D + d], wgt, a);
    }
    const int w = r / group;
    const int g = r - w * group;
    out[((int64_t)(b * W + w) * Hq + h * group + g) * D + d] =
        Elem<T>::from_f(a / fmaxf(l, 1e-30f));
  }
}

// -- tensor-core body: bf16 q over a bf16 pool (K1) or an int8 one (K1q), ----
// -- D in {64, 128, 256} -------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int PM_STAGES = 3;  // K/V (or code) ring: tiles t + 1 and t + 2 load during tile t
constexpr int MIN_SPLIT_TILES = 2;
constexpr int MAX_SPLIT_TILES = 8;
constexpr int COMBINE_ROWS = 8;  // bundle rows a CTA of paged_combine_mma_kernel merges
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Swizzled shared rows (as csrc/flash_attention.cu): chunk c of row r at
// chunk c ^ (r % 8), D elements a row.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// Byte ``a`` of a stage's K or V codes (rows of D bytes) as stored: the
// 16-byte chunk k of 128-byte line l sits at chunk k ^ (l % 8), so the
// copies (two lanes a row, 32 bytes each, 16 rows a warp) and the
// dequantize reads (128 contiguous bytes a half warp) spread evenly over
// the banks at every D.
__device__ __forceinline__ int cswz(int a) { return a ^ (((a >> 7) & 7) << 4); }

// Blocks of the table one split can touch: its keys span split_tiles
// tiles, starting anywhere inside a block.
int split_blocks(int split_tiles, int Tb) { return split_tiles * TILE_KEYS / Tb + 2; }

// Bytes of one code-ring stage: K codes, V codes (64 x D each), K scales, V
// scales (64 f32 each).
__host__ __device__ constexpr int code_stage_bytes(int D) {
  return 2 * TILE_KEYS * D + 2 * TILE_KEYS * 4;
}

// m16 tiles of the bundle one CTA holds (MT; the header's rule)
int mma_tiles_per_cta(int D, int rows) { return D <= 128 && rows > 16 ? 2 : 1; }

// Shared memory, then the split's slice of the block table. bf16 pool: the
// K and V rings of PM_STAGES bf16 tiles, Q's 16 * MT rows. int8 pool: one
// bf16 K and one bf16 V tile, Q, the code ring of PM_STAGES stages. The
// warps' final (m, l, O) reuse the start of it (4 x 16 * MT rows of D + 2
// f32, which every layout above covers).
size_t paged_mma_smem_bytes(bool quant, int D, int MT, int split_tiles, int Tb) {
  const size_t q_rows = 16 * (size_t)MT;
  const size_t tiles =
      quant ? (size_t)(2 * TILE_KEYS + q_rows) * D * sizeof(bf16) +
                  (size_t)PM_STAGES * code_stage_bytes(D)
            : (size_t)(2 * PM_STAGES * TILE_KEYS + q_rows) * D * sizeof(bf16);
  const size_t merge = 4 * q_rows * (D + 2) * sizeof(float);
  return std::max(tiles, merge) + (size_t)split_blocks(split_tiles, Tb) * sizeof(int);
}

template <typename KV, int D, int MT>
__global__ void __launch_bounds__(NTH)
paged_decode_mma_kernel(const bf16* __restrict__ q,     // [B, W, Hq, D]
                        const KV* __restrict__ k_pool,  // [NB, L, Hkv, Tb, D]
                        const KV* __restrict__ v_pool,
                        const int* __restrict__ tbl,    // [B, nbt]
                        const int* __restrict__ pos,    // [B]
                        bf16* __restrict__ out,         // [B, W, Hq, D]
                        float* __restrict__ part_acc,   // [B, Hkv, S, rows, D]
                        float* __restrict__ part_ml,    // [B, Hkv, S, rows, 2]
                        int W, int Hq, int Hkv, int Tb, int L, int nbt, int layer,
                        int n_splits, int split_tiles, float scale_log2,
                        const float* __restrict__ k_scale,  // int8: [NB, L, Hkv, Tb]
                        const float* __restrict__ v_scale) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int TILE = TILE_KEYS * D;  // elements of one K or V stage
  constexpr int KSTEPS = D / 16;
  constexpr int NO = D / 8;  // 8-column n-tiles of a warp's output
  constexpr int CH = D / 8;  // 16-byte chunks a row
  constexpr int QR = 16 * MT;  // bundle rows this CTA holds
  constexpr bool Q_IN_REGS = D * MT <= 128;  // else ldmatrix'd from shared each k-step
  static_assert(TILE_KEYS == 16 * (NTH / 32), "one warp per 16 keys of a tile");
  static_assert(TILE_KEYS * CH % NTH == 0 && QR * CH % NTH == 0, "chunks per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  // bf16: the K and V rings [PM_STAGES][64][D]; int8: one bf16 K and one
  // bf16 V tile [64][D], then Q, then the code ring
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + (QUANT ? 1 : PM_STAGES) * TILE;
  bf16* sQ = sV + (QUANT ? 1 : PM_STAGES) * TILE;  // [QR][D]
  int8_t* sCodes = reinterpret_cast<int8_t*>(sQ + QR * D);
  int* sT = reinterpret_cast<int*>(sCodes + (QUANT ? PM_STAGES * code_stage_bytes(D) : 0));

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int group = Hq / Hkv;
  const int rows = group * W;
  const int row_groups = ((rows + 15) / 16 + MT - 1) / MT;
  const int r0 = blockIdx.z % row_groups * QR;  // the CTA's first bundle row
  const int split = blockIdx.z / row_groups;
  const int p0 = pos[b];
  // keys past pos + W - 1 are masked for every row; the table ends at nbt * Tb
  const int n_keys = min(max(p0 + W, 1), nbt * Tb);
  const int live_tiles = (n_keys + TILE_KEYS - 1) / TILE_KEYS;
  const int t_begin = split * split_tiles;
  if (t_begin >= live_tiles) return;  // past the slot's live keys: nothing to do
  const int n_t = min(live_tiles - t_begin, split_tiles);
  const bool direct = live_tiles <= split_tiles;  // the slot's only live split
  const int key0 = t_begin * TILE_KEYS;
  const int key_end = min(n_keys, key0 + n_t * TILE_KEYS);
  const int j0 = key0 / Tb;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int* trow = tbl + (int64_t)b * nbt;
  // Q: the CTA's QR bundle rows, row R reading q[b, R / group, h * group
  // + R % group]; rows past the bundle are zero (their outputs are never
  // written). bf16: it lands with tile 0; int8: before the table's barrier
  auto load_q = [&]() {
#pragma unroll
    for (int it = 0; it < QR * CH / NTH; ++it) {
      const int i = it * NTH + tid;
      const int r = i / CH;
      const int c = i - r * CH;
      const int R = r0 + r;
      const bool ok = R < rows;
      const int w = R / group;
      const bf16* src = q + ((int64_t)(b * W + w) * Hq + h * group + (R - w * group)) * D;
      cp_async16(sQ + swz<D>(r, c), ok ? src + c * 8 : q, ok);
    }
  };
  if constexpr (QUANT) {
    load_q();
    cp_async_commit();
  }
  for (int j = tid; j <= (key_end - 1) / Tb - j0; j += NTH) sT[j] = trow[j0 + j];
  if constexpr (QUANT) cp_async_wait<0>();
  __syncthreads();

  const int64_t blk_stride = (int64_t)L * Hkv * Tb * D;
  const int64_t head_off = ((int64_t)layer * Hkv + h) * Tb * D;
  // bf16: the 16-byte copies of the split's local tile t into ring stage
  // ``stage``: key row by key row through the table (any Tb; a tile may
  // span blocks); keys at or past key_end are zero-filled
  auto load_kv = [&](int t, int stage) {
    const int k0 = key0 + t * TILE_KEYS;
#pragma unroll
    for (int it = 0; it < TILE_KEYS * CH / NTH; ++it) {
      const int i = it * NTH + tid;
      const int r = i / CH;
      const int c = i - r * CH;
      const int key = k0 + r;
      const bool ok = key < key_end;
      int64_t off = 0;
      if (ok) {
        const int jb = key / Tb;
        off = sT[jb - j0] * blk_stride + head_off + (int64_t)(key - jb * Tb) * D + c * 8;
      }
      cp_async16(sK + stage * TILE + swz<D>(r, c), k_pool + off, ok);
      cp_async16(sV + stage * TILE + swz<D>(r, c), v_pool + off, ok);
    }
  };
  // int8: this warp's 16 key rows of local tile t (the only rows it reads)
  // into code-ring stage ``stage``. Lanes 2i and 2i + 1 take row i: its D
  // codes (32 contiguous bytes a lane pair a copy) and, lane 2i its K scale,
  // lane 2i + 1 its V scale (4-byte copies). ``row`` indexes the scales
  // pool [NB, L, Hkv, Tb], one f32 a key row, so a block's scales are
  // L * Hkv * Tb apart; the row's codes start at row * D. Keys at or past
  // key_end: codes and scales zero-filled.
  auto load_codes = [&](int t, int stage) {
    const int r = warp * 16 + (lane >> 1);
    const int key = key0 + t * TILE_KEYS + r;
    const bool ok = key < key_end;
    int64_t row = 0;
    if (ok) {
      const int jb = key / Tb;
      row = sT[jb - j0] * (int64_t)L * Hkv * Tb + ((int64_t)layer * Hkv + h) * Tb +
            (key - jb * Tb);
    }
    int8_t* st = sCodes + stage * code_stage_bytes(D);
#pragma unroll
    for (int it = 0; it < D / 32; ++it) {
      const int c = 2 * it + (lane & 1);  // 16-byte chunk of the row
      const int a = cswz(r * D + c * 16);
      cp_async16(st + a, k_pool + row * D + c * 16, ok);
      cp_async16(st + TILE + a, v_pool + row * D + c * 16, ok);
    }
    cp_async4(st + 2 * TILE + ((lane & 1) * TILE_KEYS + r) * 4,
              ((lane & 1) ? v_scale : k_scale) + row, ok);
  };
  // int8: this warp's 16 rows of code-ring stage ``stage`` -> its rows of
  // the bf16 K and V tiles: 8 codes (one 8-byte shared read) times the row's
  // scale, rounded to bf16, into one 16-byte chunk (a quarter warp writes 8
  // distinct chunks of a row: no bank conflict); K and V interleaved
  auto dequant = [&](int stage) {
    const int8_t* st = sCodes + stage * code_stage_bytes(D);
    const float* sc = reinterpret_cast<const float*>(st + 2 * TILE);
#pragma unroll
    for (int it = 0; it < 16 * CH / 32; ++it) {
      const int i = it * 32 + lane;
      const int r = warp * 16 + i / CH;
      const int c = i % CH;
      const int a = cswz(r * D + c * 8);
      const uint2 wk = *reinterpret_cast<const uint2*>(st + a);
      const uint2 wv = *reinterpret_cast<const uint2*>(st + TILE + a);
      *reinterpret_cast<uint4*>(sK + swz<D>(r, c)) = dequant8_bf16(wk, sc[r]);
      *reinterpret_cast<uint4*>(sV + swz<D>(r, c)) = dequant8_bf16(wv, sc[TILE_KEYS + r]);
    }
  };

  if constexpr (QUANT) {
    load_codes(0, 0);
    cp_async_commit();
    if (n_t > 1) load_codes(1, 1);
    cp_async_commit();
  } else {
    load_q();
    load_kv(0, 0);
    cp_async_commit();
    if (n_t > 1) load_kv(1, 1);
    cp_async_commit();
  }

  // per m-tile i of the CTA: the output fragments, the running max of rows
  // g and g + 8 (base 2) and this lane's share of their running sums
  float o[MT][NO][4];
  float m[MT][2], l[MT][2];
  // the last key rows g and g + 8 of this lane see: the causal frontier
  // pos + R / group, inside the live keys
  int lim[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int dt = 0; dt < NO; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][dt][e] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[i][hh] = NEG_INF_F;
      l[i][hh] = 0.f;
      lim[i][hh] = min(p0 + (r0 + i * 16 + (lane >> 2) + 8 * hh) / group, key_end - 1);
    }
  }
  uint32_t qf[MT][Q_IN_REGS ? KSTEPS : 1][4];
  const int x_qv = (lane >> 4) ^ (lane & 7);       // Q and V: chunk 2 * step + lane / 16
  const int x_k = ((lane >> 3) & 1) ^ (lane & 7);  // K: chunk 2 * step + (lane / 8) % 2
  const bf16* sQw = sQ + (lane & 15) * D;          // m-tile i: + i * 16 * D
  // this warp's 16 keys of a tile: rows warp * 16 .. + 15 of the stage
  const int k_row = (warp * 16 + (lane >> 4) * 8 + (lane & 7)) * D;
  const int v_row = (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * D;

  int stage = 0;
  for (int t = 0; t < n_t; ++t) {
    const bf16* sKs = sK;
    const bf16* sVs = sV;
    if constexpr (QUANT) {
      // a warp reads only the rows it copied and writes: no block barrier
      cp_async_wait<1>();  // this lane's copies of tile t have landed
      __syncwarp();        // ... every lane's, and every lane is done with tile t - 1
      if (t + 2 < n_t) load_codes(t + 2, stage == 0 ? 2 : stage - 1);  // tile t - 1's stage
      cp_async_commit();
      dequant(stage);
      __syncwarp();  // the warp's bf16 rows are written
    } else {
      cp_async_wait<1>();  // tile t has landed; tile t + 1 may still be in flight
      __syncthreads();     // ... for every thread, and every warp is done with tile t - 1
      if (t + 2 < n_t) load_kv(t + 2, stage == 0 ? 2 : stage - 1);  // tile t - 1's stage
      cp_async_commit();
      sKs += stage * TILE;
      sVs += stage * TILE;
    }
    if constexpr (Q_IN_REGS) {
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks)
            ldmatrix_x4(qf[i][ks], sQw + i * 16 * D + (((2 * ks) ^ x_qv) << 3));
      }
    }

    // S = Q K^T: each m-tile's 16 rows x this warp's 16 keys, one K
    // fragment a k-step for all MT tiles
    float s[MT][2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t kf[4];  // keys +0 .. +7 and +8 .. +15, dims ks*16 .. +15
      ldmatrix_x4(kf, sKs + k_row + (((2 * ks) ^ x_k) << 3));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        if constexpr (Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[i][ks][e];
        } else {
          ldmatrix_x4(a, sQw + i * 16 * D + (((2 * ks) ^ x_qv) << 3));
        }
        mma_bf16_16816(s[i][0], a, kf[0], kf[1]);
        mma_bf16_16816(s[i][1], a, kf[2], kf[3]);
      }
    }

    // scale (base 2) and mask: the frontier, the split's end, the table's end
    const int kbase = key0 + t * TILE_KEYS + warp * 16 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kbase + nt * 8 + (e & 1);
          s[i][nt][e] = kp > lim[i][e >> 1] ? NEG_INF_F : s[i][nt][e] * scale_log2;
        }

    // online softmax on the fragments; a row that has seen no live key yet
    // keeps p = 0, so (m, l, O) stay (-1e30, 0, 0) and weigh 0 below
    bool rescale = false;
    float corr[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = fmaxf(m[i][hh], fmaxf(fmaxf(s[i][0][2 * hh], s[i][0][2 * hh + 1]),
                                         fmaxf(s[i][1][2 * hh], s[i][1][2 * hh + 1])));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mref = mx == NEG_INF_F ? 0.f : mx;
        corr[i][hh] = fast_exp2(m[i][hh] - mref);
        rescale |= corr[i][hh] != 1.f;
        m[i][hh] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float p0v = fast_exp2(s[i][nt][2 * hh] - mref);
          const float p1v = fast_exp2(s[i][nt][2 * hh + 1] - mref);
          s[i][nt][2 * hh] = p0v;
          s[i][nt][2 * hh + 1] = p1v;
          sum += p0v + p1v;
        }
        l[i][hh] = l[i][hh] * corr[i][hh] + sum;
      }
    if (__any_sync(0xffffffffu, rescale)) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int dt = 0; dt < NO; ++dt) {
          o[i][dt][0] *= corr[i][0];
          o[i][dt][1] *= corr[i][0];
          o[i][dt][2] *= corr[i][1];
          o[i][dt][3] *= corr[i][1];
        }
    }

    // O += P V: P rounded to bf16 in registers (the JAX p.astype(v.dtype)),
    // one V fragment a step for all MT tiles
    uint32_t pa[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      pa[i][0] = pack_bf16(s[i][0][0], s[i][0][1]);
      pa[i][1] = pack_bf16(s[i][0][2], s[i][0][3]);
      pa[i][2] = pack_bf16(s[i][1][0], s[i][1][1]);
      pa[i][3] = pack_bf16(s[i][1][2], s[i][1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vf[4];  // keys +0 .. +15, dims dp*16 .. +7 and +8 .. +15
      ldmatrix_x4_trans(vf, sVs + v_row + (((2 * dp) ^ x_qv) << 3));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16_16816(o[i][2 * dp], pa[i], vf[0], vf[1]);
        mma_bf16_16816(o[i][2 * dp + 1], pa[i], vf[2], vf[3]);
      }
    }
    stage = stage == PM_STAGES - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the rings: they take (m, l, O)

  // the 4 warps' states, then their merge: weights 2^(m_w - max_w m_w)
  float* sO = reinterpret_cast<float*>(smem);  // [4][QR][D]
  float* sML = sO + 4 * QR * D;                // [4][QR][2]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[i][hh];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int r = warp * QR + i * 16 + (lane >> 2) + 8 * hh;
      if ((lane & 3) == 0) {
        sML[r * 2] = m[i][hh];
        sML[r * 2 + 1] = lt;
      }
#pragma unroll
      for (int dt = 0; dt < NO; ++dt)
        *reinterpret_cast<float2*>(sO + r * D + dt * 8 + (lane & 3) * 2) =
            make_float2(o[i][dt][2 * hh], o[i][dt][2 * hh + 1]);
    }
  __syncthreads();
  const int64_t prow = (((int64_t)b * Hkv + h) * n_splits + split) * rows;
  for (int i = tid; i < QR * D / 4; i += NTH) {
    const int r = i / (D / 4);
    const int d = (i - r * (D / 4)) * 4;
    const int R = r0 + r;
    if (R >= rows) break;  // rows grow with i
    float mx = NEG_INF_F;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, sML[(w * QR + r) * 2]);
    float lsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wgt = fast_exp2(sML[(w * QR + r) * 2] - mx);
      lsum = fmaf(sML[(w * QR + r) * 2 + 1], wgt, lsum);
      const float4 x = *reinterpret_cast<const float4*>(sO + (w * QR + r) * D + d);
      acc.x = fmaf(x.x, wgt, acc.x);
      acc.y = fmaf(x.y, wgt, acc.y);
      acc.z = fmaf(x.z, wgt, acc.z);
      acc.w = fmaf(x.w, wgt, acc.w);
    }
    if (direct) {
      const float den = fmaxf(lsum, 1e-30f);
      const int w = R / group;
      bf16* orow = out + ((int64_t)(b * W + w) * Hq + h * group + (R - w * group)) * D + d;
      *reinterpret_cast<__nv_bfloat162*>(orow) = __floats2bfloat162_rn(acc.x / den, acc.y / den);
      *reinterpret_cast<__nv_bfloat162*>(orow + 2) =
          __floats2bfloat162_rn(acc.z / den, acc.w / den);
    } else {
      *reinterpret_cast<float4*>(part_acc + (prow + R) * D + d) = acc;
      if (d == 0) {  // m in natural-log units, as the combine kernel reads it
        part_ml[(prow + R) * 2] = mx * LN2;
        part_ml[(prow + R) * 2 + 1] = lsum;
      }
    }
  }
}

// Merge the splits of one (slot, kv-head) for paged_decode_mma_kernel: split
// s held key tiles [s * split_tiles, (s + 1) * split_tiles) of the slot's
// live tiles, so only the first ceil(live / split_tiles) are read, and a
// slot with one live split was written by that split directly. A CTA takes
// COMBINE_ROWS rows of the bundle (blockIdx.z), so a wide bundle (a
// verify's 28 rows) spreads over as many CTAs as its rows need rather than
// lengthening one CTA's chain of loads. Every (split, row) (m, l) is read
// at once into shared memory, each row's weights exp(m_s - max m) and
// 1 / sum are formed once, then each thread sums 4 adjacent output columns
// over the splits with independent loads.
template <int D>
__global__ void __launch_bounds__(NTH)
paged_combine_mma_kernel(const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml, bf16* __restrict__ out,
                         const int* __restrict__ pos, int W, int Hq, int Hkv, int Tb,
                         int nbt, int n_splits, int split_tiles) {
  extern __shared__ float sw[];  // [n_splits][nr] m, then weights; [n_splits][nr] l; [nr]
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int group = Hq / Hkv;
  const int rows = group * W;
  const int r0 = blockIdx.z * COMBINE_ROWS;
  const int nr = min(COMBINE_ROWS, rows - r0);
  const int n_keys = min(max(pos[b] + W, 1), nbt * Tb);
  const int ns = ((n_keys + TILE_KEYS - 1) / TILE_KEYS + split_tiles - 1) / split_tiles;
  if (ns <= 1) return;
  float* sL = sw + n_splits * nr;
  float* sInv = sL + n_splits * nr;
  const int64_t base = ((int64_t)b * Hkv + h) * n_splits * rows + r0;
  for (int i = threadIdx.x; i < ns * nr; i += NTH) {
    const int s = i / nr;
    const float2 ml =
        *reinterpret_cast<const float2*>(part_ml + (base + s * rows + i - s * nr) * 2);
    sw[i] = ml.x;
    sL[i] = ml.y;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nr; r += NTH) {
    float mx = NEG_INF_F;
    for (int s = 0; s < ns; ++s) mx = fmaxf(mx, sw[s * nr + r]);
    float l = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float wgt = expf(sw[s * nr + r] - mx);
      sw[s * nr + r] = wgt;
      l = fmaf(sL[s * nr + r], wgt, l);
    }
    sInv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * (D / 4); i += NTH) {
    const int r = i / (D / 4);
    const int d = (i - r * (D / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const float wgt = sw[s * nr + r];
      const float4 x =
          *reinterpret_cast<const float4*>(part_acc + (base + s * rows + r) * D + d);
      acc.x = fmaf(x.x, wgt, acc.x);
      acc.y = fmaf(x.y, wgt, acc.y);
      acc.z = fmaf(x.z, wgt, acc.z);
      acc.w = fmaf(x.w, wgt, acc.w);
    }
    const float inv = sInv[r];
    const int R = r0 + r;
    const int w = R / group;
    bf16* orow = out + ((int64_t)(b * W + w) * Hq + h * group + (R - w * group)) * D + d;
    *reinterpret_cast<__nv_bfloat162*>(orow) = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    *reinterpret_cast<__nv_bfloat162*>(orow + 2) =
        __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
}

// The kernel's attributes, set once a device: room for its largest shared
// memory (the size depends on split_tiles and Tb), all of the SM's 228 KB to
// shared memory.
template <typename KV, int D, int MT>
cudaError_t paged_mma_attributes() {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(paged_decode_mma_kernel<KV, D, MT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(paged_decode_mma_kernel<KV, D, MT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  return e;
}

template <typename KV, int D, int MT>
int launch_paged_mma(const void* q, const void* kp, const void* vp, const float* ks,
                     const float* vs, const int* tbl, const int* pos, void* out,
                     float* part_acc, float* part_ml, int B, int W, int Hq, int Hkv, int Tb,
                     int L, int nbt, int layer, int n_splits, float scale,
                     cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  const int tiles = (nbt * Tb + TILE_KEYS - 1) / TILE_KEYS;
  const int split_tiles = (tiles + n_splits - 1) / n_splits;
  const int rows = (Hq / Hkv) * W;
  const size_t smem = paged_mma_smem_bytes(QUANT, D, MT, split_tiles, Tb);
  const size_t combine_smem =
      (2 * (size_t)n_splits + 1) * std::min(rows, COMBINE_ROWS) * sizeof(float);
  if (smem > SMEM_MAX || combine_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = paged_mma_attributes<KV, D, MT>();
  if (e != cudaSuccess) return (int)e;
  const int row_groups = ((rows + 15) / 16 + MT - 1) / MT;
  paged_decode_mma_kernel<KV, D, MT><<<dim3(Hkv, B, n_splits * row_groups), NTH, smem,
                                       stream>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
      tbl, pos, static_cast<bf16*>(out), part_acc, part_ml, W, Hq, Hkv, Tb, L, nbt, layer,
      n_splits, split_tiles, scale * LOG2E, ks, vs);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return (int)e;
  paged_combine_mma_kernel<D>
      <<<dim3(Hkv, B, (rows + COMBINE_ROWS - 1) / COMBINE_ROWS), NTH, combine_smem, stream>>>(
          part_acc, part_ml, static_cast<bf16*>(out), pos, W, Hq, Hkv, Tb, nbt, n_splits,
          split_tiles);
  return (int)cudaGetLastError();
}

// paged_decode_mma_kernel at head dim D, with the CTA's m-tile count picked
// from the bundle's rows
template <typename KV, int D>
int launch_paged_mma_d(const void* q, const void* kp, const void* vp, const float* ks,
                       const float* vs, const int* tbl, const int* pos, void* out,
                       float* part_acc, float* part_ml, int B, int W, int Hq, int Hkv,
                       int Tb, int L, int nbt, int layer, int n_splits, float scale,
                       cudaStream_t s) {
  if constexpr (D <= 128) {
    if (mma_tiles_per_cta(D, (Hq / Hkv) * W) == 2)
      return launch_paged_mma<KV, D, 2>(q, kp, vp, ks, vs, tbl, pos, out, part_acc, part_ml,
                                        B, W, Hq, Hkv, Tb, L, nbt, layer, n_splits, scale, s);
  }
  return launch_paged_mma<KV, D, 1>(q, kp, vp, ks, vs, tbl, pos, out, part_acc, part_ml, B, W,
                                    Hq, Hkv, Tb, L, nbt, layer, n_splits, scale, s);
}

// The tensor-core body's rule: bf16 q over a bf16 pool (K1) or an int8 one
// (K1q), D in {64, 128, 256}.
bool uses_mma(int dtype, int kv_dtype, int D) {
  return dtype == DTYPE_BF16 && (kv_dtype == DTYPE_BF16 || kv_dtype == DTYPE_INT8) &&
         (D == 64 || D == 128 || D == 256);
}

template <typename T, typename KV>
int launch_paged(const void* q, const void* kp, const void* vp, const float* ks,
                 const float* vs, const int* tbl, const int* pos, void* out,
                 float* part_acc, float* part_ml, int B, int W, int Hq, int Hkv, int D,
                 int Tb, int L, int nbt, int layer, int n_splits, float scale,
                 cudaStream_t stream) {
  const int rows = (Hq / Hkv) * W;
  const int tile_blocks = tile_blocks_for(Tb);
  const size_t smem = smem_bytes(rows, D, tile_blocks * Tb, sizeof(T));
  cudaError_t e = allow_smem(paged_decode_kernel<T, KV>, smem);
  if (e != cudaSuccess) return (int)e;
  paged_decode_kernel<T, KV><<<dim3(Hkv, B, n_splits), NTH, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp), static_cast<const KV*>(vp),
      ks, vs, tbl, pos, static_cast<T*>(out), part_acc, part_ml, W, Hq, Hkv, D, Tb, L,
      nbt, layer, n_splits, tile_blocks, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return (int)e;
  paged_combine_kernel<T><<<dim3(Hkv, B), NTH, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), W, Hq, Hkv, D, n_splits);
  return (int)cudaGetLastError();
}

template <typename KV>
int dispatch_mma(int D, const void* q, const void* kp, const void* vp, const float* ks,
                 const float* vs, const int* tbl, const int* pos, void* out,
                 float* part_acc, float* part_ml, int B, int W, int Hq, int Hkv, int Tb,
                 int L, int nbt, int layer, int n_splits, float scale, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch_paged_mma_d<KV, 64>(q, kp, vp, ks, vs, tbl, pos, out, part_acc,
                                        part_ml, B, W, Hq, Hkv, Tb, L, nbt, layer,
                                        n_splits, scale, s);
    case 128:
      return launch_paged_mma_d<KV, 128>(q, kp, vp, ks, vs, tbl, pos, out, part_acc,
                                         part_ml, B, W, Hq, Hkv, Tb, L, nbt, layer,
                                         n_splits, scale, s);
    case 256:
      return launch_paged_mma_d<KV, 256>(q, kp, vp, ks, vs, tbl, pos, out, part_acc,
                                         part_ml, B, W, Hq, Hkv, Tb, L, nbt, layer,
                                         n_splits, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// How a shape is served, decided once per shape by the wrapper: returns the
// body (1: paged_decode_mma_kernel<bf16, D>, 2: paged_decode_mma_kernel<
// int8_t, D>, 0: paged_decode_kernel, -1: a type pair neither takes) and
// sets the split count to launch with and the shared memory a CTA needs
// (the wrapper refuses shapes above the card's 227 KB).
// The tensor-core body splits by work: a fixed number of 64-key tiles a
// split (2 to 8, so a full table would give about two CTAs an SM), as many
// splits as the table's width needs, and a slot's CTAs past its live tiles
// exit at once. The FMA body divides the table's tiles among about two CTAs
// an SM (``sms``), at most 16 splits, whatever the slot's length.
int paged_decode_plan(int dtype, int kv_dtype, int B, int W, int Hq, int Hkv, int D,
                      int Tb, int nbt, int sms, int* n_splits, size_t* smem) {
  const int tiles = (nbt * Tb + TILE_KEYS - 1) / TILE_KEYS;
  if (uses_mma(dtype, kv_dtype, D)) {
    // tiles a split: the full table's CTA-tiles over about two CTAs an SM,
    // within [MIN_SPLIT_TILES, MAX_SPLIT_TILES]; short slots use fewer splits
    const int rows = (Hq / Hkv) * W;
    const int mt = mma_tiles_per_cta(D, rows);
    const int cta_tiles = tiles * B * Hkv * (((rows + 15) / 16 + mt - 1) / mt);
    const int st = std::min(MAX_SPLIT_TILES,
                            std::max(MIN_SPLIT_TILES, (cta_tiles + 2 * sms - 1) / (2 * sms)));
    *n_splits = (tiles + st - 1) / st;
    const bool quant = kv_dtype == DTYPE_INT8;
    *smem = paged_mma_smem_bytes(quant, D, mt, (tiles + *n_splits - 1) / *n_splits, Tb);
    return quant ? 2 : 1;
  }
  if (!(kv_dtype == dtype || kv_dtype == DTYPE_INT8) ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return -1;
  const int want = (2 * sms + B * Hkv - 1) / (B * Hkv);
  *n_splits = std::max(1, std::min(std::min(16, tiles), want));
  *smem = smem_bytes((Hq / Hkv) * W, D, tile_blocks_for(Tb) * Tb,
                     dtype == DTYPE_F32 ? 4 : 2);
  return 0;
}

// q and out in ``dtype`` (DTYPE_F32 or DTYPE_BF16); the pools in
// ``kv_dtype``: the same, or DTYPE_INT8 with their f32 scales k_scale /
// v_scale (null otherwise; D % 16 == 0). ``n_splits`` as paged_decode_plan
// gives it. Returns cudaGetLastError() after the launches (0 = launched).
// With n_splits > 1, part_acc [B*Hkv*n_splits*rows*D] and part_ml
// [B*Hkv*n_splits*rows*2] are f32 scratch allocated by the caller.
int paged_decode_attention(int dtype, int kv_dtype, const void* q, const void* k_pool,
                           const void* v_pool, const float* k_scale,
                           const float* v_scale, const int* tbl, const int* pos,
                           void* out, float* part_acc, float* part_ml, int B, int W,
                           int Hq, int Hkv, int D, int Tb, int L, int nbt, int layer,
                           int n_splits, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_splits < 1) return (int)cudaErrorInvalidValue;
  if (kv_dtype == DTYPE_INT8 && (D % 16 || k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (uses_mma(dtype, kv_dtype, D)) {
    if (kv_dtype == DTYPE_INT8)
      return dispatch_mma<int8_t>(D, q, k_pool, v_pool, k_scale, v_scale, tbl, pos, out,
                                  part_acc, part_ml, B, W, Hq, Hkv, Tb, L, nbt, layer,
                                  n_splits, scale, s);
    return dispatch_mma<bf16>(D, q, k_pool, v_pool, nullptr, nullptr, tbl, pos, out,
                              part_acc, part_ml, B, W, Hq, Hkv, Tb, L, nbt, layer, n_splits,
                              scale, s);
  }
  if (kv_dtype == DTYPE_INT8) {
    if (dtype == DTYPE_BF16)
      return launch_paged<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tbl,
                                                 pos, out, part_acc, part_ml, B, W, Hq,
                                                 Hkv, D, Tb, L, nbt, layer, n_splits,
                                                 scale, s);
    if (dtype == DTYPE_F32)
      return launch_paged<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tbl, pos,
                                         out, part_acc, part_ml, B, W, Hq, Hkv, D, Tb, L,
                                         nbt, layer, n_splits, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (kv_dtype != dtype) return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return launch_paged<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr,
                                                      tbl, pos, out, part_acc, part_ml,
                                                      B, W, Hq, Hkv, D, Tb, L, nbt, layer,
                                                      n_splits, scale, s);
  if (dtype == DTYPE_F32)
    return launch_paged<float, float>(q, k_pool, v_pool, nullptr, nullptr, tbl, pos, out,
                                      part_acc, part_ml, B, W, Hq, Hkv, D, Tb, L, nbt,
                                      layer, n_splits, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
