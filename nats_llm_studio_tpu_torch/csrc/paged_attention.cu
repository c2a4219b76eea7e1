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
// quantized branch does). One template body serves both: KV is the
// storage type (T or int8_t), and the scale pointers are null for K1.
//
// What bounds it on the H100: bytes. Each decode step reads every live K/V
// row of every slot once (2 x context x Hkv x D x 2 bytes per slot per
// layer in bf16; D + 4 bytes per row in int8) and does ~2 flops per byte
// read, far below the ~295 flops/byte where the tensor cores would become
// the limit. The int8 pool halves the bytes.
//
// What the design does about it:
//  * one CTA per (slot, kv-head, split): each K/V tile is read from device
//    memory once and serves the whole GQA row bundle (group x W query
//    rows), so the grouped heads cost no extra bytes;
//  * the CTA reads its own block-table row and position and walks only its
//    share of the live blocks 0..(pos+W-1)//T, so a slot's cost follows its
//    context, not the table width (no scalar prefetch, no dead grid cells);
//  * split-K (flash-decoding): a slot's live blocks are divided between
//    ``n_splits`` CTAs, so 8 slots x 8 kv-heads still fill the 132 SMs;
//    each split leaves its unnormalized accumulator and (max, sum), and
//    paged_combine_kernel merges them (one split writes the output
//    directly);
//  * a tile is 64 keys (several 16-token blocks), loaded with 16-byte
//    vector loads issued four per thread before their shared-memory
//    stores, so many loads are in flight per CTA;
//  * the layer is a runtime argument indexed inside the kernel: the pool is
//    never sliced or copied per layer.
// Scores and PV products are scalar f32 FMAs; cp.async/TMA double buffering
// is the next step.
//
// Numerics follow the JAX kernel: f32 scores and online-softmax state,
// -1e30 mask, probabilities rounded to the pool dtype before the PV product,
// l clamped at 1e-30. Row r of the bundle is (query offset r / group,
// q-head r % group); its causal frontier is key_pos <= pos + r / group.
// Tables that point at the null block 0 give finite junk.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NTH = 128;        // threads per CTA
constexpr int TILE_KEYS = 64;   // keys per iteration
constexpr int LOAD_UNROLL = 4;  // 16-byte loads in flight per thread

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

}  // namespace

extern "C" {

// Shared memory the decode kernel needs for this shape (the wrapper
// refuses shapes above the card's 227 KB per block).
size_t paged_decode_smem_bytes(int rows, int D, int Tb, int itemsize) {
  return smem_bytes(rows, D, tile_blocks_for(Tb) * Tb, itemsize);
}

// q and out in ``dtype`` (DTYPE_F32 or DTYPE_BF16); the pools in
// ``kv_dtype``: the same, or DTYPE_INT8 with their f32 scales k_scale /
// v_scale (null otherwise; D % 16 == 0). Returns cudaGetLastError() after
// the launches (0 = launched). With n_splits > 1, part_acc
// [B*Hkv*n_splits*rows*D] and part_ml [B*Hkv*n_splits*rows*2] are f32
// scratch allocated by the caller.
int paged_decode_attention(int dtype, int kv_dtype, const void* q, const void* k_pool,
                           const void* v_pool, const float* k_scale,
                           const float* v_scale, const int* tbl, const int* pos,
                           void* out, float* part_acc, float* part_ml, int B, int W,
                           int Hq, int Hkv, int D, int Tb, int L, int nbt, int layer,
                           int n_splits, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_splits < 1) return (int)cudaErrorInvalidValue;
  if (kv_dtype == DTYPE_INT8) {
    if (D % 16 || k_scale == nullptr || v_scale == nullptr)
      return (int)cudaErrorInvalidValue;
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
