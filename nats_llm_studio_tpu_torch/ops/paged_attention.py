"""Paged-attention decode: the CUDA kernels K1 (bf16/f32 pool) and K1q
(int8 pool) and their plain version.

Port of ``nats_llm_studio_tpu/ops/paged_attention.py``
``paged_decode_attention``, both branches of its ``pallas_call``. The
kernels (``csrc/paged_attention.cu``) run one CTA per (slot, kv-head,
split), each walking its share of the slot's live blocks through the block
table and reading the pool [NB, L, Hkv, T, D] in place at the runtime
``layer``; a second kernel merges the splits. bf16 q at D 64, 128 or 256
runs the tensor-core body (``mma``), over a bf16 pool (K1) or an int8
``KVQ`` pool (K1q: codes [NB, L, Hkv, T, D] and f32 scales [NB, L, Hkv, T]
gathered into a code ring and dequantized by each warp into the bf16 tiles
it reads); at D <= 128 one CTA holds a bundle of up to 32 rows (a
speculative verify's 28) whole. Every other shape, and f32 q over either
pool, runs the FMA body (``fma``).
The library's ``paged_decode_plan`` picks the body and the split count
once per shape, by type, with no fallback between bodies.
The Mosaic tiling rule of the JAX path (``paged_decode_eligible``) does not
apply: any T and any D <= 256 with D % 8 == 0 (D % 16 == 0 for int8
codes) is served.

``paged_decode_attention`` launches K1, or K1q for a KVQ pool, for CUDA
tensors and uses ``paged_decode_attention_plain`` only for CPU tensors.
Each wrapper counts its launches (``launches``) and, by body,
``body_launches`` and, for bf16 q, ``bf16_body_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .kvcache import KVQ, dequantize, is_quantized
from .layers import NEG_INF, softmax_pv

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block can use
BODIES = ("fma", "mma")  # the counters' names
_BODY_OF_PLAN = ("fma", "mma", "mma")  # paged_decode_plan's body code -> its name
_PLANS: dict = {}


def _plan(q, kp, tbl) -> tuple[int, int]:
    """(body, n_splits) for this shape, decided once per shape by the
    library's ``paged_decode_plan``: body 1 is the tensor-core kernel over
    a bf16 pool (bf16 q, D 64/128/256), body 2 the same kernel over an int8
    pool (bf16 q, D 64/128/256), body 0 the FMA kernel (every other q dtype,
    pool and D). Raises if the shape needs more shared memory than a block
    can use."""
    b, w, hq, d = q.shape
    hkv, t = kp.shape[2], kp.shape[3]
    key = (q.device, q.dtype, kp.dtype, b, w, hq, hkv, d, t, tbl.shape[1])
    plan = _PLANS.get(key)
    if plan is None:
        lib = _build.load_library("paged_attention")
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits, smem = ctypes.c_int(0), ctypes.c_size_t(0)
        body = lib.paged_decode_plan(
            _build.dtype_code(q.dtype), _build.dtype_code(kp.dtype), b, w, hq, hkv, d, t,
            tbl.shape[1], sms, ctypes.byref(splits), ctypes.byref(smem))
        if body < 0:
            raise TypeError(f"paged decode: no kernel takes q {q.dtype} over a {kp.dtype} pool")
        if smem.value > SMEM_LIMIT:
            raise ValueError(
                f"paged decode: {smem.value} bytes of shared memory needed (rows="
                f"{(hq // hkv) * w}, T={t}, D={d}); the card allows {SMEM_LIMIT}")
        plan = _PLANS[key] = (body, splits.value)
    return plan


def _gather(pool, idx: torch.Tensor, layer: int, dtype: torch.dtype) -> torch.Tensor:
    """The blocks ``idx`` [B, NB] of ``layer`` as a dense [B, Hkv, NB*T, D]
    slab; a KVQ pool is dequantized to ``dtype``, as the kernel does."""
    if is_quantized(pool):
        x = dequantize(KVQ(pool.q[idx, layer], pool.s[idx, layer]), dtype)
    else:
        x = pool[idx, layer]
    b, nb, hkv, t, d = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(b, hkv, nb * t, d)


def paged_decode_attention_plain(q, k_pool, v_pool, tbl, pos, layer: int,
                                 scale: float) -> torch.Tensor:
    """Dense reference of K1 and K1q: gather each slot's blocks of ``layer``
    through its table (dequantizing a KVQ pool to q's dtype), mask keys
    past ``pos + w`` for query offset w, f32 scores, probabilities rounded
    where the kernel rounds them. Same signature and result as the
    kernel."""
    b, w, hq, d = q.shape
    hkv = k_pool.shape[2]
    g = hq // hkv
    idx = tbl.long()
    kk = _gather(k_pool, idx, layer, q.dtype)
    vv = _gather(v_pool, idx, layer, q.dtype)
    qg = q.reshape(b, w, hkv, g, d)
    s = torch.einsum("bwhgd,bhsd->bhgws", qg.float(), kk.float()) * scale
    key = torch.arange(kk.shape[2], device=q.device)
    front = pos.long()[:, None] + torch.arange(w, device=q.device)[None, :]
    mask = key[None, None, :] <= front[:, :, None]  # [B, W, S]
    s = torch.where(mask[:, None, None], s, torch.full((), NEG_INF, device=q.device))
    return softmax_pv(s, vv).to(q.dtype).reshape(b, w, hq, d)


def paged_decode_attention(q, k_pool, v_pool, tbl, pos, layer: int,
                           scale: float) -> torch.Tensor:
    """Attention of W new tokens per slot over its whole paged history
    (K1; K1q when the pools are KVQ pairs).

    q: [B, W, Hq, D]; k_pool/v_pool: [NB, L, Hkv, T, D] in q's dtype (bf16
    or f32), or KVQ pairs of int8 codes [NB, L, Hkv, T, D] and f32 scales
    [NB, L, Hkv, T], already holding the W fresh rows (write-then-attend);
    tbl: [B, NBt] int32 block ids; pos: [B] int32 first query position;
    layer: int. Returns [B, W, Hq, D] in q.dtype."""
    if is_quantized(k_pool) or is_quantized(v_pool):
        return paged_decode_attention_kvq(q, k_pool, v_pool, tbl, pos, layer, scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tbl, pos, layer, scale)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q and both pools must share one dtype")
    out = torch.empty_like(q)
    body = _launch("paged_decode_attention", q, k_pool, v_pool, None, None, tbl, pos, layer,
                   scale, out)
    _count(paged_decode_attention, body, q)
    return out


def paged_decode_attention_kvq(q, k_pool: KVQ, v_pool: KVQ, tbl, pos, layer: int,
                               scale: float) -> torch.Tensor:
    """K1q: ``paged_decode_attention`` over an int8 KVQ pool. Each tile's
    codes are taken as signed int8, multiplied by their f32 scale and
    rounded to q's dtype before the products, as the JAX kernel does.
    bf16 q at D 64, 128 or 256 runs the tensor-core body (plan body 2),
    f32 q and other head dims the FMA body."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tbl, pos, layer, scale)
    name = "paged_decode_attention_kvq"
    if not (is_quantized(k_pool) and is_quantized(v_pool)):
        raise TypeError(f"{name}: both pools must be KVQ pairs")
    for tn, x in (("k_pool", k_pool), ("v_pool", v_pool)):
        if x.q.dtype != torch.int8 or x.s.dtype != torch.float32:
            raise TypeError(f"{name}: {tn} must hold int8 codes and float32 scales")
        if x.s.shape != x.q.shape[:-1]:
            raise ValueError(f"{name}: {tn} scales {tuple(x.s.shape)} do not match codes "
                             f"{tuple(x.q.shape)}")
    if q.shape[-1] % 16:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} must be a multiple of 16 for "
                         f"16-byte loads of int8 codes")
    out = torch.empty_like(q)
    body = _launch(name, q, k_pool.q, v_pool.q, k_pool.s, v_pool.s, tbl, pos, layer, scale, out)
    _count(paged_decode_attention_kvq, body, q)
    return out


def _count(fn, body: str, q) -> None:
    fn.launches += 1
    fn.body_launches[body] += 1
    if q.dtype == torch.bfloat16:
        fn.bf16_body_launches[body] += 1


def _launch(name: str, q, kp, vp, ks, vs, tbl, pos, layer: int, scale: float, out) -> str:
    """Check the operands and launch the decode kernel (and the split
    merge) on the current stream; returns the body that ran. kp/vp: pools
    in q's dtype with ks/vs None, or int8 codes with their f32 scales."""
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {q.device}")
    b, w, hq, d = q.shape
    nbp, n_layers, hkv, t, dp = kp.shape
    operands = [("k_pool", kp), ("v_pool", vp), ("tbl", tbl), ("pos", pos)]
    if ks is not None:
        operands += [("k_scales", ks), ("v_scales", vs)]
    for tn, x in operands:
        if x.device != q.device:
            raise ValueError(f"{name}: {tn} on {x.device}, q on {q.device}")
    if vp.shape != kp.shape or dp != d:
        raise ValueError(f"{name}: pool shapes do not match q")
    if hq % hkv:
        raise ValueError(f"{name}: Hq={hq} not a multiple of Hkv={hkv}")
    if d > 256 or d % 8:
        raise ValueError(f"{name}: head_dim {d} must be <= 256 and a multiple of 8")
    if tbl.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{name}: tbl and pos must be int32")
    if tbl.dim() != 2 or tbl.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{name}: tbl must be [B, NB] and pos [B]")
    if not 0 <= layer < n_layers:
        raise ValueError(f"{name}: layer {layer} outside [0, {n_layers})")
    for tn, x in [("q", q)] + operands:
        if not x.is_contiguous():
            raise ValueError(f"{name}: {tn} must be contiguous")
        if tn in ("q", "k_pool", "v_pool") and x.data_ptr() % 16:
            raise ValueError(f"{name}: {tn} must be 16-byte aligned")
    lib = _build.load_library("paged_attention")
    rows = (hq // hkv) * w
    body, splits = _plan(q, kp, tbl)
    part_acc = part_ml = None
    if splits > 1:  # per-split accumulators, then (max, sum), merged on the card
        n = b * hkv * splits * rows
        part = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
        part_acc, part_ml = part[:n * d], part[n * d:]
    rc = lib.paged_decode_attention(
        _build.dtype_code(q.dtype), _build.dtype_code(kp.dtype), q.data_ptr(),
        kp.data_ptr(), vp.data_ptr(),
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None,
        tbl.data_ptr(), pos.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        b, w, hq, hkv, d, t, n_layers, tbl.shape[1], int(layer), splits, float(scale),
        _build.current_stream(q.device))
    _build.check_launch(name, rc)
    return _BODY_OF_PLAN[body]


for _fn in (paged_decode_attention, paged_decode_attention_kvq):
    _fn.launches = 0
    _fn.body_launches = dict.fromkeys(BODIES, 0)
    _fn.bf16_body_launches = dict.fromkeys(BODIES, 0)
