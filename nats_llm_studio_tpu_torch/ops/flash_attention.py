"""Causal flash attention for prefill: CUDA kernels K2, K3 and K4 and
their plain versions.

Port of ``nats_llm_studio_tpu/ops/flash_attention.py``:

* ``flash_attention`` (K2): causal self-attention over a fresh [B, T] block;
* ``flash_attention_chunk`` (K3): chunked-prefill continuation, queries at
  [start, start + C) over the heads-major cache slab [B, Hkv, KW, D].
  ``start`` is a kernel argument and the kernel masks the ragged KW edge,
  so every window is served (the JAX path needs a tileable window);
* ``flash_attention_chunk_kvq`` (K4): K3 over an int8 slab, codes
  [B, Hkv, KW, D] and f32 scales [B, Hkv, KW], dequantized tile by tile.

All three launch a kernel of ``csrc/flash_attention.cu``, whose
``body_of`` picks the body by q dtype and head dim: bf16 at D = 128 the
Hopper body (wgmma products on operands brought by TMA),
other bf16 head dims the mma.sync body, f32 the FMA body. The slabs may be
strided views of the row cache (e.g. ``k_cache[:, layer, :, :win]``),
which the kernels read in place. Each wrapper launches its kernel for CUDA
tensors and uses its plain version only for CPU tensors; it counts its
launches (``launches``) and, by body, in ``body_launches``.
"""

from __future__ import annotations

import torch

from . import _build
from .kvcache import KVQ, dequantize
from .layers import NEG_INF, softmax_pv

HEAD_DIMS = (64, 128, 256)  # head dims the kernel is built for
BODIES = ("fma", "mma", "wgmma")  # the kernel's body codes (csrc Body)
_bodies: dict = {}


def kernel_body(dtype, d: int) -> str:
    """The body K2, K3 and K4 run for q in ``dtype`` at head dim ``d``, as
    the library's ``flash_body`` rules (cached per key)."""
    key = (dtype, d)
    body = _bodies.get(key)
    if body is None:
        code = _build.load_library("flash_attention").flash_body(_build.dtype_code(dtype), d)
        if code < 0:
            raise TypeError(f"no flash kernel body for {dtype} at head_dim {d}")
        body = _bodies[key] = BODIES[code]
    return body


def _count(fn, body: str) -> None:
    fn.launches += 1
    fn.body_launches[body] += 1


def flash_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """Dense reference of K2: q [B, T, Hq, D], k/v [B, T, Hkv, D]; f32
    scores, probabilities rounded where the kernel rounds them."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, t, hkv, g, d)
    s = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float()) * scale
    pos = torch.arange(t, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    out = softmax_pv(s, v.transpose(1, 2))
    return out.to(q.dtype).reshape(b, t, hq, d)


def flash_attention_chunk_plain(q, k, v, scale: float, start: int) -> torch.Tensor:
    """Dense reference of K3: q [B, C, Hq, D] at positions [start,
    start + C); k/v [B, Hkv, KW, D]; mask k_pos <= q_pos; rounding as
    the kernel's."""
    b, c, hq, d = q.shape
    hkv, kw = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, c, hkv, g, d)
    s = torch.einsum("bchgd,bhsd->bhgcs", qg.float(), k.float()) * scale
    q_pos = int(start) + torch.arange(c, device=q.device)
    k_pos = torch.arange(kw, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    return softmax_pv(s, v).to(q.dtype).reshape(b, c, hq, d)


def flash_attention_chunk_kvq_plain(q, kq, ks, vq, vs, scale: float,
                                    start: int) -> torch.Tensor:
    """Dense reference of K4: the int8 slabs dequantized to q's dtype
    (codes x scale in f32, then rounded, where the kernel rounds), then
    K3's reference."""
    return flash_attention_chunk_plain(q, dequantize(KVQ(kq, ks), q.dtype),
                                       dequantize(KVQ(vq, vs), q.dtype), scale, start)


def _check(name: str, q, k, v, kv_dtype=None) -> None:
    """Raise on operands the kernel does not take: k/v in ``kv_dtype``
    (q's dtype by default), head_dim in HEAD_DIMS, contiguous last axes and
    16-byte aligned rows."""
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k and v must be on one device")
    kv_dtype = kv_dtype or q.dtype
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"{name}: k and v must be {kv_dtype}, q {q.dtype}")
    d = q.shape[-1]
    if d not in HEAD_DIMS or k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    for tn, x in (("q", q), ("k", k), ("v", v)):
        vec = 16 // x.element_size()  # elements per 16-byte vector load
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: {tn} must be contiguous in its last axis")
        if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:-1]):
            raise ValueError(f"{name}: {tn} rows must be 16-byte aligned")


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal self-attention over a fresh block (K2). q: [B, T, Hq, D];
    k, v: [B, T, Hkv, D] (any strides with a contiguous last axis).
    Returns [B, T, Hq, D] in q.dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check("flash_attention", q, k, v)
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape != (b, t, hkv, d) or v.shape != k.shape or hq % hkv:
        raise ValueError("flash_attention: expected q [B,T,Hq,D], k/v [B,T,Hkv,D]")
    out = torch.empty((b, t, hq, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library("flash_attention")
    rc = lib.flash_attention(
        _build.dtype_code(q.dtype), d,
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        out.data_ptr(), b, t, hq, hkv, float(scale),
        _build.current_stream(q.device))
    _build.check_launch("flash_attention", rc)
    _count(flash_attention, kernel_body(q.dtype, d))
    return out


def flash_attention_chunk(q, k, v, scale: float, start: int) -> torch.Tensor:
    """Chunk-continuation attention (K3). q: [B, C, Hq, D] at positions
    [start, start + C); k, v: [B, Hkv, KW, D] (a strided view of the row
    cache is fine). Rows whose prompt is shorter than ``start`` give finite
    junk. Returns [B, C, Hq, D] in q.dtype."""
    if q.device.type == "cpu":
        return flash_attention_chunk_plain(q, k, v, scale, start)
    _check("flash_attention_chunk", q, k, v)
    b, c, hq, d = q.shape
    hkv, kw = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, kw, d) or v.shape != k.shape or hq % hkv:
        raise ValueError("flash_attention_chunk: expected q [B,C,Hq,D], k/v [B,Hkv,KW,D]")
    out = torch.empty((b, c, hq, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library("flash_attention")
    rc = lib.flash_attention_chunk(
        _build.dtype_code(q.dtype), d,
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
        v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
        out.data_ptr(), b, c, hq, hkv, kw, int(start), float(scale),
        _build.current_stream(q.device))
    _build.check_launch("flash_attention_chunk", rc)
    _count(flash_attention_chunk, kernel_body(q.dtype, d))
    return out


def flash_attention_chunk_kvq(q, kq, ks, vq, vs, scale: float, start: int) -> torch.Tensor:
    """Chunk-continuation attention over the int8 cache (K4). q: [B, C, Hq,
    D] at positions [start, start + C); kq/vq: int8 codes [B, Hkv, KW, D];
    ks/vs: f32 scales [B, Hkv, KW] (strided views of the row cache's codes
    and scales are fine). Masking and junk rows as K3. Returns [B, C, Hq, D]
    in q.dtype."""
    if q.device.type == "cpu":
        return flash_attention_chunk_kvq_plain(q, kq, ks, vq, vs, scale, start)
    name = "flash_attention_chunk_kvq"
    _check(name, q, kq, vq, kv_dtype=torch.int8)
    b, c, hq, d = q.shape
    hkv, kw = kq.shape[1], kq.shape[2]
    if kq.shape != (b, hkv, kw, d) or vq.shape != kq.shape or hq % hkv:
        raise ValueError(f"{name}: expected q [B,C,Hq,D], codes [B,Hkv,KW,D]")
    for tn, x in (("ks", ks), ("vs", vs)):
        if x.device != q.device or x.dtype != torch.float32:
            raise TypeError(f"{name}: {tn} must be float32 on {q.device}")
        if x.shape != kq.shape[:-1] or x.stride(-1) != 1:
            raise ValueError(f"{name}: {tn} must be [B,Hkv,KW] with a contiguous last axis")
    out = torch.empty((b, c, hq, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library("flash_attention")
    rc = lib.flash_attention_chunk_kvq(
        _build.dtype_code(q.dtype), d,
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        kq.data_ptr(), kq.stride(0), kq.stride(1), kq.stride(2),
        ks.data_ptr(), ks.stride(0), ks.stride(1),
        vq.data_ptr(), vq.stride(0), vq.stride(1), vq.stride(2),
        vs.data_ptr(), vs.stride(0), vs.stride(1),
        out.data_ptr(), b, c, hq, hkv, kw, int(start), float(scale),
        _build.current_stream(q.device))
    _build.check_launch(name, rc)
    _count(flash_attention_chunk_kvq, kernel_body(q.dtype, d))
    return out


for _fn in (flash_attention, flash_attention_chunk, flash_attention_chunk_kvq):
    _fn.launches = 0
    _fn.body_launches = dict.fromkeys(BODIES, 0)
