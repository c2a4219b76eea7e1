"""Llama-family transformer in PyTorch.

Port of ``nats_llm_studio_tpu/models/llama.py`` (dense FFN; MoE, the ring
decode slot and ``decode_unroll`` are not ported yet). The layouts are the
reference's: params are a dict of ``[L, in, out]`` stacks applied as
``x @ w``, row caches are ``[B, L, Hkv, S, D]`` and the paged pool is
``[NB, L, Hkv, T, D]``, each a tensor in the compute dtype or, under
``kv_quant == "int8"``, a ``KVQ`` pair of int8 codes and f32 scales
written quantized. A Python loop over layers takes the place of
``lax.scan``. Caches and pools are written in place (JAX gets the same
effect from donated buffers), and the updated tensors are returned so the
call shape matches the reference.

Attention goes through an ``AttentionOps`` bundle: ``KERNELS`` (the CUDA
kernels K1-K4, whose wrappers use their plain versions for CPU tensors) is
the default and the only one the serving path uses; ``PLAIN`` is the dense
reference ``chip_smoke.py`` holds the kernels against on the card.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..device import resolve_device, torch_dtype
from ..gguf.constants import GGMLType
from ..ops.flash_attention import (
    flash_attention,
    flash_attention_chunk,
    flash_attention_chunk_kvq,
    flash_attention_chunk_kvq_plain,
    flash_attention_chunk_plain,
    flash_attention_plain,
)
from ..ops.kvcache import (
    KVQ,
    is_quantized,
    kv_pool_row_index,
    kv_pool_write_rows,
    kv_update_slice,
    kv_zeros,
)
from ..ops.layers import (
    apply_rope,
    gqa_attention_hmajor,
    mm,
    rms_norm,
    rope_cos_sin,
    swiglu,
)
from ..ops.paged_attention import paged_decode_attention, paged_decode_attention_plain
from .config import ModelConfig

Params = dict[str, Any]


@dataclass(frozen=True)
class AttentionOps:
    flash: Callable        # K2: fresh causal prefill
    chunk: Callable        # K3: chunked-prefill continuation
    chunk_kvq: Callable    # K4: the same over the int8 cache
    paged: Callable        # K1 / K1q (KVQ pool): paged decode


KERNELS = AttentionOps(flash_attention, flash_attention_chunk, flash_attention_chunk_kvq,
                       paged_decode_attention)
PLAIN = AttentionOps(flash_attention_plain, flash_attention_chunk_plain,
                     flash_attention_chunk_kvq_plain, paged_decode_attention_plain)


def _layer(params: Params, l: int) -> Params:
    return {k: v[l] for k, v in params["blocks"].items()}


def _qkv(h, p, cfg: ModelConfig, b: int, t: int):
    q = mm(h, p["wq"])
    k = mm(h, p["wk"])
    v = mm(h, p["wv"])
    if cfg.attn_bias:  # qwen2-family QKV biases
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(b, t, cfg.n_heads, cfg.head_dim),
            k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim))


def _scaled(x, scale: float):
    """x * scale; a unit scale launches nothing (the product is exact)."""
    return x if scale == 1.0 else x * scale


def _ffn(x, p, cfg: ModelConfig):
    h = rms_norm(x, p["ffn_norm"], cfg.rms_eps, cfg.norm_plus_one)
    return x + _scaled(swiglu(h, p["w_gate"], p["w_up"], p["w_down"], cfg.mlp_act),
                       cfg.residual_scale)


def _embed(params: Params, cfg: ModelConfig, tokens):
    return _scaled(params["embed"][tokens.long()].to(torch_dtype(cfg.dtype)),
                   cfg.embedding_scale)


def _rope_tables(positions, cfg: ModelConfig):
    """cos/sin in the compute dtype, made once per forward for every layer."""
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    dt = torch_dtype(cfg.dtype)
    return cos.to(dt), sin.to(dt)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,      # int [B, T]
    k_cache,                   # [B, L, Hkv, S, D] tensor or KVQ, written in place
    v_cache,
    start_pos: torch.Tensor,   # int [B] — write offset per row
    attn_window: int | None = None,
    logit_positions: torch.Tensor | None = None,
    fresh_prefill: bool = False,
    uniform_start: bool = False,
    attn: AttentionOps = KERNELS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Positional forward: returns (logits f32 [B, T, vocab] — or
    [B, 1, vocab] with ``logit_positions`` — k_cache, v_cache).

    The fresh rows are written into the caches first (quantized on write
    under KVQ). Prefill attention, as in the reference's positional path
    with flash attention on: a block at start 0 (``fresh_prefill``, or
    every start 0) runs K2 over the raw fresh rows; a chunk continuation
    with ``uniform_start`` runs K3 over the cache slab ``[:attn_window]``,
    or K4 over its codes and scales under KVQ; other shapes (t == 1, ragged
    starts) use the dense oracle, whose KVQ branch folds the scales as the
    reference does. K3 and K4 mask any window edge, so the reference's
    fallback for windows its kernels cannot tile (``_chunk_tileable``) has
    no counterpart here."""
    if cfg.is_moe:
        raise NotImplementedError("MoE models are not ported yet")
    b, t = tokens.shape
    s_max = k_cache.shape[3]
    quant = is_quantized(k_cache)
    dev = tokens.device
    starts = [int(s) for s in start_pos.tolist()]
    positions = start_pos.to(dev).long()[:, None] + torch.arange(t, device=dev)[None, :]
    cos, sin = _rope_tables(positions, cfg)
    win = attn_window if (attn_window is not None and attn_window < s_max) else s_max
    fresh = fresh_prefill or all(s == 0 for s in starts)
    flash = t > 1
    mask = None
    if not (flash and (fresh or uniform_start)):
        key_pos = torch.arange(win, device=dev)
        mask = key_pos[None, None, :] <= positions[:, :, None]  # [B, T, win]
    # the fresh rows land at start..start+t (clamped to fit, as the
    # reference's dynamic_update_slice clamps its start)
    w0 = [min(max(s, 0), s_max - t) for s in starts]

    x = _embed(params, cfg, tokens)
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps, cfg.norm_plus_one)
        q, k, v = _qkv(h, p, cfg, b, t)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kv_update_slice(k_cache, k.transpose(1, 2), l, w0)  # rows [B, Hkv, T, D]
        kv_update_slice(v_cache, v.transpose(1, 2), l, w0)
        if flash and fresh:
            out = attn.flash(q, k, v, cfg.attn_scale)
        elif flash and uniform_start and quant:
            out = attn.chunk_kvq(q, k_cache.q[:, l, :, :win], k_cache.s[:, l, :, :win],
                                 v_cache.q[:, l, :, :win], v_cache.s[:, l, :, :win],
                                 cfg.attn_scale, starts[0])
        elif flash and uniform_start:
            out = attn.chunk(q, k_cache[:, l, :, :win], v_cache[:, l, :, :win],
                             cfg.attn_scale, starts[0])
        else:
            out = gqa_attention_hmajor(q, _window(k_cache, l, win, q.dtype),
                                       _window(v_cache, l, win, q.dtype), mask,
                                       cfg.attn_scale)
        x = x + _scaled(mm(out.reshape(b, t, -1), p["wo"]), cfg.residual_scale)
        x = _ffn(x, p, cfg)
    return lm_head_logits(params, cfg, x, logit_positions, t), k_cache, v_cache


def _window(cache, layer: int, win: int, dtype: torch.dtype):
    """The attention operand [B, Hkv, win, D] of ``layer``: a slab cast to
    the compute dtype, or the KVQ slab as it is (the dense attention folds
    its scales)."""
    if is_quantized(cache):
        return KVQ(cache.q[:, layer, :, :win], cache.s[:, layer, :, :win])
    return cache[:, layer, :, :win].to(dtype)


def forward_decode_paged(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,     # int [B, W] — W == 1 decode
    k_pool,                   # [NB, L, Hkv, T, D] tensor or KVQ, written in place
    v_pool,
    tbl: torch.Tensor,        # int32 [B, NBt]
    start_pos: torch.Tensor,  # int32 [B] — tokens already in each slot
    attn: AttentionOps = KERNELS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode forward straight over the paged pool: per layer, project,
    rope at each slot's positions, write the W fresh rows into the pool
    (quantized on write into both leaves of a KVQ pool), then attend over
    the slot's whole paged history with K1, or K1q on a KVQ pool
    (write-then-attend: the causal frontier includes the fresh rows).
    Returns (logits [B, W, vocab] f32, k_pool, v_pool)."""
    if cfg.is_moe:
        raise NotImplementedError("MoE models are not ported yet")
    b, w = tokens.shape
    dev = tokens.device
    positions = start_pos.long()[:, None] + torch.arange(w, device=dev)[None, :]
    cos, sin = _rope_tables(positions, cfg)
    index = kv_pool_row_index(tbl, start_pos, w, k_pool.shape[3])
    x = _embed(params, cfg, tokens)
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = rms_norm(x, p["attn_norm"], cfg.rms_eps, cfg.norm_plus_one)
        q, k, v = _qkv(h, p, cfg, b, w)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        kv_pool_write_rows(k_pool, k, tbl, start_pos, l, index)
        kv_pool_write_rows(v_pool, v, tbl, start_pos, l, index)
        out = attn.paged(q, k_pool, v_pool, tbl, start_pos, l, cfg.attn_scale)
        x = x + _scaled(mm(out.reshape(b, w, -1), p["wo"]), cfg.residual_scale)
        x = _ffn(x, p, cfg)
    return lm_head_logits(params, cfg, x, None, w), k_pool, v_pool


def lm_head_logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   logit_positions: torch.Tensor | None, t: int) -> torch.Tensor:
    """Output head: optional per-row position gather, final norm, lm_head
    (tied-embedding fallback), f32 logits times the logit scale."""
    if logit_positions is not None and t > 1:
        idx = logit_positions.to(x.device).long()[:, None, None].expand(-1, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)  # [B, 1, d]
    x = rms_norm(x, params["out_norm"], cfg.rms_eps, cfg.norm_plus_one)
    lm_head = params.get("lm_head")
    if lm_head is None:
        lm_head = params["embed"].t()
    return _scaled(mm(x, lm_head).float(), cfg.logit_scale)


def ensure_lm_head(params: Params) -> Params:
    """Materialize a contiguous [d_model, vocab] lm_head for tied-embedding
    models, so the decode loop reads a matmul-native layout."""
    if "lm_head" in params:
        return params
    params = dict(params)
    params["lm_head"] = params["embed"].t().contiguous()
    return params


def make_cache(cfg: ModelConfig, batch: int, seq_len: int | None = None,
               dtype: str | None = None, device="cuda") -> tuple[Any, Any]:
    """Zeroed row-cache pair [B, L, Hkv, S, D] on ``device`` (the card
    unless the caller asks for the CPU): tensors in ``dtype`` (the
    config's by default), or KVQ pairs under ``cfg.kv_quant == "int8"``."""
    dev = resolve_device(device)
    s = seq_len or cfg.max_seq_len
    shape = (batch, cfg.n_layers, cfg.n_kv_heads, s, cfg.head_dim)
    if cfg.kv_quant == "int8":
        return kv_zeros(shape, dev), kv_zeros(shape, dev)
    dt = torch_dtype(dtype or cfg.dtype)
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


# -- GGUF loading -----------------------------------------------------------

_TORCH_OF_GGML = {
    GGMLType.F32: torch.float32,
    GGMLType.F16: torch.float16,
    GGMLType.BF16: torch.bfloat16,
}


def _rope_deinterleave(w: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """GGUF q/k weights rotate interleaved pairs; the model rotates (first
    half, second half). Permute the output features so both agree: out
    index h*D + 2i+j -> h*D + j*D/2+i."""
    d_in = w.shape[0]
    return (w.reshape(d_in, n_heads, head_dim // 2, 2)
            .transpose(2, 3)
            .reshape(d_in, n_heads * head_dim))


def _gguf_tensor(reader, name: str, device) -> torch.Tensor:
    """One GGUF tensor on ``device`` in logical shape. Float storage types
    are read from the mapped file as they are (no f32 detour); other types
    dequantize through numpy. The result never aliases the file mapping."""
    t = reader.tensor(name)
    tdt = _TORCH_OF_GGML.get(t.ggml_type)
    if tdt is None:
        host = torch.from_numpy(t.to_numpy())
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # read-only buffer: we copy below
            host = torch.frombuffer(t.raw(), dtype=tdt, count=t.n_elements)
        host = host.reshape(t.shape)
    out = host.to(device)
    if out.data_ptr() == host.data_ptr():
        out = out.clone()
    return out


def load_params_from_gguf(reader, cfg: ModelConfig, dtype: str | None = None,
                          device="cuda") -> Params:
    """The stacked-params dict from a GGUF reader, on ``device`` (the card
    unless the caller asks for the CPU). GGUF stores weights [out, in];
    they are transposed to [in, out] here (on the device) so the forward
    uses plain ``x @ w``."""
    if cfg.is_moe:
        raise NotImplementedError("MoE models are not ported yet")
    device = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    L = cfg.n_layers
    blocks: dict[str, torch.Tensor] = {}

    def vec(name: str) -> torch.Tensor:
        return _gguf_tensor(reader, name, device).to(dt)

    def mat(name: str) -> torch.Tensor:
        return _gguf_tensor(reader, name, device).t().to(dt).contiguous()

    def put(key: str, i: int, x: torch.Tensor) -> None:
        if key not in blocks:
            blocks[key] = torch.empty((L,) + tuple(x.shape), dtype=dt, device=device)
        blocks[key][i] = x

    for i in range(L):
        pre = f"blk.{i}"
        put("attn_norm", i, vec(f"{pre}.attn_norm.weight"))
        put("ffn_norm", i, vec(f"{pre}.ffn_norm.weight"))
        put("wq", i, _rope_deinterleave(mat(f"{pre}.attn_q.weight"), cfg.n_heads, cfg.head_dim))
        put("wk", i, _rope_deinterleave(mat(f"{pre}.attn_k.weight"), cfg.n_kv_heads, cfg.head_dim))
        put("wv", i, mat(f"{pre}.attn_v.weight"))
        put("wo", i, mat(f"{pre}.attn_output.weight"))
        if cfg.attn_bias:
            # biases share the weights' output-feature order, so q/k biases
            # need the same rope pair permutation
            put("bq", i, _rope_deinterleave(vec(f"{pre}.attn_q.bias")[None],
                                            cfg.n_heads, cfg.head_dim)[0])
            put("bk", i, _rope_deinterleave(vec(f"{pre}.attn_k.bias")[None],
                                            cfg.n_kv_heads, cfg.head_dim)[0])
            put("bv", i, vec(f"{pre}.attn_v.bias"))
        put("w_gate", i, mat(f"{pre}.ffn_gate.weight"))
        put("w_up", i, mat(f"{pre}.ffn_up.weight"))
        put("w_down", i, mat(f"{pre}.ffn_down.weight"))

    params: Params = {
        "embed": vec("token_embd.weight"),
        "out_norm": vec("output_norm.weight"),
        "blocks": blocks,
    }
    if "output.weight" in reader.tensors:
        params["lm_head"] = mat("output.weight")
    return params
