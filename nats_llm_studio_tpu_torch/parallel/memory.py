"""Per-device memory accounting for a serving config, before the device
is touched.

``estimate_device_bytes`` and ``kv_pool_block_bytes`` are copies of
``nats_llm_studio_tpu/parallel/memory.py`` (with the lines of
``ops/wquant.py effective_group`` that the int4 branch needs), so both
packages price a config alike. ``estimate_load_bytes`` is the port's own:
what loading a GGUF into the port's ``ContinuousBatcher`` holds on the card
(``serve/registry.py`` admits a load against it).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.config import ModelConfig


def effective_group(in_dim: int, group: int) -> int:
    """Largest even group <= ``group`` that divides ``in_dim`` (the int4
    weight layout's rows per scale/zero-point group)."""
    g = max(2, min(group, in_dim))
    while in_dim % g or g % 2:
        g -= 1
        if g < 2:
            raise ValueError(f"no valid int4 group for in_dim={in_dim}")
    return g


@dataclass
class _Leaf:
    shape: tuple[int, ...]
    shard_axes: tuple[int, ...]  # which dims divide by (tp-or-ep) factors
    itemsize: int
    quantizable: bool = False


def _leaves(cfg: ModelConfig, dtype_bytes: int) -> dict[str, _Leaf]:
    d, hq, hkv, hd, ff, L, V = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.d_ff, cfg.n_layers, cfg.vocab_size,
    )
    out: dict[str, _Leaf] = {
        "embed": _Leaf((V, d), (), dtype_bytes),
        "out_norm": _Leaf((d,), (), dtype_bytes),
        "lm_head": _Leaf((d, V), (1,), dtype_bytes, quantizable=True),
        "blocks.attn_norm": _Leaf((L, d), (), dtype_bytes),
        "blocks.ffn_norm": _Leaf((L, d), (), dtype_bytes),
        "blocks.wq": _Leaf((L, d, hq * hd), (2,), dtype_bytes, True),
        "blocks.wk": _Leaf((L, d, hkv * hd), (2,), dtype_bytes, True),
        "blocks.wv": _Leaf((L, d, hkv * hd), (2,), dtype_bytes, True),
        "blocks.wo": _Leaf((L, hq * hd, d), (1,), dtype_bytes, True),
    }
    if cfg.attn_bias:
        out |= {
            "blocks.bq": _Leaf((L, hq * hd), (1,), dtype_bytes),
            "blocks.bk": _Leaf((L, hkv * hd), (1,), dtype_bytes),
            "blocks.bv": _Leaf((L, hkv * hd), (1,), dtype_bytes),
        }
    if cfg.is_moe:
        e = cfg.n_experts
        out |= {
            "blocks.router": _Leaf((L, d, e), (), dtype_bytes),
            # dim1 divides by ep, the tp dim by tp (handled by caller factors)
            "blocks.w_gate_e": _Leaf((L, e, d, ff), (1, 3), dtype_bytes, True),
            "blocks.w_up_e": _Leaf((L, e, d, ff), (1, 3), dtype_bytes, True),
            "blocks.w_down_e": _Leaf((L, e, ff, d), (1, 2), dtype_bytes, True),
        }
    else:
        out |= {
            "blocks.w_gate": _Leaf((L, d, ff), (2,), dtype_bytes, True),
            "blocks.w_up": _Leaf((L, d, ff), (2,), dtype_bytes, True),
            "blocks.w_down": _Leaf((L, ff, d), (1,), dtype_bytes, True),
        }
    return out


def estimate_device_bytes(
    cfg: ModelConfig,
    mesh_shape: dict[str, int],
    quant: str = "none",
    batch: int = 8,
    seq_len: int | None = None,
    cache_dtype_bytes: int | None = None,
    group: int = 32,
) -> dict[str, int]:
    """Estimated peak HBM bytes per device: params + KV cache + workspace.

    ``mesh_shape`` e.g. {"tp": 8} or {"dp": 2, "ep": 4}. Sharded axes divide
    by the product of the tensor-parallel-like factors exactly as
    ``param_sharding_rules`` assigns them (tp for dense, ep x tp for experts).
    A dp factor does NOT divide anything: dp serves as independent batcher
    replicas on disjoint device slices, so each device sees one replica's
    full weights-and-cache footprint — per-chip bytes at ``dp=2,tp=2``
    equal ``tp=2``. ``quant="int4"`` prices grouped QTensor4 storage: half
    a byte per code plus an f32 scale AND zero-point per ``group``
    contraction rows.
    """
    dtype_bytes = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    tp = mesh_shape.get("tp", 1)
    ep = mesh_shape.get("ep", 1)
    seq = seq_len or cfg.max_seq_len
    # replicated-KV GQA fallback (sharding.kv_replicated): when tp cannot
    # divide the KV heads, wk/wv/bk/bv and the cache stay whole per chip
    kv_tp = tp if cfg.n_kv_heads % tp == 0 else 1
    _KV_LEAVES = ("blocks.wk", "blocks.wv", "blocks.bk", "blocks.bv")

    params = 0
    for name, leaf in _leaves(cfg, dtype_bytes).items():
        n = 1
        for dim in leaf.shape:
            n *= dim
        # divide by the mesh factor on each sharded axis. For experts the
        # first sharded axis is ep, the second tp; for dense leaves it is tp.
        t = kv_tp if name in _KV_LEAVES else tp
        factors = [ep, tp] if len(leaf.shard_axes) == 2 else [t] * len(leaf.shard_axes)
        for f in factors:
            n //= f
        if quant == "int8" and leaf.quantizable:
            w_bytes = n  # int8 codes
            # scale: one f32 per output channel (last axis), same sharding
            scale_elems = n // leaf.shape[-2] if len(leaf.shape) >= 2 else 0
            params += w_bytes + scale_elems * 4
        elif quant == "int4" and leaf.quantizable:
            # packed nibbles: half a byte per code; scale + zero-point:
            # one f32 pair per group of contraction rows (wquant degrades
            # the group to divide small contraction axes — same here)
            g = effective_group(leaf.shape[-2], group)
            meta_elems = (n // leaf.shape[-2]) * (leaf.shape[-2] // g)
            params += n // 2 + meta_elems * 2 * 4
        else:
            params += n * dtype_bytes

    cb = cache_dtype_bytes or dtype_bytes
    kv = 2 * cfg.n_layers * batch * seq * cfg.n_kv_heads * cfg.head_dim * cb
    # dp is served as independent batcher REPLICAS over disjoint device
    # slices (mesh.dp_submeshes): each replica holds its own full-``batch``
    # cache, so per-DEVICE kv bytes do not divide by dp — only the kv-head
    # tp sharding (unless replicated) shrinks them
    kv //= kv_tp

    # workspace: logits [B, V] f32 (vocab sharded on tp) + activations
    # [B, T, d]-scale temporaries + collective buffers; a conservative pad
    work = batch * cfg.vocab_size * 4 // tp + 64 * 2**20
    total = params + kv + work
    return {"params": params, "kv_cache": kv, "workspace": work, "total": total}


def kv_pool_block_bytes(cfg: ModelConfig, block_tokens: int,
                        kv_quant: str | None = None, tp: int = 1) -> int:
    """Per-device bytes of ONE paged-KV pool block: K+V for ``block_tokens``
    positions across every layer. Under int8 KVQ the codes are 1 byte/elem
    plus one f32 scale per (layer, kv-head, position). ``tp`` is the factor
    actually sharding the KV-head axis (1 under the replicated-KV GQA
    fallback) — the registry prices the whole pool as blocks x this."""
    quant = (kv_quant if kv_quant is not None else cfg.kv_quant) == "int8"
    dtype_bytes = 4 if cfg.dtype == "float32" else 2
    per_pos = (
        cfg.head_dim * (1 if quant else dtype_bytes) + (4 if quant else 0)
    )
    return 2 * cfg.n_layers * cfg.n_kv_heads * block_tokens * per_pos // max(1, tp)


# the serving batcher's default geometry (serve/batcher.py
# ContinuousBatcher); the block size is the ``KV_BLOCK_TOKENS`` setting
PREFILL_CHUNK = 256
KV_BLOCK_TOKENS = 16


def serving_geometry(max_seq: int, chunk: int = PREFILL_CHUNK,
                     block: int = KV_BLOCK_TOKENS) -> tuple[int, int]:
    """(prefill chunk, KV block tokens) the batcher serves ``max_seq``
    with: the chunk halved until it divides max_seq (down to 8), the block
    halved until it divides the chunk."""
    while max_seq % chunk and chunk > 8:
        chunk //= 2
    t = block
    while t > 1 and chunk % t:
        t //= 2
    return chunk, t


def prefill_activation_bytes(cfg: ModelConfig, tokens: int) -> int:
    """Device bytes live at the peak of a ``tokens``-token forward: inside
    one layer's SwiGLU, the gate product, its activation, the up product
    and their product ([T, d_ff] each), beside the residual, both norm
    outputs ([T, d_model] each), q and the attention output ([T, Hq*D]
    each) and the fresh k and v ([T, Hkv*D] each), all in the compute
    dtype (``models/llama.py forward``, ``ops/layers.py swiglu``)."""
    e = 4 if cfg.dtype == "float32" else 2
    q_dim, kv_dim = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return tokens * e * (4 * cfg.d_ff + 3 * cfg.d_model + 2 * q_dim + 2 * kv_dim)


def estimate_load_bytes(cfg: ModelConfig, max_slots: int = 8,
                        max_seq_len: int | None = None, prefix_cache_blocks: int = 0,
                        max_group_long: int = 4, kv_block_tokens: int = KV_BLOCK_TOKENS,
                        kv_pool_blocks: int = 0) -> dict[str, int]:
    """Device bytes of one model served by the port's batcher, priced as it
    allocates them (``cfg.dtype`` and ``cfg.kv_quant`` are the serving
    ones):

    * ``params``: the reference's count (lm_head included: the batcher
      materializes it for tied embeddings);
    * ``kv_pool``: ``max_slots * blocks_per_row + prefix_cache_blocks + 1``
      pool blocks (every slot at max_seq, the prefix cache's budget and the
      null block), or ``kv_pool_blocks + 1`` when ``KV_POOL_BLOCKS`` sets
      the population, of ``kv_block_tokens`` tokens (snapped to divide the
      serving chunk), as ``serve/batcher.py`` allocates them;
    * ``prefix``: the chunk-end logits rows the prefix cache keeps beside
      its blocks, one [1, 1, V] f32 row a node of C/T blocks; with the
      pool's prefix blocks this is the reference's ``prefix_block_bytes``
      a node;
    * ``workspace``: the reference's ``B * V * 4 + 64 MiB`` (decode logits
      and sampling) plus the larger of the batcher's two largest admits
      (C is the serving chunk).
      One is a fresh prefill of the max_seq bucket into an idle batcher
      (``prefill_full``): its transient [1, L, Hkv, max_seq, D] row cache
      pair and that forward's activations (``prefill_activation_bytes``).
      The other is a batched chunked admit of ``max_group_long`` long
      prompts (``prefill_chunk_group``), padded to ``mpad`` rows (a power
      of two): ``mpad`` row cache pairs at max_seq, the activations of an
      [mpad, C] chunk, the per-chunk logits kept for the prefix cache
      (``ceil(max_seq / C) * mpad * V * 4``), the selected prompt-end rows
      and one row's copies of its chunk-end rows.
      A speculative verify's [B, k+1, V] f32 logits, weights and noise run
      between admits, never beside one, and sit below either term: no term
      of their own.
    """
    seq = min(max_seq_len or cfg.max_seq_len, cfg.max_seq_len)
    chunk, t = serving_geometry(seq, block=max(1, kv_block_tokens))
    prefix_blocks = max(0, prefix_cache_blocks)
    blocks = 1 + (kv_pool_blocks if kv_pool_blocks > 0
                  else max_slots * (seq // t) + prefix_blocks)
    est = estimate_device_bytes(cfg, {}, batch=max_slots, seq_len=seq)
    pool = blocks * kv_pool_block_bytes(cfg, t)
    row = 4 * cfg.vocab_size  # one [1, 1, V] f32 logits row
    prefix = prefix_blocks // (chunk // t) * row
    row_cache = kv_pool_block_bytes(cfg, seq)  # one [1, L, Hkv, max_seq, D] pair
    single = row_cache + prefill_activation_bytes(cfg, seq)
    group = 0
    m = min(max_slots, max(1, max_group_long))
    if m > 1:
        mpad = 1 << (m - 1).bit_length()
        n_chunks = -(-seq // chunk)
        group = (mpad * row_cache + prefill_activation_bytes(cfg, mpad * chunk)
                 + (n_chunks * mpad + mpad + n_chunks) * row)
    work = est["workspace"] + max(single, group)
    return {"params": est["params"], "kv_pool": pool, "prefix": prefix,
            "workspace": work, "total": est["params"] + pool + prefix + work}
