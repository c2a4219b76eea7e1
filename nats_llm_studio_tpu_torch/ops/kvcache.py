"""KV storage: row caches and the paged block pool, in the compute dtype or
as int8 codes with f32 scales.

Port of the ops of ``nats_llm_studio_tpu/ops/kvcache.py`` that the serving
path runs. A cache is either a tensor or a ``KVQ`` pair (int8 codes plus
one f32 scale per position and kv-head, ``TPU_KV_QUANT=int8``); every op
below takes both and works per leaf on a ``KVQ``. The pool is
[NB, L, Hkv, T, D] (scales [NB, L, Hkv, T]) with block 0 as the null block:
writes to it are junk that the causal mask never reads.

JAX updates caches through donated buffers and returns new arrays; here the
tensors are written in place and the same objects are returned, so no copy
of a cache or the pool is ever made.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KVQ:
    """Quantized cache tensor: ``value ~= q * s[..., None]``.

    q: int8 codes in the cache layout [..., S, D]
    s: f32 scales [..., S] (one per position per kv-head)
    """

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):
        return self.q.shape


def is_quantized(cache) -> bool:
    return isinstance(cache, KVQ)


def kv_zeros(shape, device) -> KVQ:
    """Zeroed quantized cache: codes 0, scales 1, so never-written positions
    stay harmless."""
    return KVQ(q=torch.zeros(shape, dtype=torch.int8, device=device),
               s=torch.ones(tuple(shape[:-1]), dtype=torch.float32, device=device))


def quantize_rows(x: torch.Tensor) -> KVQ:
    """Symmetric absmax int8 over the last (head_dim) axis, in the
    reference's order of operations: s = amax / 127 (0 -> 1), codes =
    clip(round(x / s), -127, 127), with a true division and round half to
    even, so the codes are the JAX package's bit for bit. Written in few
    ops, since decode quantizes every layer's rows: the f32 absmax in one
    reduction, and x / s promotes x to f32 exactly without a cast of x."""
    amax = torch.linalg.vector_norm(x, float("inf"), dim=-1, keepdim=True,
                                    dtype=torch.float32)
    s = amax / 127.0
    safe = s.masked_fill(s == 0, 1.0)
    codes = (x / safe).round_().clamp_(-127, 127).to(torch.int8)
    return KVQ(q=codes, s=safe[..., 0])


def dequantize(cache: KVQ, dtype: torch.dtype) -> torch.Tensor:
    """codes x scale in f32, rounded to ``dtype`` (where the kernels round)."""
    return (cache.q.float() * cache.s.float()[..., None]).to(dtype)


def kv_nbytes(cache) -> int:
    """Device bytes a cache (tensor or KVQ pair) occupies; 0 for None."""
    if cache is None:
        return 0
    if is_quantized(cache):
        return kv_nbytes(cache.q) + kv_nbytes(cache.s)
    return cache.numel() * cache.element_size()


def host_kv_nbytes(leaf) -> int:
    """Host bytes of one demoted or suspended KV leaf: a tensor or ndarray,
    a KVQ pair, or the wire-normalized ``(codes, scales)`` tuple
    (serve/kv_transfer.py), the host tier's accounting unit."""
    if leaf is None:
        return 0
    if isinstance(leaf, tuple):
        return host_kv_nbytes(leaf[0]) + host_kv_nbytes(leaf[1])
    if is_quantized(leaf):
        return kv_nbytes(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)


def kv_to_host(leaf):
    """Copy a pool read (a tensor or a KVQ pair) to host memory: a CPU
    tensor, or a ``(codes, scales)`` tuple of CPU tensors, the layout the
    host tier and the KVX1 wire format keep."""
    if is_quantized(leaf):
        return (leaf.q.cpu(), leaf.s.cpu())
    return leaf.cpu()


def kv_from_host(leaf, device):
    """The inverse of ``kv_to_host`` for a pool write: a host tensor or
    ndarray (or a ``(codes, scales)`` pair of them) on ``device``, as the
    row ``kv_pool_write_row`` takes."""
    if isinstance(leaf, tuple):
        return KVQ(q=_host_tensor(leaf[0]).to(device), s=_host_tensor(leaf[1]).to(device))
    return _host_tensor(leaf).to(device)


def _host_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    import numpy as np

    return torch.from_numpy(np.array(x))  # a writable copy of a wire buffer


def kv_pool_zeros(shape, dtype: torch.dtype, device, quant: bool = False):
    """A zeroed pool leaf-set [NB, L, Hkv, T, D]: a tensor, or a KVQ pair."""
    if quant:
        return kv_zeros(shape, device)
    return torch.zeros(shape, dtype=dtype, device=device)


def kv_update_slice(cache, rows: torch.Tensor, layer: int, starts: list[int]):
    """Write fresh rows [B, Hkv, t, D] into cache[b, layer, :, starts[b]:+t]
    (in place; the rows are quantized on write under KVQ)."""
    if is_quantized(cache):
        rq = quantize_rows(rows)
        kv_update_slice(cache.q, rq.q, layer, starts)
        kv_update_slice(cache.s, rq.s, layer, starts)
        return cache
    t = rows.shape[2]
    rows = rows.to(cache.dtype)
    if all(s == starts[0] for s in starts):
        cache[:, layer, :, starts[0]:starts[0] + t] = rows
    else:
        for i, s0 in enumerate(starts):
            cache[i, layer, :, s0:s0 + t] = rows[i]
    return cache


def kv_pool_write_row(pool, row, bids: torch.Tensor):
    """Write one prefilled row cache into the pool's blocks ``bids`` (in
    place). row: [1, L, H, S', D] (already quantized under KVQ); bids:
    [nblk] int. S' <= T writes a partial leading block; otherwise S' must be
    a multiple of T and block i of the row goes to ``bids[i]``. Entries
    equal to 0 (the null block) stand for blocks that must not be written
    (a slot's shared prefix blocks, a group's pad rows, the junk tail past
    the prompt): no real block is written for them (leading and trailing
    ones are skipped, and block 0 is junk by the pool's contract)."""
    if is_quantized(pool):
        kv_pool_write_row(pool.q, row.q, bids)
        kv_pool_write_row(pool.s, row.s, bids)
        return pool
    t = pool.shape[3]
    s = row.shape[3]
    if s <= t:
        if int(bids[0]) != 0:
            pool[int(bids[0]), :, :, :s] = row[0].to(pool.dtype)
        return pool
    if s % t:
        raise ValueError(f"row length {s} not a multiple of block size {t}")
    blk = row[0].reshape(row.shape[1:3] + (s // t, t) + row.shape[4:])
    blk = blk.movedim(2, 0)  # [nblk, L, H, T, ...], a view of the row
    bids = bids.to(dtype=torch.long)
    live = (bids != 0).nonzero().flatten()  # host bids: no device sync
    if live.numel():
        # the blocks from the first to the last live entry, written from a
        # view of the row: a gathered copy would be one leaf of a whole row
        # at max_seq (~270 MB at Llama-3-8B widths) on top of the admit's
        # row caches. A null entry inside the run writes block 0.
        k0, k1 = int(live[0]), int(live[-1]) + 1
        pool[bids[k0:k1].to(pool.device)] = blk[k0:k1].to(pool.dtype)
    return pool


def kv_copy_slice(dst, src, idx):
    """Write an already-quantized block (a row-cache slice, or blocks read
    from the pool) into a larger cache at ``idx`` (codes-layout start
    indices, one per axis; the scales drop the trailing D index), in
    place."""
    if is_quantized(dst):
        kv_copy_slice(dst.q, src.q, idx)
        kv_copy_slice(dst.s, src.s, idx[:-1])
        return dst
    window = tuple(slice(i, i + n) for i, n in zip(idx, src.shape))
    dst[window] = src.to(dst.dtype)
    return dst


def kv_pool_copy_block(pool, dst: int, src: int):
    """Copy-on-write: duplicate block ``src`` into block ``dst`` (in
    place)."""
    if is_quantized(pool):
        kv_pool_copy_block(pool.q, dst, src)
        kv_pool_copy_block(pool.s, dst, src)
        return pool
    pool[dst] = pool[src]
    return pool


def kv_pool_read_blocks(pool, bids: torch.Tensor):
    """Gather blocks ``bids`` [nblk] into a [1, L, H, nblk*T, D]
    row-cache-shaped chunk (per leaf on a KVQ; a copy, the pool is only
    read): a partial prefix hit seeds its transient row cache from it."""
    if is_quantized(pool):
        return KVQ(q=kv_pool_read_blocks(pool.q, bids), s=kv_pool_read_blocks(pool.s, bids))
    v = pool[bids.to(device=pool.device, dtype=torch.long)]  # [nblk, L, H, T, ...]
    v = v.movedim(0, 2)  # [L, H, nblk, T, ...]
    return v.reshape(v.shape[:2] + (v.shape[2] * v.shape[3],) + v.shape[4:])[None]


def kv_pool_row_index(tbl: torch.Tensor, pos: torch.Tensor, w: int,
                      t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(block ids, offsets in block) [B, W] of positions pos..pos+W-1 of
    every slot. Positions past the table resolve to its last entry, and
    unallocated entries to the null block, as in the JAX op. Every layer of
    a decode step shares it, so callers compute it once per step."""
    offs = pos.long()[:, None] + torch.arange(w, device=pos.device)[None, :]
    vb = torch.clamp(offs // t, 0, tbl.shape[1] - 1)
    return torch.gather(tbl.long(), 1, vb), offs % t


def kv_pool_write_rows(pool, rows: torch.Tensor, tbl: torch.Tensor,
                       pos: torch.Tensor, layer: int, index=None):
    """Scatter W fresh [Hkv, D] rows per slot into the pool at the slot's
    positions pos..pos+W-1 of ``layer`` (in place; write-then-attend for
    the paged-decode kernel). rows: [B, W, Hkv, D] raw activations,
    quantized on write under KVQ; tbl: [B, NB]; pos: [B]; ``index``: a
    precomputed ``kv_pool_row_index`` of (tbl, pos)."""
    if index is None:
        index = kv_pool_row_index(tbl, pos, rows.shape[1], pool.shape[3])
    bids, off = index
    if is_quantized(pool):
        rq = quantize_rows(rows)
        pool.q[bids, layer, :, off] = rq.q
        pool.s[bids, layer, :, off] = rq.s
        return pool
    pool[bids, layer, :, off] = rows.to(pool.dtype)
    return pool
