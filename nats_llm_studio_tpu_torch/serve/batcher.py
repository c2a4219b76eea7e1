"""Continuous batcher, paged-KV core: concurrent requests share one
fixed-width decode step over one refcounted block pool.

Port of the paged core of ``nats_llm_studio_tpu/serve/batcher.py``
``ContinuousBatcher``: the same surface the engine calls (``submit``,
``submit_batched``, ``start``, ``stop``, ``idle``, ``pool_stats``,
``drop_prefix_cache``), the same program names in ``stats.program_ms`` and
the same admit regimes:

* a prompt of at most one serving chunk prefills fresh (K2) into a
  bucket-length transient row, whose blocks are written into the pool
  (``admit_fused_paged``); a burst of such prompts of one bucket prefills
  as one [m, bucket] batch (``admit_many_fused_paged``);
* a longer prompt into an idle batcher prefills in one fresh dispatch
  (``prefill_full``, K2) and a longer prompt beside live slots prefills in
  serving chunks (``prefill1``, K2 for the first chunk and K3 after),
  with one decode burst between chunks so live streams keep flowing; both
  end in ``finish_admit_paged``. A run of long prompts prefills as [m, C]
  chunks (``prefill_chunk_group``, ``select_end``) and ends in one
  ``finish_admit_group_paged``;
* with ``prefix_cache_blocks`` > 0 the prompt's full serving chunks stay
  in the pool after the admit, held by a radix cache of block ids
  (``serve/prefix_cache.py``). A later prompt that starts with them takes
  the cached blocks into its table by refcount: a full hit samples its
  first token from the stored chunk-end logits (``sample_first``) with no
  prefill; a partial hit copies the cached chunks into its transient row
  (``fill_row_chunk``) and prefills only the suffix. The shared blocks are
  never written: ``finish_admit_paged`` skips them, and a decode write
  into a block that is still shared copies it first (``pool_copy_block``);
* decode runs bursts of single-token ``forward_decode_paged`` steps (K1)
  plus ``sample_rows`` (``decode_pos_pallas``), with each slot's block
  table grown ahead of the burst;
* with ``spec_decode_k`` > 0 and 1..``spec_max_active`` live slots, decode
  verifies prompt-lookup drafts instead (``serve/spec.py``): one
  ``forward_decode_paged`` of width k+1 (K1 with W = k+1 query rows a
  slot) and ``spec_accept_rows`` (``spec_verify_pallas``), emitting up to
  k+1 tokens a slot a dispatch. Rejected drafts' pool rows are stale by
  position and are overwritten by the slot's next writes;
* while a constrained (``response_format``) or logprob request is live,
  every slot decodes one masked step a dispatch (``decode_pos_pallas_ext``):
  the mask of a constrained row comes from its ``TokenDFA`` state
  (``serve/constrain.py``), advanced on the host at readback, and each step
  reads back the chosen token's logprob and the top ``LOGPROBS_K``. Such a
  request's admit drops its first token and steps back one position, so
  token 0 is sampled under the mask too (the rewind).

Under ``cfg.kv_quant == "int8"`` the pool and the transient row caches are
KVQ pairs (int8 codes + f32 scales): rows are quantized as they are
written, later chunks run K4 instead of K3, decode runs K1q, and cached
blocks hold the codes a prefill wrote.

One owner thread drives the device; asyncio callers talk to it through
thread-safe queues. PyTorch runs eagerly, so a burst is a Python loop of
steps (the reference scans them on device); kernel launches queue on the
current stream in program order, and the host reads tokens back one burst
behind.

Not ported yet: KV tiers (prefix demotion and promotion), slot suspend
and parking, QoS and brownout, deadline propagation, the device-time
ledger and the legacy contiguous-KV layout.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import queue as _queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import AsyncIterator

import numpy as np
import torch

from ..device import torch_dtype
from ..engine.generator import SamplingParams, default_buckets
from ..engine.sampling import logprob_rows, sample_rows, spec_accept_rows
from ..models.config import ModelConfig
from ..models.llama import (
    ensure_lm_head,
    forward,
    forward_decode_paged,
    make_cache,
)
from ..obs import LogHistogram
from ..obs import emit as obs_emit
from ..ops.kvcache import (
    KVQ,
    is_quantized,
    kv_copy_slice,
    kv_nbytes,
    kv_pool_copy_block,
    kv_pool_read_blocks,
    kv_pool_write_row,
    kv_pool_zeros,
)
from ..parallel.memory import KV_BLOCK_TOKENS, PREFILL_CHUNK, serving_geometry
from .block_pool import BlockPool
from .prefix_cache import PrefixCache
from .spec import SpecConfig, SpecSlot, make_slot

log = logging.getLogger(__name__)

# placeholder for a slot whose admit is in progress: decode steps during a
# chunked admit must neither deliver tokens for it nor hand it to another
# admit
_RESERVED = object()

# how many top-logprob (id, logprob) pairs the ext program reads back a
# step; OpenAI caps top_logprobs requests below this
LOGPROBS_K = 8


class BatcherStopped(RuntimeError):
    """Submit raced a shutdown; the request was never queued."""


class BatcherOverloaded(RuntimeError):
    """The request cannot be served here now; retry on another worker."""


class _PoolExhausted(BatcherOverloaded):
    """The block pool ran dry. Raised before any device write, so only the
    one request is shed."""


@dataclass
class _Request:
    prompt_ids: list[int]
    sp: SamplingParams
    loop: asyncio.AbstractEventLoop
    out: asyncio.Queue  # (kind, value): ("tok", id) | ("end", reason) | ("err", exc)
    slot: int = -1
    pos: int = 0
    generated: int = 0
    t_enq: float = 0.0
    cancelled: bool = False
    # -- the ext regime: a TokenDFA when response_format asks for schema-
    # constrained output, with its current state (advanced on the host at
    # readback; the device sees only the state's vocab mask), and the
    # logprob readback
    constrain: object | None = None
    cstate: int = 0
    want_logprobs: bool = False
    top_logprobs: int = 0
    # the rewind: an ext admit drops its first token, steps back one
    # position and re-runs prompt[-1] through the masked ext program
    rewound: bool = False
    # token ids delivered to the consumer, in order
    emitted: list = field(default_factory=list)

    @property
    def is_ext(self) -> bool:
        return self.constrain is not None or self.want_logprobs

    def emit(self, kind: str, value) -> None:
        self.loop.call_soon_threadsafe(self.out.put_nowait, (kind, value))


@dataclass
class BatcherStats:
    requests: int = 0
    tokens: int = 0
    steps: int = 0
    peak_active: int = 0
    cancelled: int = 0
    shed: int = 0
    # requests admitted through a batched short / batched chunked admit
    grouped_admits: int = 0
    chunked_group_admits: int = 0
    # speculative decoding: verify dispatches, draft tokens sent to them and
    # drafts the model's own distribution kept; the per-verify accepted
    # share (0 clamped to the bottom bucket) and its moving average
    spec_verifies: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_accept_rate: LogHistogram = field(
        default_factory=lambda: LogHistogram(lo=0.01, hi=1.0, growth=1.25))
    spec_accept_ewma: float = 0.0
    # per-program host dispatch time (ms) and dispatch counts, keyed by the
    # reference's program names
    program_ms: dict = field(default_factory=dict)
    program_calls: dict = field(default_factory=dict)

    def record_program(self, name: str, ms: float) -> None:
        self.program_ms[name] = self.program_ms.get(name, 0.0) + ms
        self.program_calls[name] = self.program_calls.get(name, 0) + 1

    def spec_counters(self) -> dict[str, int]:
        """Speculative-decoding counters (the reference's
        ``lmstudio_spec_*_total`` families)."""
        return {
            "verifies": self.spec_verifies,
            "drafted": self.spec_drafted,
            "accepted": self.spec_accepted,
        }

    def record_spec(self, drafted: int, accepted: int) -> None:
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        rate = accepted / drafted
        self.spec_accept_rate.record(max(rate, 0.01))
        prev = self.spec_accept_ewma
        self.spec_accept_ewma = rate if prev == 0.0 else 0.8 * prev + 0.2 * rate

    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "tokens": self.tokens,
            "steps": self.steps,
            "peak_active": self.peak_active,
            "cancelled": self.cancelled,
            "shed": self.shed,
            "grouped_admits": self.grouped_admits,
            "chunked_group_admits": self.chunked_group_admits,
            "spec_verifies": self.spec_verifies,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_accept_ewma": round(self.spec_accept_ewma, 3),
            "program_calls": dict(self.program_calls),
            "program_ms": {k: round(v, 3) for k, v in self.program_ms.items()},
        }


def _row(cache, i: int):
    """Row i of a batched row cache as a [1, ...] view (per leaf on KVQ)."""
    if is_quantized(cache):
        return KVQ(cache.q[i:i + 1], cache.s[i:i + 1])
    return cache[i:i + 1]


class ContinuousBatcher:
    """Owns the device loop for one loaded model.

    The constructor takes the reference's names and defaults:
    ``prefill_chunk`` (256, halved until it divides max_seq; the class
    attribute ``PREFILL_CHUNK`` when not given), ``decode_burst`` (8),
    ``admit_coalesce_ms`` (3.0: how long an idle batcher waits after a first
    arrival for more, so a burst admits as one batch), ``max_group_admit``
    (8 short prompts a batched admit), ``max_group_long`` (4 long prompts a
    batched chunked admit), ``prefix_cache_blocks`` (0 = no prefix cache;
    the registry passes 64), ``kv_pool_blocks`` (0 = every slot at
    max_seq plus the prefix budget), ``spec_decode_k`` (0 = no speculative
    decoding; the registry passes 6) and ``spec_max_active`` (4: verify
    dispatches run at 1..4 live slots)."""

    # the reference's serving defaults: 256-token prefill chunks, decode
    # bursts of 8 steps, 16-token KV blocks
    PREFILL_CHUNK = PREFILL_CHUNK
    DECODE_BURST = 8
    KV_BLOCK_TOKENS = KV_BLOCK_TOKENS

    def __init__(self, params, cfg: ModelConfig, max_slots: int = 8,
                 max_seq_len: int | None = None, prefill_chunk: int | None = None,
                 decode_burst: int | None = None, admit_coalesce_ms: float = 3.0,
                 max_group_admit: int = 8, max_group_long: int = 4,
                 prefix_cache_blocks: int = 0, kv_pool_blocks: int = 0,
                 spec_decode_k: int = 0, spec_max_active: int = 4):
        self.params = ensure_lm_head(params)
        self.cfg = cfg
        self.device = self.params["embed"].device
        self.max_slots = max_slots
        self.max_seq = min(max_seq_len or cfg.max_seq_len, cfg.max_seq_len)
        self.buckets = default_buckets(self.max_seq)
        # the serving chunk divides max_seq, so the zero-padded last chunk
        # never writes past the row cache; the block size divides the chunk,
        # so a cached chunk is whole blocks
        chunk = max(8, prefill_chunk if prefill_chunk is not None else self.PREFILL_CHUNK)
        self.prefill_chunk, T = serving_geometry(self.max_seq, chunk, self.KV_BLOCK_TOKENS)
        if self.max_seq % self.prefill_chunk:
            raise ValueError(
                f"max_seq_len={self.max_seq} must be divisible by a prefill "
                f"chunk >= 8; use a power-of-two max_seq_len"
            )
        self.decode_burst = max(1, decode_burst if decode_burst is not None
                                else self.DECODE_BURST)
        self.admit_coalesce_ms = max(0.0, admit_coalesce_ms)
        self.max_group_admit = max(1, max_group_admit)
        self.max_group_long = max(1, max_group_long)
        self.kv_block_tokens = T
        self.blocks_per_row = self.max_seq // T
        # every slot at max_seq plus the prefix budget, +1 for the null
        # block 0 (parallel/memory.py estimate_load_bytes prices this pool)
        usable = (kv_pool_blocks if kv_pool_blocks > 0
                  else max_slots * self.blocks_per_row + max(0, prefix_cache_blocks))
        self._pool = BlockPool(usable + 1, T)
        # the pool pair [NB, L, Hkv, T, D], written in place by every program
        self._kv = self._new_kv_pool()
        self.stats = BatcherStats()
        self.spec_cfg: SpecConfig | None = (
            SpecConfig(k=spec_decode_k, max_active=max(1, spec_max_active))
            if spec_decode_k > 0 else None)
        # the prefix cache's nodes hold (pool epoch, block ids) payloads: a
        # harvest is an incref, an eviction a decref, and payloads minted
        # before a pool reset free as no-ops
        self.prefix_cache: PrefixCache | None = None
        if prefix_cache_blocks > 0:
            pool = self._pool

            def _pc_acquire(payload):
                ep, ids = payload
                if ep == pool.epoch:
                    pool.incref(ids)

            def _pc_release(payload):
                ep, ids = payload
                pool.decref(ids, epoch=ep)

            self.prefix_cache = PrefixCache(
                self.prefill_chunk, prefix_cache_blocks,
                node_blocks=self.prefill_chunk // T,
                acquire_fn=_pc_acquire, free_fn=_pc_release,
            )

        self._admit_fused_paged = self._timed("admit_fused_paged", self._admit_fused_paged_fn)
        self._admit_many_fused_paged = self._timed("admit_many_fused_paged",
                                                   self._admit_many_fused_paged_fn)
        self._prefill_full = self._timed("prefill_full", self._prefill_full_fn)
        self._prefill1 = self._timed("prefill1", self._prefill1_fn)
        self._prefill_chunk_group = self._timed("prefill_chunk_group",
                                                self._prefill_chunk_group_fn)
        self._select_end = self._timed("select_end", self._select_end_fn)
        self._finish_admit_paged = self._timed("finish_admit_paged", self._finish_admit_paged_fn)
        self._finish_admit_group_paged = self._timed("finish_admit_group_paged",
                                                     self._finish_admit_group_paged_fn)
        self._sample_first = self._timed("sample_first", self._sample_first_fn)
        self._fill_row_chunk = self._timed("fill_row_chunk", self._fill_row_chunk_fn)
        self._pool_copy_block = self._timed("pool_copy_block", self._pool_copy_block_fn)
        self._decode_pos_pallas = self._timed("decode_pos_pallas", self._decode_pos_pallas_fn)
        self._decode_pos_pallas_ext = self._timed("decode_pos_pallas_ext",
                                                  self._decode_pos_pallas_ext_fn)
        self._spec_verify_pallas = self._timed("spec_verify_pallas",
                                               self._spec_verify_pallas_fn)

        self._inbox: _queue.Queue = _queue.Queue()
        self._cancels: _queue.Queue = _queue.Queue()
        self._slots: list = [None] * max_slots
        self._submit_lock = threading.Lock()
        self._stopping = False
        self._started = False
        self._thread: threading.Thread | None = None
        self._wl_len = 0
        self._waitlist: list[_Request] = []
        self.crashed: BaseException | None = None

    # -- programs ----------------------------------------------------------

    def _sample_token0(self, logits, seeds, samps):
        """Token 0 of m admits from their prompt-end logits [m, 1, V]: rng
        step 0 of each row's seed."""
        temps, topks, topps = samps
        return sample_rows(logits[:, 0], seeds, [0] * len(seeds), temps, topks, topps)

    def _sample_first_fn(self, logits, seed, samp):
        """Full-prefix-hit admit: no prefill and no KV copy (the slot's
        table already references the cached blocks); token 0 from the
        stored prompt-end logits."""
        temp, topk, topp = samp
        return self._sample_token0(logits, [seed], ([temp], [topk], [topp]))

    def _admit_fused_paged_fn(self, KP, VP, tokens, n, bids, seed, samp):
        """Short-prompt admit: prefill a bucket-length transient row (K2),
        write its blocks into the pool at ``bids`` (null-padded), sample
        token 0."""
        k1, v1 = make_cache(self.cfg, 1, tokens.shape[1], device=self.device)
        logits, k1, v1 = forward(
            self.params, self.cfg, tokens, k1, v1,
            start_pos=torch.zeros((1,), dtype=torch.int32),
            logit_positions=torch.tensor([n - 1]), fresh_prefill=True,
        )
        kv_pool_write_row(KP, k1, bids)
        kv_pool_write_row(VP, v1, bids)
        return self._sample_first_fn(logits, seed, samp)

    def _admit_many_fused_paged_fn(self, KP, VP, tokens, ns, bid_rows, seeds, samps):
        """Batched short admit: one [m, bucket] fresh prefill (K2), then
        each row's blocks into its own table entries. Pad rows repeat row 0
        with all-null bids, so they write nothing the pool keeps."""
        m, bucket = tokens.shape
        km, vm = make_cache(self.cfg, m, bucket, device=self.device)
        logits, km, vm = forward(
            self.params, self.cfg, tokens, km, vm,
            start_pos=torch.zeros((m,), dtype=torch.int32),
            logit_positions=torch.tensor([n - 1 for n in ns]), fresh_prefill=True,
        )
        for i in range(m):
            kv_pool_write_row(KP, _row(km, i), bid_rows[i])
            kv_pool_write_row(VP, _row(vm, i), bid_rows[i])
        return self._sample_token0(logits, seeds, samps)

    def _prefill_full_fn(self, tokens, k1, v1, n):
        """A whole long prompt in one fresh dispatch (idle batcher)."""
        logits, k1, v1 = forward(
            self.params, self.cfg, tokens, k1, v1,
            start_pos=torch.zeros((1,), dtype=torch.int32),
            logit_positions=torch.tensor([n - 1]), fresh_prefill=True,
        )
        return logits

    def _prefill1_fn(self, tokens, k1, v1, start, last_pos, window):
        """One [1, C] chunk at ``start``: K2 when start is 0, K3 over the
        cache window after."""
        logits, k1, v1 = forward(
            self.params, self.cfg, tokens, k1, v1,
            start_pos=torch.tensor([start], dtype=torch.int32),
            logit_positions=torch.tensor([last_pos]), uniform_start=True,
            attn_window=window,
        )
        return logits

    def _prefill_chunk_group_fn(self, tokens, km, vm, start, last_pos, window):
        """One [m, C] chunk of a batched chunked admit, every row at
        ``start`` (K2 at 0, K3/K4 over the rows' cache window after); the
        logits row of each prompt at ``last_pos``."""
        m = tokens.shape[0]
        logits, km, vm = forward(
            self.params, self.cfg, tokens, km, vm,
            start_pos=torch.full((m,), start, dtype=torch.int32),
            logit_positions=torch.tensor(last_pos), uniform_start=True,
            attn_window=window,
        )
        return logits

    def _select_end_fn(self, final, logits, is_end):
        """Keep each row's logits from the chunk its prompt ends in."""
        return torch.where(is_end[:, None, None], logits, final)

    def _finish_admit_paged_fn(self, KP, VP, k1, v1, logits, bids, seed, samp):
        """Long-prompt tail: write the row's blocks into the pool (null
        entries — shared prefix blocks and the junk tail — skipped) and
        sample token 0."""
        kv_pool_write_row(KP, k1, bids)
        kv_pool_write_row(VP, v1, bids)
        return self._sample_first_fn(logits, seed, samp)

    def _finish_admit_group_paged_fn(self, KP, VP, km, vm, final, bid_rows, seeds, samps):
        """Batched chunked tail: each row's blocks into its table entries
        (pad rows carry all-null bids) and token 0 of every row."""
        for i in range(final.shape[0]):
            kv_pool_write_row(KP, _row(km, i), bid_rows[i])
            kv_pool_write_row(VP, _row(vm, i), bid_rows[i])
        return self._sample_token0(final, seeds, samps)

    def _fill_row_chunk_fn(self, k1, v1, KP, VP, bids, start):
        """Copy one cached chunk's pool blocks ``bids`` into the transient
        row at ``start`` (partial-prefix-hit admit), where a chunked
        prefill would have written them; the pool is only read. Queued on
        the stream before the suffix chunks that read the row."""
        idx = (0, 0, 0, start, 0)
        kv_copy_slice(k1, kv_pool_read_blocks(KP, bids), idx)
        kv_copy_slice(v1, kv_pool_read_blocks(VP, bids), idx)

    def _pool_copy_block_fn(self, KP, VP, dst, src):
        """Copy-on-write: duplicate one shared block before a write."""
        kv_pool_copy_block(KP, dst, src)
        kv_pool_copy_block(VP, dst, src)

    def _decode_pos_pallas_fn(self, tok, KP, VP, tbl, pos, seeds, steps, temp, topk,
                              topp, n):
        """Decode burst: n single-token paged forwards (K1), each sampled;
        the next token stays on the device. Returns (tokens [B, n], tok)."""
        out = []
        for i in range(n):
            logits, KP, VP = forward_decode_paged(
                self.params, self.cfg, tok[:, None], KP, VP, tbl, pos + i,
            )
            tok = sample_rows(logits[:, -1, :], seeds, [s + i for s in steps],
                              temp, topk, topp)
            out.append(tok)
        return torch.stack(out, dim=1), tok

    def _decode_pos_pallas_ext_fn(self, tok, KP, VP, tbl, pos, seeds, steps, temp, topk,
                                  topp, mask):
        """One masked single-token step (K1) with the logprob readback.
        Returns (tokens [B], chosen logprobs [B], top ids [B, LOGPROBS_K],
        top logprobs [B, LOGPROBS_K]); the tokens are the next carry."""
        logits, KP, VP = forward_decode_paged(
            self.params, self.cfg, tok[:, None], KP, VP, tbl, pos,
        )
        raw = logits[:, -1, :]
        nxt = sample_rows(raw, seeds, steps, temp, topk, topp, mask=mask)
        lp, top_ids, top_lp = logprob_rows(raw, nxt, LOGPROBS_K)
        return nxt, lp, top_ids, top_lp

    def _spec_verify_pallas_fn(self, tok, KP, VP, tbl, pos, drafts, dlen, seeds, steps,
                               temp, topk, topp):
        """Verify: the carry token and the k drafts as one width-(k+1)
        paged forward (K1 with W = k+1 query rows a slot), then the
        acceptance rule (``dlen``: each row's valid drafts, a host list like
        the seeds, steps and sampling settings). Returns (tokens [B, k+1],
        n_emit [B], the next carry [B]); row b's next position is
        pos + n_emit."""
        toks_in = torch.cat([tok[:, None], drafts], dim=1)
        logits, KP, VP = forward_decode_paged(
            self.params, self.cfg, toks_in, KP, VP, tbl, pos,
        )
        out, n_emit = spec_accept_rows(logits, drafts, dlen, seeds, steps, temp, topk, topp)
        new_tok = torch.gather(out, 1, (n_emit.long() - 1)[:, None])[:, 0]
        return out, n_emit, new_tok

    def _timed(self, name: str, fn):
        """Record every dispatch's host time under the program ``name``."""
        stats = self.stats

        def run(*args, **kwargs):
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            stats.record_program(name, (time.monotonic() - t0) * 1e3)
            return out

        run.__name__ = f"timed_{name}"
        return run

    # -- block ownership (owner thread) --------------------------------------

    def _alloc_blocks(self, k: int) -> list[int]:
        """Take k fresh pool blocks; on shortage, reclaim unpinned
        prefix-cache blocks (the evictable tier) first. Raises
        _PoolExhausted, before any device write, when that is not enough."""
        pool, pc = self._pool, self.prefix_cache
        got = pool.alloc(k)
        if got is None and pc is not None:
            pc.reclaim(k - pool.free_blocks)
            got = pool.alloc(k)
        if got is None:
            self.stats.shed += 1
            raise _PoolExhausted(
                f"kv block pool exhausted ({k} blocks needed, "
                f"{pool.free_blocks} free) (shed_cause=kv_pool); "
                f"retry on another worker"
            )
        return got

    def _ensure_private(self, tbl: list[int], lo: int, hi: int) -> int:
        """Copy-on-write: every block of ``tbl`` that a write to positions
        [lo, hi) would touch and that is still shared (refcount > 1) is
        copied into a fresh block, which replaces it in ``tbl``. Returns
        the number of copies. Chunk-aligned sharing means decode writes
        start past every shared block, so this almost never copies; it
        keeps correctness independent of that layout argument."""
        if not tbl or hi <= lo:
            return 0
        pool, T = self._pool, self.kv_block_tokens
        KP, VP = self._kv
        copies = 0
        for b in range(lo // T, min((min(hi, self.max_seq) - 1) // T, len(tbl) - 1) + 1):
            bid = tbl[b]
            if bid != 0 and pool.refcount(bid) > 1:
                nid = self._alloc_blocks(1)[0]
                self._pool_copy_block(KP, VP, nid, bid)
                pool.decref([bid])
                pool.cow_copies += 1
                tbl[b] = nid
                copies += 1
        return copies

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._started or self._stopping:
            return
        self._started = True
        self._thread = threading.Thread(target=self._run_guarded, name="batcher",
                                        daemon=True)
        self._thread.start()

    def _run_guarded(self) -> None:
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 — fail waiters, record the crash
            log.exception("batcher pump loop crashed")
            self.crashed = e
            self._stopping = True
            for r in list(self._waitlist) + [s for s in self._slots if isinstance(s, _Request)]:
                r.emit("err", BatcherStopped(f"batcher crashed ({e}); retry on another worker"))
            self._drain_all("shutdown")

    @property
    def alive(self) -> bool:
        return self.crashed is None and self._thread is not None and self._thread.is_alive()

    def stop(self) -> None:
        """End the owner thread and every request ("shutdown"), then drop
        the device tensors (params, the K/V pool and the prefix cache's
        logits rows), so their memory goes back to the allocator even while
        something still holds this batcher or its engine."""
        with self._submit_lock:
            running = self._started and not self._stopping
            self._stopping = True
            if running:
                self._inbox.put(None)
        if running:
            self._thread.join(timeout=30.0)
            self._drain_all("shutdown")
        if self._thread is not None and self._thread.is_alive():
            log.warning("batcher thread still running after stop; its device "
                        "tensors stay allocated")
            return
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        self.params = None
        self._kv = None

    @property
    def idle(self) -> bool:
        """Nothing served or queued (approximate; any thread)."""
        return (
            not any(s is not None for s in self._slots)
            and self._inbox.qsize() == 0
            and self._wl_len == 0
        )

    def _new_kv_pool(self) -> tuple:
        cfg = self.cfg
        shape = (self._pool.n_blocks, cfg.n_layers, cfg.n_kv_heads, self.kv_block_tokens,
                 cfg.head_dim)
        return tuple(kv_pool_zeros(shape, torch_dtype(cfg.dtype), self.device,
                                   quant=cfg.kv_quant == "int8") for _ in range(2))

    def pool_stats(self) -> dict:
        """Block counters (``cow_copies`` among them), the KV mode and the
        device bytes of the K and V pools (0 once stopped)."""
        kv = self._kv or (None, None)
        return {**self._pool.stats(), "kv_quant": self.cfg.kv_quant,
                "bytes": kv_nbytes(kv[0]) + kv_nbytes(kv[1])}

    def drop_prefix_cache(self) -> int:
        """Evict every cached prefix block and zero the budget (the
        registry's memory-pressure tier). Safe from any thread: blocks
        pinned by an admit in flight are detached now and freed when that
        admit releases them. Returns the number of blocks evicted."""
        pc = self.prefix_cache
        return pc.resize(0) if pc is not None else 0

    # -- submission ----------------------------------------------------------

    def _enqueue(self, prompt_ids: list[int], sp: SamplingParams, constrain=None,
                 want_logprobs: bool = False, top_logprobs: int = 0) -> _Request:
        if not prompt_ids:
            raise ValueError("empty prompt")
        if len(prompt_ids) >= self.max_seq:
            raise ValueError(f"prompt of {len(prompt_ids)} tokens >= max_seq {self.max_seq}")
        req = _Request(
            prompt_ids=list(prompt_ids), sp=sp, loop=asyncio.get_running_loop(),
            out=asyncio.Queue(), t_enq=time.monotonic(), constrain=constrain,
            cstate=constrain.start if constrain is not None else 0,
            want_logprobs=bool(want_logprobs), top_logprobs=int(top_logprobs),
        )
        with self._submit_lock:
            if self._stopping:
                raise BatcherStopped("batcher is stopped; retry on another worker")
            self._inbox.put(req)
        return req

    def cancel(self, req: _Request) -> None:
        req.cancelled = True
        self._cancels.put(req)

    async def submit(self, prompt_ids: list[int], sp: SamplingParams,
                     info: dict | None = None, constrain=None, want_logprobs: bool = False,
                     top_logprobs: int = 0) -> AsyncIterator[int]:
        """Yield generated token ids for one request; ``info`` receives the
        end reason ("stop" / "length" / "shutdown") as ``finish_reason``.
        See ``submit_batched`` for the ext options."""
        async for batch in self.submit_batched(prompt_ids, sp, info=info, constrain=constrain,
                                               want_logprobs=want_logprobs,
                                               top_logprobs=top_logprobs):
            for tok in batch:
                yield tok

    async def submit_batched(self, prompt_ids: list[int], sp: SamplingParams,
                             info: dict | None = None, constrain=None,
                             want_logprobs: bool = False,
                             top_logprobs: int = 0) -> AsyncIterator[list]:
        """Like ``submit`` but yields lists: everything delivered since the
        consumer last woke (a decode burst) comes out as one batch.

        ``constrain`` is a ``serve/constrain.py`` TokenDFA (schema-constrained
        decoding); with ``want_logprobs`` each item is a ``(tok, logprob,
        top_ids, top_logprobs)`` tuple instead of a bare id. Either option
        routes the request through the masked single-step ext program."""
        if not self._started:
            self.start()
        if not prompt_ids:
            return
        req = self._enqueue(prompt_ids, sp, constrain=constrain, want_logprobs=want_logprobs,
                            top_logprobs=top_logprobs)
        done = False
        try:
            while True:
                kind, value = await req.out.get()
                batch: list[int] = []
                while True:
                    if kind == "tok":
                        batch.append(value)
                    elif kind == "end":
                        done = True
                        if batch:
                            yield batch
                        if info is not None:
                            info["finish_reason"] = value
                        return
                    else:
                        done = True
                        if batch:
                            yield batch
                        raise value
                    try:
                        kind, value = req.out.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                yield batch
        finally:
            if not done:  # consumer left early: free the slot
                self.cancel(req)

    # -- device loop (owner thread) ------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_seq

    def _win_bucket(self, n: int) -> int:
        """Power-of-two attention window >= n, clamped to max_seq: a chunk
        reads only the live prefix of the row cache."""
        w = 1 << max(0, n - 1).bit_length()
        return min(w, self.max_seq)

    def _run(self) -> None:
        cfg = self.cfg
        B = self.max_slots
        C = self.prefill_chunk
        pool = self._pool
        pc = self.prefix_cache
        T = self.kv_block_tokens
        MB = self.blocks_per_row
        dev = self.device
        KP, VP = self._kv
        coalesce_s = self.admit_coalesce_ms / 1e3
        spec = self.spec_cfg
        # each live slot's n-gram index over prompt + delivered tokens,
        # made at its admit's readback and dropped with the slot
        spec_slots: list[SpecSlot | None] = [None] * B
        tables: list[list[int]] = [[] for _ in range(B)]
        tbl_dev = torch.zeros((B, MB), dtype=torch.int32, device=dev)
        table_dirty = False
        # device-resident next-token carry: burst k+1 starts from burst k's
        # last sampled token without a readback
        tok_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        # host counters, advanced at dispatch time
        host_pos = [0] * B
        host_steps = [0] * B
        host_seed = [0] * B
        # dispatches not read back yet: ("decode", toks, n, rows) |
        # ("spec", toks, n_emit, [(slot, req, drafted), ...]) |
        # ("ext", toks, logprobs, top_ids, top_logprobs, rows) |
        # ("admit", firsts, [(row in firsts, slot, req), ...])
        inflight: collections.deque = collections.deque()
        waitlist = self._waitlist
        alloc_blocks = self._alloc_blocks

        def ensure_blocks(i: int, upto: int) -> None:
            nonlocal table_dirty
            need = min(-(-min(upto, self.max_seq) // T), MB)
            if len(tables[i]) < need:
                tables[i].extend(alloc_blocks(need - len(tables[i])))
                table_dirty = True

        def ensure_private(i: int, lo: int, hi: int) -> None:
            nonlocal table_dirty
            if self._ensure_private(tables[i], lo, hi):
                table_dirty = True

        def refresh_tables() -> None:
            """Mirror the live slots' tables to the device. A reserved or
            empty slot gets a null row: the decode step computes its row as
            junk, and that junk must land in the null block, never in the
            shared prefix blocks a partial-hit admit has already put in its
            table."""
            nonlocal tbl_dev, table_dirty
            if not table_dirty:
                return
            arr = torch.zeros((B, MB), dtype=torch.int32)
            for i, t in enumerate(tables):
                if t and isinstance(self._slots[i], _Request):
                    arr[i, : len(t)] = torch.tensor(t, dtype=torch.int32)
            tbl_dev = arr.to(dev)
            table_dirty = False

        def active() -> list[int]:
            return [i for i, r in enumerate(self._slots) if isinstance(r, _Request)]

        def ext_live() -> bool:
            """A live constrained or logprob slot puts every slot in the ext
            regime: the burst and verify programs advance every row, so an
            ext slot cannot sit one out."""
            return any(isinstance(r, _Request) and r.is_ext for r in self._slots)

        def finish_slot(i: int) -> None:
            nonlocal table_dirty
            self._slots[i] = None
            spec_slots[i] = None
            host_pos[i] = 0
            host_steps[i] = 0
            if tables[i]:
                pool.decref(tables[i])
                tables[i] = []
            table_dirty = True

        def deliver_all(req: _Request, slot: int, ids, advance: bool = True) -> None:
            st = spec_slots[slot]
            try:
                for t in ids:
                    if advance:  # decode tokens move the slot's position
                        req.pos += 1
                    if st is not None:
                        st.index.append(int(t))
                    reason = self._deliver(req, int(t))
                    if reason is not None:
                        finish_slot(slot)  # free BEFORE the end event
                        req.emit("end", reason)
                        return
            except Exception:  # noqa: BLE001 — dead client
                log.exception("delivery failed; dropping slot %d", slot)
                finish_slot(slot)

        def deliver_ext(req: _Request, slot: int, t: int, lp: float, top_ids, top_lps) -> None:
            """One masked step's token: the DFA advances, and a document the
            DFA can extend no further ends with "stop"."""
            st = spec_slots[slot]
            try:
                req.pos += 1
                if st is not None:
                    st.index.append(t)  # an unconstrained slot riding along
                dead = False
                if req.constrain is not None:
                    nstate = req.constrain.advance(req.cstate, t)
                    if nstate is not None:
                        # (None only for an EOS outside an accept state,
                        # which the mask forbids; _deliver maps stop ids)
                        req.cstate = nstate
                    dead = not req.constrain.live(req.cstate)
                if req.want_logprobs:
                    reason = self._deliver(req, t, logprob=lp, top_ids=top_ids,
                                           top_lps=top_lps)
                else:
                    reason = self._deliver(req, t)
                if reason is None and dead:
                    reason = "stop"
                if reason is not None:
                    finish_slot(slot)  # free BEFORE the end event
                    req.emit("end", reason)
            except Exception:  # noqa: BLE001 — dead client
                log.exception("delivery failed; dropping slot %d", slot)
                finish_slot(slot)

        def gone(slot: int, req: _Request) -> bool:
            """Whether a record's row no longer needs delivering: the slot
            moved on, or the consumer left (its slot is freed here)."""
            if self._slots[slot] is not req:
                return True
            if req.cancelled:
                finish_slot(slot)
                self.stats.cancelled += 1
                return True
            return False

        def process_record(rec) -> None:
            if rec[0] == "decode":
                _, toks, n, rows = rec
                ids = toks.cpu()  # ONE [B, n] readback per burst
                for slot, req in rows:
                    if not gone(slot, req):
                        deliver_all(req, slot, ids[slot].tolist())
            elif rec[0] == "spec":
                _, toks, nacc, rows = rec
                ids, nacc = toks.cpu(), nacc.cpu()
                for slot, req, dlen in rows:
                    if self._slots[slot] is not req:
                        continue
                    n_emit = int(nacc[slot])
                    # host pos catches up here: a verify's advance depends
                    # on the data (host_steps moved by k+1 at dispatch)
                    host_pos[slot] += n_emit
                    if dlen > 0:
                        self.stats.record_spec(dlen, n_emit - 1)
                    if not gone(slot, req):
                        deliver_all(req, slot, ids[slot, :n_emit].tolist())
            elif rec[0] == "ext":
                _, toks, lps, tids, tlps, rows = rec
                ids, lps, tids, tlps = toks.cpu(), lps.cpu(), tids.cpu(), tlps.cpu()
                for slot, req in rows:
                    if not gone(slot, req):
                        deliver_ext(req, slot, int(ids[slot]), float(lps[slot]),
                                    tids[slot].tolist(), tlps[slot].tolist())
            else:
                _, firsts, rows = rec
                ids = firsts.cpu()  # one readback for the whole admit
                for j, slot, req in rows:
                    if gone(slot, req):
                        continue
                    if req.is_ext and not req.rewound:
                        # the rewind: the admit sampled token 0 with no mask
                        # and no logprobs. Drop it, step the slot back one
                        # position and put prompt[-1] back on the carry: the
                        # next ext step re-runs prompt[-1] at n-1 (the write
                        # repeats the prefill's row; ensure_private copies a
                        # shared block first) and samples the real token 0
                        # under the mask, at rng step 0
                        req.rewound = True
                        host_pos[slot] -= 1
                        host_steps[slot] = 0
                        tok_dev[slot] = req.prompt_ids[-1]
                        continue
                    first = int(ids[j])
                    deliver_all(req, slot, [first], advance=False)
                    if spec is not None and self._slots[slot] is req:
                        # history = prompt + the first token (on the carry,
                        # not yet written to the pool)
                        spec_slots[slot] = make_slot(req.prompt_ids, first, spec)

        def pump(depth: int = 1) -> None:
            while len(inflight) > depth or (inflight and not active()):
                process_record(inflight.popleft())

        def drain_cancels() -> None:
            while True:
                try:
                    req = self._cancels.get_nowait()
                except _queue.Empty:
                    return
                if 0 <= req.slot < B and self._slots[req.slot] is req:
                    finish_slot(req.slot)
                    self.stats.cancelled += 1
                elif req in waitlist:
                    waitlist.remove(req)
                    self.stats.cancelled += 1

        def grow_for(act: list[int], width: int) -> list[int]:
            """Grow each row's table over the next ``width`` writes and
            privatize any still-shared block in the write range; a row the
            pool cannot grow is shed alone, before any dispatch. Returns the
            rows still active."""
            for i in act:
                try:
                    ensure_blocks(i, host_pos[i] + width)
                    ensure_private(i, host_pos[i], host_pos[i] + width)
                except _PoolExhausted as e:
                    r = self._slots[i]
                    finish_slot(i)
                    r.emit("err", e)
            return active()

        def sampling_lists():
            live = [r if isinstance(r, _Request) else None for r in self._slots]
            return ([r.sp.temperature if r else 0.0 for r in live],
                    [r.sp.top_k if r else 0 for r in live],
                    [r.sp.top_p if r else 1.0 for r in live])

        def decode_ext_once() -> None:
            """ONE masked single-step dispatch over every active slot (the
            ext regime): a constrained row carries its DFA state's vocab
            mask, every other row bans nothing. One step at a time, because
            the next mask is a host-side DFA walk over this step's token;
            the caller drains before and after."""
            nonlocal tok_dev
            act = active()
            if not act:
                return
            act = grow_for(act, 1)
            if not act:
                return
            mask = None
            if any(self._slots[i].constrain is not None for i in act):
                m = np.ones((B, cfg.vocab_size), dtype=bool)
                for i in act:
                    r = self._slots[i]
                    if r.constrain is not None:
                        dm = r.constrain.mask(r.cstate)
                        m[i, :] = False
                        m[i, : dm.shape[0]] = dm
                mask = torch.from_numpy(m).to(dev)
            refresh_tables()
            pos = torch.tensor(host_pos, dtype=torch.int32).to(dev)
            toks, lps, tids, tlps = self._decode_pos_pallas_ext(
                tok_dev, KP, VP, tbl_dev, pos, list(host_seed), list(host_steps),
                *sampling_lists(), mask,
            )
            tok_dev = toks
            self.stats.steps += 1
            for i in act:
                host_pos[i] += 1
                host_steps[i] += 1
            inflight.append(("ext", toks, lps, tids, tlps, [(i, self._slots[i]) for i in act]))

        def spec_once() -> bool:
            """ONE verify dispatch when a live slot has a prompt-lookup
            draft. False (the caller runs a plain burst) when nothing
            drafted, a row is too close to the cache end for a width-(k+1)
            write, or no slot is active. The caller drains first (the
            proposals read each slot's whole history) and after (host pos
            catches up at the readback)."""
            nonlocal tok_dev
            act = active()
            if not act:
                return False
            k = spec.k
            if max(host_pos[i] for i in act) + k + 1 >= self.max_seq:
                return False
            drafts = [[0] * k for _ in range(B)]
            dlens = [0] * B
            for i in act:
                st = spec_slots[i]
                d = st.index.propose(k) if st is not None else []
                if d:
                    drafts[i][: len(d)] = d
                    dlens[i] = len(d)
            if not any(dlens):
                return False  # nothing to verify: a plain burst is cheaper
            # the verify writes k+1 rows a slot; the rows past the accepted
            # ones are stale by position, but may land in a block the prefix
            # cache still shares, so the whole range is privatized
            if grow_for(act, k + 1) != act:
                return False  # a row was shed: the plain burst re-scans
            refresh_tables()
            pos = torch.tensor(host_pos, dtype=torch.int32).to(dev)
            out, nacc, tok_dev = self._spec_verify_pallas(
                tok_dev, KP, VP, tbl_dev, pos,
                torch.tensor(drafts, dtype=torch.int32, device=dev), dlens,
                list(host_seed), list(host_steps), *sampling_lists(),
            )
            self.stats.steps += 1
            self.stats.spec_verifies += 1
            for i in act:
                host_steps[i] += k + 1  # host_pos moves at the readback
            inflight.append(("spec", out, nacc, [(i, self._slots[i], dlens[i]) for i in act]))
            return True

        def decode_once() -> None:
            nonlocal tok_dev
            act = active()
            if not act:
                return
            # no row may run past the cache: near capacity, single steps
            headroom = self.max_seq - 1 - max(host_pos[i] for i in act)
            n = self.decode_burst if headroom >= self.decode_burst else 1
            act = grow_for(act, n)
            if not act:
                return
            refresh_tables()
            pos = torch.tensor(host_pos, dtype=torch.int32).to(dev)
            toks, tok_dev = self._decode_pos_pallas(
                tok_dev, KP, VP, tbl_dev, pos, list(host_seed), list(host_steps),
                *sampling_lists(), n,
            )
            self.stats.steps += n
            for i in act:
                host_pos[i] += n
                host_steps[i] += n
            inflight.append(("decode", toks, n, [(i, self._slots[i]) for i in act]))

        def harvest_prefix(prompt_ids, chunk_logits, slot: int, skip_chunks: int = 0) -> None:
            """Insert the prompt's full chunks into the prefix cache with no
            copy: each node holds the slot's pool block ids (an incref)
            tagged with the pool's epoch. ``skip_chunks`` leading chunks
            were themselves hits, so their nodes exist already."""
            if pc is None:
                return
            n_full = len(prompt_ids) // C
            if n_full <= skip_chunks:
                return
            nbc = C // T
            tbl = tables[slot]
            payloads: list = [None] * skip_chunks
            for j in range(skip_chunks, n_full):
                ids = tbl[j * nbc : (j + 1) * nbc]
                payloads.append((pool.epoch, list(ids)) if len(ids) == nbc else None)
            pc.insert(list(prompt_ids[: n_full * C]), payloads, chunk_logits)

        def chunk_loop(req: _Request, n: int, k1, v1, start0: int, chunk_logits):
            """Serving-chunk prefill of positions [start0, n) beside live
            slots, one decode burst between chunks; the end row of every
            full chunk goes into ``chunk_logits`` (a ragged last chunk's
            prompt-end row is not a chunk's). Returns the prompt-end
            logits."""
            logits = None
            for start in range(start0, n, C):
                chunk = req.prompt_ids[start : start + C]
                chunk = chunk + [0] * (C - len(chunk))
                logits = self._prefill1(
                    torch.tensor([chunk], dtype=torch.int32, device=dev), k1, v1,
                    start, min(n - 1 - start, C - 1), self._win_bucket(start + C),
                )
                if chunk_logits is not None and start + C <= n:
                    chunk_logits[start // C] = logits
                if start + C < n and not ext_live():
                    decode_once()
                    pump()
            return logits

        def admit_paged(req: _Request, slot: int, n: int, seed: int, samp):
            nonlocal table_dirty
            if n <= C:
                bucket = self._bucket(n)
                ids = alloc_blocks(-(-n // T))
                tables[slot] = ids
                table_dirty = True
                bids = ids + [0] * (max(1, bucket // T) - len(ids))
                tokens = torch.tensor([req.prompt_ids + [0] * (bucket - n)],
                                      dtype=torch.int32, device=dev)
                return self._admit_fused_paged(
                    KP, VP, tokens, n, torch.tensor(bids, dtype=torch.int32), seed, samp,
                )
            # long prompt: a prefix hit resumes from cached pool blocks
            n_full = n // C
            nbc = C // T
            chunk_logits = [None] * n_full if pc is not None else None
            hit = pc.match(req.prompt_ids) if pc is not None else None
            if hit is not None and any(p is None or p[0] != pool.epoch
                                       for p in hit.payloads):
                # minted before a pool reset: the ids name recycled blocks
                pc.release(hit)
                hit = None
            if hit is not None and not active() and 2 * hit.tokens < n:
                # one fresh dispatch beats resuming a short cached prefix
                # through per-chunk dispatches
                pc.release(hit)
                hit = None
            try:
                if hit is not None:
                    p = hit.tokens
                    prefix_ids = [b for _, ids in hit.payloads for b in ids]
                    pool.incref(prefix_ids)
                    tables[slot] = list(prefix_ids)
                    table_dirty = True
                    obs_emit("prefix_hit", tokens=p, prompt=n, full=(p == n))
                    if p == n:
                        # full hit: no block copy and no prefill
                        return self._sample_first(hit.end_logits, seed, samp)
                    k1, v1 = make_cache(cfg, 1, self.max_seq, device=dev)
                    for j in range(p // C):
                        self._fill_row_chunk(
                            k1, v1, KP, VP,
                            torch.tensor(prefix_ids[j * nbc : (j + 1) * nbc],
                                         dtype=torch.int32),
                            j * C,
                        )
                    logits = chunk_loop(req, n, k1, v1, p, chunk_logits)
                    skip = p // C
                elif not active():
                    k1, v1 = make_cache(cfg, 1, self.max_seq, device=dev)
                    wb = self._win_bucket(n)
                    tokens = torch.tensor([req.prompt_ids + [0] * (wb - n)],
                                          dtype=torch.int32, device=dev)
                    logits = self._prefill_full(tokens, k1, v1, n)
                    # only the prompt-end row exists here
                    if chunk_logits is not None and n % C == 0:
                        chunk_logits[n_full - 1] = logits
                    skip = 0
                else:
                    k1, v1 = make_cache(cfg, 1, self.max_seq, device=dev)
                    logits = chunk_loop(req, n, k1, v1, 0, chunk_logits)
                    skip = 0
            finally:
                if hit is not None:
                    pc.release(hit)
            # extend the table over the freshly prefilled suffix, then
            # harvest (host bookkeeping; the pool write below is queued
            # before any later admit's read of these ids)
            total = -(-n // T)
            bstart = len(tables[slot])
            tables[slot].extend(alloc_blocks(total - bstart))
            table_dirty = True
            harvest_prefix(req.prompt_ids, chunk_logits, slot, skip_chunks=skip)
            # a full [max_seq/T] bid row: NULL for the shared prefix blocks
            # (the write must not touch the cache's copies) and the junk tail
            bids = [0] * MB
            bids[bstart:total] = tables[slot][bstart:total]
            return self._finish_admit_paged(
                KP, VP, k1, v1, logits, torch.tensor(bids, dtype=torch.int32), seed, samp,
            )

        def install(rows, firsts, seeds, ns) -> None:
            """Make admitted requests live: their slots, positions and rng
            state, and one in-flight record for their first tokens."""
            nonlocal table_dirty
            out = []
            for j, (slot, req) in enumerate(rows):
                req.slot = slot
                req.pos = ns[j]
                self._slots[slot] = req
                self.stats.requests += 1
                host_pos[slot] = ns[j]
                host_steps[slot] = 1  # the admit sampled at rng step 0
                host_seed[slot] = seeds[j]
                tok_dev[slot] = firsts[j]
                out.append((j, slot, req))
            table_dirty = True
            inflight.append(("admit", firsts, out))

        def release_slots(slots: list[int]) -> None:
            nonlocal table_dirty
            for s in slots:
                if tables[s]:
                    pool.decref(tables[s])
                    tables[s] = []
                self._slots[s] = None
            table_dirty = True

        def admit_one(req: _Request) -> None:
            slot = self._slots.index(None)
            n = len(req.prompt_ids)
            sp = req.sp
            seed = sp.seed if sp.seed is not None else random.getrandbits(31)
            samp = (float(sp.temperature), int(sp.top_k), float(sp.top_p))
            self._slots[slot] = _RESERVED  # not idle while the admit runs
            try:
                first = admit_paged(req, slot, n, seed, samp)
            except BaseException:
                release_slots([slot])
                raise
            install([(slot, req)], first, [seed], [n])

        def group_fits(ns: list[int]) -> bool:
            """A group allocates all or nothing: reclaim toward the whole
            need first; a shortfall admits one by one, where only what does
            not fit is shed."""
            need = sum(-(-n // T) for n in ns)
            if need > pool.free_blocks and pc is not None:
                pc.reclaim(need - pool.free_blocks)
            return need <= pool.free_blocks

        def group_args(reqs: list[_Request]):
            """(pad index, seeds, sampling lists) of a batched admit: the
            row count pads to a power of two by repeating row 0."""
            m = len(reqs)
            mpad = 1 << (m - 1).bit_length()
            idx = list(range(m)) + [0] * (mpad - m)
            seeds = [r.sp.seed if r.sp.seed is not None else random.getrandbits(31)
                     for r in reqs]
            samps = ([float(reqs[i].sp.temperature) for i in idx],
                     [int(reqs[i].sp.top_k) for i in idx],
                     [float(reqs[i].sp.top_p) for i in idx])
            return idx, seeds, samps

        def admit_group(reqs: list[_Request], bucket: int) -> bool:
            """Admit m same-bucket short prompts in one batched prefill.
            False when the pool cannot take the whole group (the caller
            admits them one by one)."""
            nonlocal table_dirty
            ns = [len(r.prompt_ids) for r in reqs]
            if not group_fits(ns):
                return False
            slots: list[int] = []
            try:
                for _ in reqs:
                    s = self._slots.index(None)
                    self._slots[s] = _RESERVED
                    slots.append(s)
                idx, seeds, samps = group_args(reqs)
                for j, s in enumerate(slots):
                    tables[s] = alloc_blocks(-(-ns[j] // T))
                table_dirty = True
                nblk = max(1, bucket // T)
                null = [0] * nblk
                bid_rows = torch.tensor(
                    [tables[slots[i]] + [0] * (nblk - len(tables[slots[i]]))
                     if k < len(reqs) else null for k, i in enumerate(idx)],
                    dtype=torch.int32)
                tokens = torch.tensor(
                    [reqs[i].prompt_ids + [0] * (bucket - ns[i]) for i in idx],
                    dtype=torch.int32, device=dev)
                firsts = self._admit_many_fused_paged(
                    KP, VP, tokens, [ns[i] for i in idx], bid_rows,
                    [seeds[i] for i in idx], samps,
                )
            except BaseException:
                release_slots(slots)
                raise
            self.stats.grouped_admits += len(reqs)
            install(list(zip(slots, reqs)), firsts, seeds, ns)
            return True

        def admit_group_chunked(reqs: list[_Request]) -> None:
            """Admit m long prompts through shared [m, C] chunk dispatches
            and one batched finish, with a decode burst between chunks.
            The reserved slots hold _RESERVED during the loop (their decode
            rows are junk into the null block)."""
            nonlocal table_dirty
            ns = [len(r.prompt_ids) for r in reqs]
            if not group_fits(ns):
                for r in reqs:
                    try:
                        admit_one(r)
                    except _PoolExhausted as e:
                        r.emit("err", e)
                return
            m = len(reqs)
            slots: list[int] = []
            try:
                for _ in reqs:
                    s = self._slots.index(None)
                    self._slots[s] = _RESERVED
                    slots.append(s)
                idx, seeds, samps = group_args(reqs)
                mpad = len(idx)
                km, vm = make_cache(cfg, mpad, self.max_seq, device=dev)
                final = torch.zeros((mpad, 1, cfg.vocab_size), dtype=torch.float32,
                                    device=dev)
                end_chunk = torch.tensor([(ns[i] - 1) // C for i in idx], device=dev)
                # per-chunk [mpad, 1, V] logits, kept while the prefix cache
                # is on: full chunks' end rows become the nodes' logits
                glogits: list | None = [] if pc is not None else None
                for j in range(-(-max(ns) // C)):
                    start = j * C
                    rows = []
                    for i in idx:
                        chunk = reqs[i].prompt_ids[start : start + C]
                        rows.append(chunk + [0] * (C - len(chunk)))
                    last_pos = [min(max(ns[i] - 1 - start, 0), C - 1) for i in idx]
                    logits = self._prefill_chunk_group(
                        torch.tensor(rows, dtype=torch.int32, device=dev), km, vm,
                        start, last_pos, self._win_bucket(start + C),
                    )
                    final = self._select_end(final, logits, end_chunk == j)
                    if glogits is not None:
                        glogits.append(logits)
                    if start + C < max(ns) and not ext_live():
                        decode_once()
                        pump()
                # tables before the harvest, which records their block ids
                for j, s in enumerate(slots):
                    tables[s] = alloc_blocks(-(-ns[j] // T))
                table_dirty = True
                if glogits is not None:
                    for j in range(m):
                        # a copy, so the [mpad, 1, V] chunk buffers can free
                        cl = [glogits[t][j : j + 1].clone() for t in range(ns[j] // C)]
                        harvest_prefix(reqs[j].prompt_ids, cl, slots[j])
                    glogits = None
                bid_rows = torch.zeros((mpad, MB), dtype=torch.int32)
                for j in range(m):
                    t = tables[slots[j]]
                    bid_rows[j, : len(t)] = torch.tensor(t, dtype=torch.int32)
                firsts = self._finish_admit_group_paged(
                    KP, VP, km, vm, final, bid_rows, [seeds[i] for i in idx], samps,
                )
            except BaseException:
                release_slots(slots)
                raise
            self.stats.chunked_group_admits += m
            install(list(zip(slots, reqs)), firsts, seeds, ns)

        def reset_after_failed_dispatch() -> None:
            """A failed dispatch may have left the pool half written: fail
            the live streams and start over with a fresh pool. The epoch
            bump makes every prefix-cache payload minted before it free as
            a no-op."""
            nonlocal KP, VP, tok_dev, table_dirty
            inflight.clear()
            err = RuntimeError("batcher cache reset after a failed device dispatch")
            for i, r in enumerate(self._slots):
                if isinstance(r, _Request):
                    r.emit("err", err)
                self._slots[i] = None
                spec_slots[i] = None
                host_pos[i] = 0
                host_steps[i] = 0
                tables[i] = []
            pool.reset()
            if pc is not None:
                pc.clear()
            table_dirty = True
            KP, VP = self._kv = self._new_kv_pool()
            tok_dev = torch.zeros((B,), dtype=torch.int32, device=dev)

        def peek_hit(r: _Request) -> bool:
            """A long prompt with a usable cached prefix is admitted alone:
            the group program prefills every row from position 0 and would
            throw the hit away (a peek pins nothing)."""
            return (pc is not None and len(r.prompt_ids) > C
                    and pc.peek(r.prompt_ids) >= C)

        def take(item) -> bool:
            """Whether an inbox item is a live request (a cancelled one is
            counted and dropped)."""
            if item.cancelled:
                self.stats.cancelled += 1
                return False
            return True

        def fail_all(reqs: list[_Request], e: BaseException) -> None:
            for r in reqs:
                r.emit("err", e)

        def admit_waiters() -> None:
            """Bursts of short same-bucket prompts admit as one batch, runs
            of long prompts (none with a cached prefix) as one batched
            chunked admit, the rest one by one."""
            while waitlist and None in self._slots:
                free = self._slots.count(None)
                head_long = len(waitlist[0].prompt_ids) > C
                group: list[_Request] = []
                if head_long:
                    cap = min(free, self.max_group_long)
                    head_hit = peek_hit(waitlist[0])
                    group.append(waitlist.pop(0))
                    while (not head_hit and waitlist and len(group) < cap
                           and len(waitlist[0].prompt_ids) > C
                           and not peek_hit(waitlist[0])):
                        group.append(waitlist.pop(0))
                    if (not head_hit and len(group) < cap and not waitlist and coalesce_s > 0
                            and not ext_live()):
                        # a chunked admit costs far more than a short wait:
                        # top up with long prompts arriving right behind
                        # (as a decode burst when streams are live)
                        if active():
                            try:
                                decode_once()
                                pump()
                            except Exception as e:  # noqa: BLE001 — the pool may be half written
                                log.exception("decode dispatch failed")
                                fail_all(group, e)
                                reset_after_failed_dispatch()
                                continue
                            topup(group, cap, None)
                        else:
                            topup(group, cap, time.monotonic() + max(coalesce_s, 0.05))
                    self._wl_len = len(waitlist)
                    if len(group) > 1:
                        try:
                            admit_group_chunked(group)
                        except _PoolExhausted as e:
                            fail_all(group, e)  # raised before any device write
                        except Exception as e:  # noqa: BLE001 — surface to callers
                            log.exception("group admit failed")
                            fail_all(group, e)
                            reset_after_failed_dispatch()
                        continue
                else:
                    head_bucket = self._bucket(len(waitlist[0].prompt_ids))
                    while (waitlist and len(group) < min(free, self.max_group_admit)
                           and len(waitlist[0].prompt_ids) <= C
                           and self._bucket(len(waitlist[0].prompt_ids)) == head_bucket):
                        group.append(waitlist.pop(0))
                    self._wl_len = len(waitlist)
                    if len(group) > 1:
                        try:
                            if admit_group(group, head_bucket):
                                continue
                        except _PoolExhausted as e:
                            fail_all(group, e)
                            continue
                        except Exception as e:  # noqa: BLE001 — surface to callers
                            log.exception("group admit failed")
                            fail_all(group, e)
                            reset_after_failed_dispatch()
                            continue
                self._wl_len = len(waitlist)
                for req in group:
                    try:
                        admit_one(req)
                    except _PoolExhausted as e:
                        req.emit("err", e)
                    except Exception as e:  # noqa: BLE001 — surface to the caller
                        log.exception("admit failed")
                        req.emit("err", e)
                        reset_after_failed_dispatch()
            self._wl_len = len(waitlist)

        def topup(group: list[_Request], cap: int, deadline: float | None) -> None:
            """Pull queued long prompts into ``group`` (waiting until
            ``deadline`` for arrivals when one is given); the first item
            that does not join goes to the waitlist and ends the top-up."""
            while len(group) < cap:
                try:
                    if deadline is None:
                        nxt = self._inbox.get_nowait()
                    else:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            return
                        nxt = self._inbox.get(timeout=left)
                except _queue.Empty:
                    return
                if nxt is None:
                    self._inbox.put(None)  # shutdown: the intake sees it next
                    return
                if not take(nxt):
                    continue
                if len(nxt.prompt_ids) > C and not peek_hit(nxt):
                    group.append(nxt)
                else:
                    waitlist.append(nxt)
                    return

        while True:
            act = active()
            self.stats.peak_active = max(self.stats.peak_active, len(act))
            block = not act and not waitlist and not inflight
            first_intake = block
            while True:
                try:
                    item = self._inbox.get(block=block)
                except _queue.Empty:
                    break
                block = False
                if item is None:
                    self._drain_all("shutdown", waitlist)
                    return
                if not take(item):
                    continue
                waitlist.append(item)
                self._wl_len = len(waitlist)
                if first_intake and coalesce_s > 0:
                    # the batcher was idle and one request just arrived:
                    # concurrent arrivals are a few scheduler ticks apart,
                    # and a short wait admits them as one batch
                    first_intake = False
                    deadline = time.monotonic() + coalesce_s
                    while (left := deadline - time.monotonic()) > 0:
                        try:
                            nxt = self._inbox.get(timeout=left)
                        except _queue.Empty:
                            break
                        if nxt is None:
                            self._drain_all("shutdown", waitlist)
                            return
                        if take(nxt):
                            waitlist.append(nxt)
                            self._wl_len = len(waitlist)
            drain_cancels()
            admit_waiters()
            try:
                # an admit's first token is read back before the next burst
                # is queued behind it, so TTFT does not wait a whole burst
                if any(rec[0] == "admit" for rec in inflight):
                    pump(0)
                if ext_live():
                    # pump(0) first, so an ext admit's rewind lands before
                    # its first masked step; after, so the DFA state moves
                    # before the next mask is built
                    pump(0)
                    decode_ext_once()
                    pump(0)
                elif spec is not None and 0 < len(active()) <= spec.max_active:
                    # low occupancy: drain (proposals read the whole
                    # history), verify, drain again (host pos catches up at
                    # the readback); a plain burst when nothing drafted
                    pump(0)
                    if spec_once():
                        pump(0)
                    else:
                        decode_once()
                        pump()
                else:
                    decode_once()
                    pump()
            except Exception:  # noqa: BLE001 — the pool may be half written
                log.exception("decode dispatch failed")
                reset_after_failed_dispatch()

    def _deliver(self, req: _Request, tok_id: int, logprob: float | None = None,
                 top_ids: list | None = None, top_lps: list | None = None) -> str | None:
        """Push one token; returns the end reason when the request just
        finished (the caller frees the slot, then emits the end). A
        ``want_logprobs`` request receives ``(tok, logprob, top_ids,
        top_logprobs)`` tuples (the ext readback supplies the fields)."""
        if tok_id in req.sp.stop_ids:
            return "stop"
        req.generated += 1
        self.stats.tokens += 1
        if req.want_logprobs:
            req.emit("tok", (tok_id, logprob, top_ids, top_lps))
        else:
            req.emit("tok", tok_id)
        req.emitted.append(int(tok_id))
        if req.generated >= req.sp.max_tokens or req.pos + 1 >= self.max_seq:
            return "length"
        return None

    def _drain_all(self, reason: str, waitlist: list[_Request] = ()) -> None:
        self._wl_len = 0
        for req in waitlist:
            req.emit("end", reason)
        if isinstance(waitlist, list):
            waitlist.clear()
        for i, req in enumerate(self._slots):
            if isinstance(req, _Request):
                req.emit("end", reason)
            self._slots[i] = None
        while True:
            try:
                req = self._inbox.get_nowait()
            except _queue.Empty:
                return
            if req is not None:
                req.emit("end", reason)
