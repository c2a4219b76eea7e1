"""Continuous batcher, paged-KV core: concurrent requests share one
fixed-width decode step over one refcounted block pool.

Port of the paged core of ``nats_llm_studio_tpu/serve/batcher.py``
``ContinuousBatcher``: the same surface the engine calls (``submit``,
``submit_batched``, ``start``, ``stop``, ``idle``, ``pool_stats``), the same
program names in ``stats.program_ms`` and the same admit regimes:

* a prompt of at most one serving chunk prefills fresh (K2) into a
  bucket-length transient row, whose blocks are written into the pool
  (``admit_fused_paged``);
* a longer prompt into an idle batcher prefills in one fresh dispatch
  (``prefill_full``, K2) and a longer prompt beside live slots prefills in
  serving chunks (``prefill1``, K2 for the first chunk and K3 after),
  with one decode burst between chunks so live streams keep flowing; both
  end in ``finish_admit_paged``;
* decode runs bursts of single-token ``forward_decode_paged`` steps (K1)
  plus ``sample_rows`` (``decode_pos_pallas``), with each slot's block
  table grown ahead of the burst.

Under ``cfg.kv_quant == "int8"`` the pool and the transient row caches are
KVQ pairs (int8 codes + f32 scales): rows are quantized as they are
written, later chunks run K4 instead of K3, and decode runs K1q.

One owner thread drives the device; asyncio callers talk to it through
thread-safe queues. PyTorch runs eagerly, so a burst is a Python loop of
steps (the reference scans them on device); kernel launches queue on the
current stream and the host reads tokens back one burst behind.

Not ported yet: prefix cache, speculative decode, the ext path
(constraints, logprobs, n>1), KV tiers and slot suspend, QoS and brownout,
group admits, deadline propagation and the legacy contiguous-KV layout.
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

import torch

from ..device import torch_dtype
from ..engine.generator import SamplingParams, default_buckets
from ..engine.sampling import sample_rows
from ..models.config import ModelConfig
from ..models.llama import (
    ensure_lm_head,
    forward,
    forward_decode_paged,
    make_cache,
)
from ..ops.kvcache import kv_nbytes, kv_pool_write_row, kv_pool_zeros
from ..parallel.memory import KV_BLOCK_TOKENS, PREFILL_CHUNK, serving_geometry
from .block_pool import BlockPool

log = logging.getLogger(__name__)

# placeholder for a slot whose admit is in progress: decode steps during a
# chunked admit must neither deliver tokens for it nor hand it to another
# admit
_RESERVED = object()


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
    # per-program host dispatch time (ms) and dispatch counts, keyed by the
    # reference's program names
    program_ms: dict = field(default_factory=dict)
    program_calls: dict = field(default_factory=dict)

    def record_program(self, name: str, ms: float) -> None:
        self.program_ms[name] = self.program_ms.get(name, 0.0) + ms
        self.program_calls[name] = self.program_calls.get(name, 0) + 1

    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "tokens": self.tokens,
            "steps": self.steps,
            "peak_active": self.peak_active,
            "cancelled": self.cancelled,
            "shed": self.shed,
            "program_calls": dict(self.program_calls),
            "program_ms": {k: round(v, 3) for k, v in self.program_ms.items()},
        }


class ContinuousBatcher:
    """Owns the device loop for one loaded model."""

    # the reference's serving defaults: 256-token prefill chunks, decode
    # bursts of 8 steps, 16-token KV blocks
    PREFILL_CHUNK = PREFILL_CHUNK
    DECODE_BURST = 8
    KV_BLOCK_TOKENS = KV_BLOCK_TOKENS

    def __init__(self, params, cfg: ModelConfig, max_slots: int = 8,
                 max_seq_len: int | None = None):
        self.params = ensure_lm_head(params)
        self.cfg = cfg
        self.device = self.params["embed"].device
        self.max_slots = max_slots
        self.max_seq = min(max_seq_len or cfg.max_seq_len, cfg.max_seq_len)
        self.buckets = default_buckets(self.max_seq)
        # the serving chunk divides max_seq, so the zero-padded last chunk
        # never writes past the row cache; the block size divides the chunk
        self.prefill_chunk, T = serving_geometry(self.max_seq, self.PREFILL_CHUNK,
                                                 self.KV_BLOCK_TOKENS)
        if self.max_seq % self.prefill_chunk:
            raise ValueError(
                f"max_seq_len={self.max_seq} must be divisible by a prefill "
                f"chunk >= 8; use a power-of-two max_seq_len"
            )
        self.decode_burst = self.DECODE_BURST
        self.kv_block_tokens = T
        self.blocks_per_row = self.max_seq // T
        # every slot at max_seq, +1 for the null block 0
        # (parallel/memory.py estimate_load_bytes prices this pool)
        self._pool = BlockPool(max_slots * self.blocks_per_row + 1, T)
        # the pool pair [NB, L, Hkv, T, D], written in place by every program
        self._kv = self._new_kv_pool()
        self.stats = BatcherStats()

        self._admit_fused_paged = self._timed("admit_fused_paged", self._admit_fused_paged_fn)
        self._prefill_full = self._timed("prefill_full", self._prefill_full_fn)
        self._prefill1 = self._timed("prefill1", self._prefill1_fn)
        self._finish_admit_paged = self._timed("finish_admit_paged", self._finish_admit_paged_fn)
        self._decode_pos_pallas = self._timed("decode_pos_pallas", self._decode_pos_pallas_fn)

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

    def _sample_first(self, logits, seed, samp):
        temp, topk, topp = samp
        return sample_rows(logits[:, 0], [seed], [0], [temp], [topk], [topp])

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
        return self._sample_first(logits, seed, samp)

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

    def _finish_admit_paged_fn(self, KP, VP, k1, v1, logits, bids, seed, samp):
        """Long-prompt tail: write the row's blocks (null entries skipped)
        into the pool and sample token 0."""
        kv_pool_write_row(KP, k1, bids)
        kv_pool_write_row(VP, v1, bids)
        return self._sample_first(logits, seed, samp)

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
        the device tensors (params and the K/V pool), so their memory goes
        back to the allocator even while something still holds this
        batcher or its engine."""
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
        """Block counters, the KV mode and the device bytes of the K and V
        pools."""
        kp, vp = self._kv
        return {**self._pool.stats(), "kv_quant": self.cfg.kv_quant,
                "bytes": kv_nbytes(kp) + kv_nbytes(vp)}

    # -- submission ----------------------------------------------------------

    def _enqueue(self, prompt_ids: list[int], sp: SamplingParams) -> _Request:
        if not prompt_ids:
            raise ValueError("empty prompt")
        if len(prompt_ids) >= self.max_seq:
            raise ValueError(f"prompt of {len(prompt_ids)} tokens >= max_seq {self.max_seq}")
        req = _Request(
            prompt_ids=list(prompt_ids), sp=sp, loop=asyncio.get_running_loop(),
            out=asyncio.Queue(), t_enq=time.monotonic(),
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
                     info: dict | None = None) -> AsyncIterator[int]:
        """Yield generated token ids for one request; ``info`` receives the
        end reason ("stop" / "length" / "shutdown") as ``finish_reason``."""
        async for batch in self.submit_batched(prompt_ids, sp, info=info):
            for tok in batch:
                yield tok

    async def submit_batched(self, prompt_ids: list[int], sp: SamplingParams,
                             info: dict | None = None) -> AsyncIterator[list]:
        """Like ``submit`` but yields lists: everything delivered since the
        consumer last woke (a decode burst) comes out as one batch."""
        if not self._started:
            self.start()
        if not prompt_ids:
            return
        req = self._enqueue(prompt_ids, sp)
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
        pool = self._pool
        T = self.kv_block_tokens
        MB = self.blocks_per_row
        dev = self.device
        KP, VP = self._kv
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
        # ("admit", first, slot, req)
        inflight: collections.deque = collections.deque()
        waitlist = self._waitlist

        def alloc_blocks(k: int) -> list[int]:
            got = pool.alloc(k)
            if got is None:
                self.stats.shed += 1
                raise _PoolExhausted(
                    f"kv block pool exhausted ({k} blocks needed, "
                    f"{pool.free_blocks} free) (shed_cause=kv_pool); "
                    f"retry on another worker"
                )
            return got

        def ensure_blocks(i: int, upto: int) -> None:
            nonlocal table_dirty
            need = min(-(-min(upto, self.max_seq) // T), MB)
            if len(tables[i]) < need:
                tables[i].extend(alloc_blocks(need - len(tables[i])))
                table_dirty = True

        def refresh_tables() -> None:
            nonlocal tbl_dev, table_dirty
            if not table_dirty:
                return
            arr = torch.zeros((B, MB), dtype=torch.int32)
            for i, t in enumerate(tables):
                if t:
                    arr[i, : len(t)] = torch.tensor(t, dtype=torch.int32)
            tbl_dev = arr.to(dev)
            table_dirty = False

        def active() -> list[int]:
            return [i for i, r in enumerate(self._slots) if isinstance(r, _Request)]

        def finish_slot(i: int) -> None:
            nonlocal table_dirty
            self._slots[i] = None
            host_pos[i] = 0
            host_steps[i] = 0
            if tables[i]:
                pool.decref(tables[i])
                tables[i] = []
                table_dirty = True

        def deliver_all(req: _Request, slot: int, ids, advance: bool = True) -> None:
            try:
                for t in ids:
                    if advance:  # decode tokens move the slot's position
                        req.pos += 1
                    reason = self._deliver(req, int(t))
                    if reason is not None:
                        finish_slot(slot)  # free BEFORE the end event
                        req.emit("end", reason)
                        return
            except Exception:  # noqa: BLE001 — dead client
                log.exception("delivery failed; dropping slot %d", slot)
                finish_slot(slot)

        def process_record(rec) -> None:
            if rec[0] == "decode":
                _, toks, n, rows = rec
                ids = toks.cpu()  # ONE [B, n] readback per burst
                for slot, req in rows:
                    if self._slots[slot] is not req:
                        continue
                    if req.cancelled:
                        finish_slot(slot)
                        self.stats.cancelled += 1
                        continue
                    deliver_all(req, slot, ids[slot].tolist())
            else:
                _, first, slot, req = rec
                if self._slots[slot] is not req:
                    return
                if req.cancelled:
                    finish_slot(slot)
                    self.stats.cancelled += 1
                    return
                deliver_all(req, slot, [int(first.cpu()[0])], advance=False)

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

        def decode_once() -> None:
            nonlocal tok_dev
            act = active()
            if not act:
                return
            # no row may run past the cache: near capacity, single steps
            headroom = self.max_seq - 1 - max(host_pos[i] for i in act)
            n = self.decode_burst if headroom >= self.decode_burst else 1
            for i in act:
                try:
                    ensure_blocks(i, host_pos[i] + n)
                except _PoolExhausted as e:
                    r = self._slots[i]
                    finish_slot(i)
                    r.emit("err", e)
            act = active()
            if not act:
                return
            refresh_tables()
            live = [r if isinstance(r, _Request) else None for r in self._slots]
            pos = torch.tensor(host_pos, dtype=torch.int32).to(dev)
            toks, tok_dev = self._decode_pos_pallas(
                tok_dev, KP, VP, tbl_dev, pos, list(host_seed), list(host_steps),
                [r.sp.temperature if r else 0.0 for r in live],
                [r.sp.top_k if r else 0 for r in live],
                [r.sp.top_p if r else 1.0 for r in live], n,
            )
            self.stats.steps += n
            for i in act:
                host_pos[i] += n
                host_steps[i] += n
            inflight.append(("decode", toks, n, [(i, self._slots[i]) for i in act]))

        def chunked(req: _Request, n: int, k1, v1):
            """Serving-chunk prefill beside live slots, one decode burst
            between chunks. Returns the prompt-end logits."""
            C = self.prefill_chunk
            logits = None
            for start in range(0, n, C):
                chunk = req.prompt_ids[start : start + C]
                chunk = chunk + [0] * (C - len(chunk))
                logits = self._prefill1(
                    torch.tensor([chunk], dtype=torch.int32, device=dev), k1, v1,
                    start, min(n - 1 - start, C - 1), self._win_bucket(start + C),
                )
                if start + C < n:
                    decode_once()
                    pump()
            return logits

        def admit_paged(req: _Request, slot: int, n: int, seed: int, samp):
            nonlocal table_dirty, tok_dev
            C = self.prefill_chunk
            if n <= C:
                bucket = self._bucket(n)
                ids = alloc_blocks(-(-n // T))
                tables[slot] = ids
                table_dirty = True
                bids = ids + [0] * (max(1, bucket // T) - len(ids))
                tokens = torch.tensor([req.prompt_ids + [0] * (bucket - n)],
                                      dtype=torch.int32, device=dev)
                first = self._admit_fused_paged(
                    KP, VP, tokens, n, torch.tensor(bids, dtype=torch.int32), seed, samp,
                )
            else:
                k1, v1 = make_cache(cfg, 1, self.max_seq, device=dev)
                if not active():
                    wb = self._win_bucket(n)
                    tokens = torch.tensor([req.prompt_ids + [0] * (wb - n)],
                                          dtype=torch.int32, device=dev)
                    logits = self._prefill_full(tokens, k1, v1, n)
                else:
                    logits = chunked(req, n, k1, v1)
                total = -(-n // T)
                tables[slot] = alloc_blocks(total)
                table_dirty = True
                bids = [0] * MB
                bids[:total] = tables[slot]
                first = self._finish_admit_paged(
                    KP, VP, k1, v1, logits, torch.tensor(bids, dtype=torch.int32),
                    seed, samp,
                )
            tok_dev[slot] = first[0]
            return first

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
                if tables[slot]:
                    pool.decref(tables[slot])
                    tables[slot] = []
                self._slots[slot] = None
                raise
            req.slot = slot
            req.pos = n
            self._slots[slot] = req
            self.stats.requests += 1
            host_pos[slot] = n
            host_steps[slot] = 1  # the admit sampled at rng step 0
            host_seed[slot] = seed
            inflight.append(("admit", first, slot, req))

        def reset_after_failed_dispatch() -> None:
            """A failed dispatch may have left the pool half written: fail
            the live streams and start over with a fresh pool."""
            nonlocal KP, VP, tok_dev, table_dirty
            inflight.clear()
            err = RuntimeError("batcher cache reset after a failed device dispatch")
            for i, r in enumerate(self._slots):
                if isinstance(r, _Request):
                    r.emit("err", err)
                self._slots[i] = None
                host_pos[i] = 0
                host_steps[i] = 0
                tables[i] = []
            pool.reset()
            table_dirty = True
            KP, VP = self._kv = self._new_kv_pool()
            tok_dev = torch.zeros((B,), dtype=torch.int32, device=dev)

        while True:
            act = active()
            self.stats.peak_active = max(self.stats.peak_active, len(act))
            block = not act and not waitlist and not inflight
            while True:
                try:
                    item = self._inbox.get(block=block)
                except _queue.Empty:
                    break
                block = False
                if item is None:
                    self._drain_all("shutdown", waitlist)
                    return
                if item.cancelled:
                    self.stats.cancelled += 1
                    continue
                waitlist.append(item)
                self._wl_len = len(waitlist)
            drain_cancels()
            while waitlist and None in self._slots:
                req = waitlist.pop(0)
                self._wl_len = len(waitlist)
                try:
                    admit_one(req)
                except _PoolExhausted as e:
                    req.emit("err", e)
                except Exception as e:  # noqa: BLE001 — surface to the caller
                    log.exception("admit failed")
                    req.emit("err", e)
                    reset_after_failed_dispatch()
            self._wl_len = len(waitlist)
            try:
                # an admit's first token is read back before the next burst
                # is queued behind it, so TTFT does not wait a whole burst
                if any(rec[0] == "admit" for rec in inflight):
                    pump(0)
                decode_once()
                pump()
            except Exception:  # noqa: BLE001 — the pool may be half written
                log.exception("decode dispatch failed")
                reset_after_failed_dispatch()

    def _deliver(self, req: _Request, tok_id: int) -> str | None:
        """Push one token; returns the end reason when the request just
        finished (the caller frees the slot, then emits the end)."""
        if tok_id in req.sp.stop_ids:
            return "stop"
        req.generated += 1
        self.stats.tokens += 1
        req.emit("tok", tok_id)
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
