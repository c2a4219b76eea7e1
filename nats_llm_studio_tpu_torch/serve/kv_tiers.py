"""Hierarchical KV tiers below the device block pool.

Copy of ``nats_llm_studio_tpu/serve/kv_tiers.py`` (``KVTierManager``,
``MemorySpillStore``, ``path_hash``): the same LRU host budget, spill
thread, fetch, index and counters. Host leaves are CPU tensors or ndarrays
(``(codes, scales)`` pairs under int8 KV); the batcher reads the pool back
and writes it again, so this module never sees a device tensor.

Three tiers, coldest last:

    device block pool (serve/block_pool.py) — live slots + radix prefix cache
      ↓ demote (owner-thread readback)          ↑ promote (pool write + insert)
    host RAM (this module)                — byte-budgeted LRU of chunk entries
      ↓ spill (background thread, KVX1)         ↑ fetch (decode + re-host)
    JetStream Object Store                — KVX1 blobs; survives process death

Granularity is one **prefill chunk** (``C`` tokens), keyed by the full
token-id prefix ending at that chunk — exactly the radix prefix-cache node
granularity, so demotion maps 1:1 from evicted cache nodes and promotion
re-inserts at chunk boundaries the chunked-prefill pipeline can resume from.

Ownership/threading contract:

* ``demote``/``lookup`` are called from the batcher owner thread (the only
  thread that may touch the device pool); both only move **host** bytes and
  take the manager lock briefly.
* Host-tier eviction hands entries to a daemon spill thread; Object Store
  I/O (via any :class:`SpillStore`) never runs on the owner thread.
* Every spill/fetch failure is contained: a failed spill just loses the cold
  copy (an honest miss later), a failed fetch is a miss. Neither can
  corrupt the pool: the manager never holds pool block ids, only host byte
  copies.

Spilled blobs are single-chunk KVX1 exports plus a JSON index object
mapping path-hash → token ids; ``warm_exports`` reassembles complete
root→leaf chains from it for a restart's import.
"""

from __future__ import annotations

import hashlib
import json
import queue
import threading

import numpy as np

from ..ops.kvcache import host_kv_nbytes
from ..transport import faults as _faults
from .kv_transfer import KVTransferFormatError, decode_kv_blob, encode_kv_blob


def path_hash(token_ids) -> str:
    """Stable content address for one chunk-aligned token prefix."""
    h = hashlib.sha256(np.asarray(list(token_ids), np.int64).tobytes())
    return h.hexdigest()[:32]


def _host_logits(lg):
    """Normalize chunk-end logits to a float32 ``[1, 1, vocab]`` ndarray
    (the shape ``_sample_first`` takes), or None."""
    if lg is None:
        return None
    return np.asarray(lg, np.float32).reshape(1, 1, -1)


class _Entry:
    __slots__ = ("key", "k", "v", "logits", "nbytes")

    def __init__(self, key, k, v, logits):
        self.key = key
        self.k = k
        self.v = v
        self.logits = _host_logits(logits)
        self.nbytes = (
            host_kv_nbytes(k)
            + host_kv_nbytes(v)
            + (self.logits.nbytes if self.logits is not None else 0)
        )


class MemorySpillStore:
    """Dict-backed :class:`SpillStore` for tests and local bench runs.

    Persists across batcher/tier-manager instances within one process —
    the in-process stand-in for the Object Store's survives-restart
    property."""

    def __init__(self):
        self._objects: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, name: str, data: bytes) -> None:
        with self._lock:
            self._objects[name] = bytes(data)

    def get(self, name: str) -> bytes | None:
        with self._lock:
            return self._objects.get(name)

    def delete(self, name: str) -> None:
        with self._lock:
            self._objects.pop(name, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)


class KVTierManager:
    """Host-RAM LRU tier with optional Object-Store spill underneath.

    ``spill`` is any object with blocking ``put(name, bytes)``,
    ``get(name) -> bytes | None`` and ``delete(name)`` — the worker wires a
    JetStream Object Store adapter, tests use :class:`MemorySpillStore`.
    """

    def __init__(
        self,
        host_budget_bytes: int,
        *,
        chunk_tokens: int,
        spill=None,
        namespace: str = "kv",
        max_spill_objects: int = 512,
        promote_chunks: int = 64,
        demote_free_frac: float = 0.10,
        spill_queue_depth: int = 64,
    ):
        self.host_budget = max(0, int(host_budget_bytes))
        self.chunk = int(chunk_tokens)
        self.namespace = namespace
        self.max_spill_objects = max(1, int(max_spill_objects))
        # batcher-consumed policy knobs (carried here so the batcher
        # signature stays small)
        self.promote_chunks = max(0, int(promote_chunks))
        self.demote_free_frac = max(0.0, float(demote_free_frac))
        self._lock = threading.Lock()
        # insertion-ordered dict as the LRU: MRU at the end
        self._entries: dict[tuple, _Entry] = {}
        self._bytes = 0
        self.counters = {
            "demoted_chunks": 0,
            "promoted_chunks": 0,  # bumped by the batcher on pool re-entry
            "host_hits": 0,
            "host_misses": 0,
            "host_evictions": 0,
            "spilled_blobs": 0,
            "spill_failures": 0,
            "spill_dropped": 0,
            "fetched_blobs": 0,
            "fetch_failures": 0,
            "demote_failures": 0,  # bumped by the prefix cache's demote hook
        }
        self._spill = spill
        self._index: dict[str, dict] | None = None
        self._q: queue.Queue | None = None
        self._pending = 0
        self._idle = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        if spill is not None:
            self._q = queue.Queue(maxsize=max(1, int(spill_queue_depth)))
            self._thread = threading.Thread(
                target=self._spill_loop, name="kv-spill", daemon=True
            )
            self._thread.start()

    # -- owner-thread API ----------------------------------------------------

    def demote(self, token_ids, k, v, logits) -> bool:
        """Accept one evicted chunk (host k/v leaves: a CPU tensor or
        ndarray, or ``(codes, scales)``). Returns True once the entry is owned by a
        lower tier (host RAM, or queued for spill)."""
        key = tuple(int(t) for t in token_ids)
        ent = _Entry(key, k, v, logits)
        with self._lock:
            self.counters["demoted_chunks"] += 1
            if ent.nbytes > self.host_budget:
                # bigger than the whole host budget: straight to spill
                return self._enqueue_spill_locked(ent)
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = ent
            self._bytes += ent.nbytes
            self._evict_host_locked()
        return True

    def lookup(self, token_ids) -> _Entry | None:
        """Chunk entry for this exact prefix, or None. A host hit refreshes
        recency; a spill hit decodes the blob and re-hosts it (promotion
        through the tiers — the pool write is the batcher's half)."""
        key = tuple(int(t) for t in token_ids)
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._entries[key] = ent  # move to MRU
                self.counters["host_hits"] += 1
                return ent
            self.counters["host_misses"] += 1
        if self._spill is None:
            return None
        return self._fetch(key)

    def _fetch(self, key) -> _Entry | None:
        if _faults.ACTIVE is not None:
            f = _faults.ACTIVE.check(_faults.TIER_FETCH)
            if f is not None:
                with self._lock:
                    self.counters["fetch_failures"] += 1
                if f.kind == "raise":
                    raise f.exception()
                return None
        name = f"{self.namespace}/{path_hash(key)}"
        try:
            data = self._spill.get(name)
            if data is None:
                return None
            export = decode_kv_blob(data)
            if (
                tuple(export["token_ids"]) != key
                or int(export["chunk_tokens"]) != self.chunk
                or not export["chunks"]
            ):
                raise KVTransferFormatError("spilled blob does not match key")
            ch = export["chunks"][0]
            ent = _Entry(key, ch["k"], ch["v"], ch.get("logits"))
        except Exception:  # noqa: BLE001 — any fetch failure is a miss
            with self._lock:
                self.counters["fetch_failures"] += 1
            return None
        with self._lock:
            self.counters["fetched_blobs"] += 1
            self._entries[key] = ent
            self._bytes += ent.nbytes
            self._evict_host_locked(skip=key)
        return ent

    def note_promoted(self, n_chunks: int) -> None:
        with self._lock:
            self.counters["promoted_chunks"] += n_chunks

    def note_demote_failure(self) -> None:
        with self._lock:
            self.counters["demote_failures"] += 1

    # -- host-tier eviction → spill ------------------------------------------

    def _evict_host_locked(self, skip=None) -> None:
        while self._bytes > self.host_budget and self._entries:
            key = next(iter(self._entries))  # LRU end
            if key == skip and len(self._entries) > 1:
                # never immediately re-spill the entry a fetch just hosted
                ent = self._entries.pop(key)
                self._entries[key] = ent
                key = next(iter(self._entries))
            ent = self._entries.pop(key)
            self._bytes -= ent.nbytes
            self.counters["host_evictions"] += 1
            self._enqueue_spill_locked(ent)
            if key == skip:
                break

    def _enqueue_spill_locked(self, ent) -> bool:
        if self._q is None:
            return False
        try:
            self._q.put_nowait(ent)
        except queue.Full:
            self.counters["spill_dropped"] += 1
            return False
        self._pending += 1
        return True

    # -- spill thread --------------------------------------------------------

    def _spill_loop(self) -> None:
        while True:
            ent = self._q.get()
            if ent is None:
                return
            try:
                self._spill_one(ent)
            finally:
                with self._lock:
                    self._pending -= 1
                    self._idle.notify_all()

    def _spill_one(self, ent) -> None:
        try:
            if _faults.ACTIVE is not None:
                f = _faults.ACTIVE.check(_faults.TIER_SPILL)
                if f is not None:
                    # sever/drop/raise all mean the store is gone mid-
                    # demotion: the blob is not written, the index is not
                    # touched — the chunk is simply lost from the cold tier
                    raise f.exception() if f.kind == "raise" else (
                        _faults.InjectedFault(f"tier spill {f.kind}")
                    )
            blob = encode_kv_blob({
                "token_ids": list(ent.key),
                "chunk_tokens": self.chunk,
                "chunks": [{"k": ent.k, "v": ent.v, "logits": ent.logits}],
            })
            h = path_hash(ent.key)
            self._spill.put(f"{self.namespace}/{h}", blob)
            idx = self._index_locked_load()
            idx[h] = {"t": list(ent.key), "n": len(ent.key) // self.chunk}
            self._prune_index(idx)
            self._spill.put(
                f"{self.namespace}/index",
                json.dumps(idx, separators=(",", ":")).encode(),
            )
            with self._lock:
                self.counters["spilled_blobs"] += 1
        except Exception:  # noqa: BLE001 — spill is best-effort by contract
            with self._lock:
                self.counters["spill_failures"] += 1

    def _index_locked_load(self) -> dict:
        # only the spill thread mutates the index; load lazily so a fresh
        # manager sees objects a previous process spilled
        if self._index is None:
            self._index = {}
            try:
                raw = self._spill.get(f"{self.namespace}/index")
                if raw:
                    self._index = json.loads(raw)
            except Exception:  # noqa: BLE001 — missing/corrupt index = empty
                self._index = {}
        return self._index

    def _prune_index(self, idx: dict) -> None:
        while len(idx) > self.max_spill_objects:
            # drop the shallowest chains first: deep suffix chunks are
            # useless without their ancestors, so depth is the cheapest
            # usefulness proxy the index carries
            victim = min(idx, key=lambda h: idx[h].get("n", 0))
            idx.pop(victim)
            try:
                self._spill.delete(f"{self.namespace}/{victim}")
            except Exception:  # noqa: BLE001 — purge is best-effort
                pass

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until queued spills have been written (tests/bench)."""
        if self._q is None:
            return True
        with self._idle:
            return self._idle.wait_for(lambda: self._pending == 0, timeout)

    def close(self) -> None:
        if self._q is not None and self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=5.0)

    # -- restart path --------------------------------------------------------

    def warm_exports(self, limit: int = 4) -> list[dict]:
        """Reassemble the deepest complete root→leaf chains from the spill
        tier into KVX1 export dicts — the no-live-donor restart path. Chains with a missing or unreadable ancestor blob are
        skipped; nothing here can raise."""
        if self._spill is None or limit <= 0:
            return []
        try:
            raw = self._spill.get(f"{self.namespace}/index")
            idx = json.loads(raw) if raw else {}
        except Exception:  # noqa: BLE001
            return []
        paths = sorted(
            (tuple(v["t"]) for v in idx.values() if v.get("t")),
            key=len, reverse=True,
        )
        # leaves only: a path that is a strict prefix of an already-chosen
        # deeper path is covered by it
        leaves: list[tuple] = []
        for p in paths:
            if not any(q[: len(p)] == p for q in leaves):
                leaves.append(p)
        out: list[dict] = []
        C = self.chunk
        for path in leaves[:limit]:
            chunks = []
            ok = True
            for d in range(len(path) // C):
                ent = self.lookup(path[: (d + 1) * C])
                if ent is None:
                    ok = False
                    break
                chunks.append({"k": ent.k, "v": ent.v, "logits": ent.logits})
            if ok and chunks:
                out.append({
                    "token_ids": list(path[: len(chunks) * C]),
                    "chunk_tokens": C,
                    "chunks": chunks,
                })
        return out

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["host_entries"] = len(self._entries)
            out["host_bytes"] = self._bytes
            out["host_budget_bytes"] = self.host_budget
            out["spill_pending"] = self._pending
            out["spill_enabled"] = int(self._spill is not None)
        return out
