"""Automatic prefix KV cache: radix-tree prompt reuse across requests.

Copy of ``nats_llm_studio_tpu/serve/prefix_cache.py`` with the KV-tier
demotion hook (``demote_fn``, ``reclaim(..., demote=)`` and the
``demoted_blocks`` / ``demote_failures`` counters), without
``hot_prefixes``, which waits for the warm handoff.

The ``chat_model`` contract renders every request through the GGUF chat
template, so real traffic shares long common prefixes: the system prompt
plus the resent conversation history would be re-prefilled on every turn.
Block-granular KV reuse across requests (SGLang's RadixAttention, vLLM's
PagedAttention) is the single largest serving win for templated chat
workloads; this module is that capability for the continuous batcher.

Design:

* A radix tree keyed on **token-id chunks** of exactly ``prefill_chunk``
  tokens — the chunk the batcher's chunked-prefill program already uses, so
  every cached block boundary is a boundary the prefill pipeline can resume
  from (``prefill1`` with ``uniform_start`` continues from any chunk edge).
  Fixed-size edges make the "radix tree" a trie over chunk tuples: one dict
  hop per chunk, no partial-edge splitting ever needed.
* Each node owns one **already-materialized KV block pair** — the
  ``[1, L, Hkv, C, D]`` slice of a prefilled transient row cache, a bf16
  tensor or an ``ops.kvcache.KVQ`` pair depending on ``ModelConfig.kv_quant``. A
  quantized serving cache stores quantized blocks: a hit re-inserts the
  exact codes+scales a full prefill would have written, so greedy outputs
  are bit-identical with the cache on or off.
* Nodes may also hold the **chunk-end logits row** (``[1, 1, vocab]``): a
  prompt whose every token is covered by cached chunks samples its first
  token straight from the stored logits and skips prefill entirely. Nodes
  harvested from the single-dispatch flash path lack intermediate logits;
  a full-length match against such a node degrades to a partial hit (the
  final chunk re-prefills) rather than guessing.
* **Refcounted eviction.** ``match`` pins every node on the returned hit;
  the batcher releases the pin after the copy dispatches are enqueued.
  Eviction (capacity pressure, ``resize``, the registry's HBM-pressure
  drop) detaches pinned nodes from the tree but must never free their
  arrays — a detached-while-pinned node is marked dead and freed at
  ``release`` time instead. LRU order is a monotonic use tick; only leaves
  are evictable, so an interior block shared by live descendants outlives
  them.

Thread-safety: the batcher owner thread does match/insert/release; the
registry's event loop may clear/resize under HBM pressure and metrics
handlers read the stats — everything mutating takes the one lock. The
lock only guards the tree; the batcher never writes a block a node holds.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

from ..obs import LogHistogram
from ..obs import emit as obs_emit
from ..ops.kvcache import kv_nbytes


def serving_chunk(max_seq: int, prefill_chunk: int = 256) -> int:
    """The chunk size a batcher with these settings actually serves with
    (mirrors ``ContinuousBatcher.__init__``: halved until it divides the
    ring) — the registry's HBM estimate must price the same block shape
    the batcher will cache."""
    chunk = max(8, prefill_chunk)
    while max_seq % chunk and chunk > 8:
        chunk //= 2
    return chunk


def prefix_block_bytes(cfg, chunk: int, kv_quant: str | None = None,
                       tp: int = 1) -> int:
    """Worst-case PER-DEVICE bytes of ONE cached entry: the K+V block pair
    for ``chunk`` positions plus the optional chunk-end logits row. Used by
    the registry's HBM admission to commit the cache's budget up front.
    ``tp`` is the tensor-parallel factor actually sharding the block's head
    axis (1 under the replicated-KV GQA fallback) — blocks live split
    across the mesh, so each chip holds 1/tp of the KV bytes."""
    quant = (kv_quant if kv_quant is not None else cfg.kv_quant) == "int8"
    dtype_bytes = 4 if cfg.dtype == "float32" else 2
    per_pos = (
        cfg.head_dim * (1 if quant else dtype_bytes) + (4 if quant else 0)
    )
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * chunk * per_pos // max(1, tp)
    return kv + 4 * cfg.vocab_size  # + [1, 1, vocab] f32 end-logits


class _Node:
    """One chunk edge: the KV block for tokens [depth*C, (depth+1)*C).

    In paged mode the node owns no arrays: ``payload`` is an opaque handle
    (the batcher passes ``(pool_epoch, [block ids])``), ``units`` is how
    many pool blocks it pins, and ``free_fn`` (the pool decref) runs when
    the node is truly freed — i.e. the same deferred point at which the
    legacy mode nulls its arrays, so eviction-under-pin stays safe."""

    __slots__ = ("key", "parent", "children", "kb", "vb", "logits", "refs",
                 "tick", "dead", "nbytes", "payload", "units", "free_fn")

    def __init__(self, key, parent, kb, vb, logits, payload=None,
                 units=1, nbytes=None, free_fn=None):
        self.key = key
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.kb = kb
        self.vb = vb
        self.logits = logits
        self.payload = payload
        self.units = units
        self.free_fn = free_fn
        self.refs = 0
        self.tick = 0
        self.dead = False
        self.nbytes = nbytes if nbytes is not None else kv_nbytes(kb) + kv_nbytes(vb)

    def free(self) -> None:
        if self.free_fn is not None and self.payload is not None:
            self.free_fn(self.payload)
        self.kb = self.vb = self.logits = self.payload = None


@dataclass
class PrefixHit:
    """A pinned longest-prefix match. ``blocks`` are alive until
    ``PrefixCache.release`` — even if eviction detaches the nodes first."""

    tokens: int  # chunk-aligned covered length, > 0
    nodes: list = field(default_factory=list)

    @property
    def blocks(self) -> list[tuple[Any, Any]]:
        return [(nd.kb, nd.vb) for nd in self.nodes]

    @property
    def payloads(self) -> list:
        """Per-node opaque payloads (paged mode: (epoch, block ids))."""
        return [nd.payload for nd in self.nodes]

    @property
    def end_logits(self):
        """Chunk-end logits of the deepest matched node (None unless the
        harvesting prefill computed them)."""
        return self.nodes[-1].logits if self.nodes else None


class PrefixCache:
    """Radix (chunk-trie) cache of prefilled KV blocks with LRU eviction.

    Two ownership modes share one tree:

    * legacy (default): each node owns a materialized ``[1, L, Hkv, C, D]``
      block pair; capacity counts nodes.
    * paged (``acquire_fn``/``free_fn`` given): nodes hold pool block-id
      payloads. ``acquire_fn(payload)`` runs when a node is created (the
      batcher increfs the pool) and ``free_fn(payload)`` when it is freed
      (decref), so harvest is a refcount bump and eviction a decref — no
      KV bytes move. Capacity, ``inserted_blocks`` and ``evicted_blocks``
      are denominated in POOL BLOCKS (``node_blocks`` per node).
    """

    def __init__(self, chunk: int, capacity_blocks: int, *,
                 node_blocks: int = 1, node_bytes: int | None = None,
                 acquire_fn=None, free_fn=None):
        if chunk <= 0:
            raise ValueError("chunk must be positive")
        self.chunk = chunk
        self.capacity = max(0, capacity_blocks)
        self.node_blocks = max(1, node_blocks)
        self.node_bytes = node_bytes
        self.acquire_fn = acquire_fn
        self.free_fn = free_fn
        self.paged = free_fn is not None
        self._root: dict[tuple, _Node] = {}
        self._lock = threading.Lock()
        self._tick = 0
        self._blocks = 0
        self._bytes = 0
        # tiered-KV hook (serve/kv_tiers.py): when set by the batcher,
        # owner-thread eviction paths call ``demote_fn(token_ids, payload,
        # logits)`` BEFORE freeing a node, turning LRU eviction into
        # demotion to the host tier. Only owner-thread call sites pass
        # ``demote=True`` — the fn reads device pool blocks, which only the
        # owner thread may do; registry-side clear/resize never demote.
        self.demote_fn = None
        # monotonic counters; hit_tokens is the acceptance metric
        self.hits = 0
        self.misses = 0
        self.full_hits = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        self.demoted_blocks = 0
        self.demote_failures = 0
        self.hit_tokens_hist = LogHistogram(lo=1.0, hi=131072.0, growth=1.5)

    # -- lookup ---------------------------------------------------------------

    def _chunks(self, token_ids) -> list[tuple]:
        C = self.chunk
        return [
            tuple(token_ids[i : i + C])
            for i in range(0, len(token_ids) - C + 1, C)
        ]

    def peek(self, token_ids) -> int:
        """Matched-token count without pinning (group-admit routing: a
        request with a usable hit is admitted alone so the hit path runs)."""
        with self._lock:
            nodes = self._walk(token_ids)
            return len(nodes) * self.chunk

    def _walk(self, token_ids) -> list[_Node]:
        """Longest cached full-chunk prefix (lock held). A match covering
        the WHOLE prompt needs the last node's logits to produce the first
        token; without them the final chunk is dropped so the batcher
        re-prefills it (and backfills the logits on insert)."""
        nodes: list[_Node] = []
        level = self._root
        for key in self._chunks(token_ids):
            nd = level.get(key)
            if nd is None:
                break
            nodes.append(nd)
            level = nd.children
        if nodes and len(nodes) * self.chunk == len(token_ids) and nodes[-1].logits is None:
            nodes.pop()
        return nodes

    def match(self, token_ids) -> PrefixHit | None:
        """Longest cached prefix, PINNED. Caller must ``release`` the hit
        once the blocks' copy dispatches are enqueued (or on any failure)."""
        with self._lock:
            nodes = self._walk(token_ids)
            if not nodes:
                self.misses += 1
                return None
            self._tick += 1
            for nd in nodes:
                nd.refs += 1
                nd.tick = self._tick
            covered = len(nodes) * self.chunk
            self.hits += 1
            self.hit_tokens += covered
            if covered == len(token_ids):
                self.full_hits += 1
            self.hit_tokens_hist.record(float(covered))
            return PrefixHit(tokens=covered, nodes=nodes)

    def release(self, hit: PrefixHit) -> None:
        """Unpin a hit; frees blocks that were evicted while pinned."""
        with self._lock:
            for nd in hit.nodes:
                nd.refs -= 1
                if nd.dead and nd.refs <= 0:
                    nd.free()
        hit.nodes = []

    # -- insertion / eviction -------------------------------------------------

    def insert(self, token_ids, blocks, logits_list=None) -> int:
        """Insert the prompt's full-chunk blocks along one tree path.

        ``blocks[j]`` is the (k, v) block pair for chunk j — or, in paged
        mode, the opaque payload handed back to acquire_fn/free_fn — or None
        when the caller skipped materializing it (the chunk was just
        matched, so its node already exists). ``logits_list[j]`` is the
        chunk-end logits row or None; existing nodes missing logits are
        backfilled, which is how a flash-harvested path later earns
        full-hit capability. Returns the number of NEW nodes inserted."""
        if self.capacity <= 0:
            return 0
        chunks = self._chunks(token_ids)
        added = 0
        with self._lock:
            self._tick += 1
            level = self._root
            parent = None
            for j, key in enumerate(chunks):
                nd = level.get(key)
                if nd is None:
                    if j >= len(blocks) or blocks[j] is None:
                        break  # nothing to create this node from
                    lg = logits_list[j] if logits_list else None
                    if self.paged:
                        payload = blocks[j]
                        if self.acquire_fn is not None:
                            self.acquire_fn(payload)
                        nd = _Node(key, parent, None, None, lg,
                                   payload=payload, units=self.node_blocks,
                                   nbytes=self.node_bytes or 0,
                                   free_fn=self.free_fn)
                    else:
                        kb, vb = blocks[j]
                        nd = _Node(key, parent, kb, vb, lg)
                    level[key] = nd
                    self._blocks += nd.units
                    self._bytes += nd.nbytes
                    self.inserted_blocks += nd.units
                    added += 1
                elif nd.logits is None and logits_list and j < len(logits_list):
                    nd.logits = logits_list[j]
                nd.tick = self._tick
                parent = nd
                level = nd.children
            # insert runs on the owner thread, so capacity overflow demotes
            # (LRU → host tier) instead of dropping when the hook is wired
            evicted = self._evict_to_locked(self.capacity, demote=True)
        if evicted:
            obs_emit("prefix_evict", blocks=evicted, resident=self.blocks)
        return added

    def _evict_to_locked(self, capacity: int, demote: bool = False) -> int:
        """Detach LRU leaves until at most ``capacity`` blocks remain
        (lock held). A pinned leaf is detached but NOT freed — an admit in
        flight still reads its arrays; ``release`` frees it. Interior
        nodes become leaves as their children go, so repeated passes drain
        arbitrarily deep chains."""
        evicted = 0
        while self._blocks > capacity:
            leaf = self._lru_leaf_locked()
            if leaf is None:
                break
            evicted += self._detach_locked(leaf, demote=demote)
        return evicted

    def _lru_leaf_locked(self, unpinned_only: bool = False):
        leaf = None
        stack = list(self._root.values())
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
            elif unpinned_only and nd.refs > 0:
                continue
            elif leaf is None or nd.tick < leaf.tick:
                leaf = nd
        return leaf

    def _detach_locked(self, leaf, demote: bool = False) -> int:
        if demote and self.demote_fn is not None and leaf.payload is not None:
            # hand the node's KV to the lower tier BEFORE the refcount drop
            # below can recycle its pool blocks. Reconstructed path =
            # concatenated chunk keys root→leaf. Any failure falls back to
            # plain eviction — the free below still runs either way, so
            # pool books stay exact.
            chain = []
            nd = leaf
            while nd is not None:
                chain.append(nd.key)
                nd = nd.parent
            tokens = [t for key in reversed(chain) for t in key]
            try:
                if self.demote_fn(tokens, leaf.payload, leaf.logits):
                    self.demoted_blocks += leaf.units
            except Exception:  # noqa: BLE001 — demotion is strictly best-effort
                self.demote_failures += 1
        owner = leaf.parent.children if leaf.parent is not None else self._root
        owner.pop(leaf.key, None)
        self._blocks -= leaf.units
        self._bytes -= leaf.nbytes
        self.evicted_blocks += leaf.units
        leaf.dead = True
        if leaf.refs <= 0:
            leaf.free()
        return leaf.units

    def reclaim(self, n_units: int, demote: bool = False) -> int:
        """Evict UNPINNED LRU leaves until ~``n_units`` capacity units have
        actually been freed (paged mode: pool blocks returned to the free
        list right now, not deferred behind a pin). The batcher calls this
        when the pool runs dry — cached prefixes are the reclaimable tier,
        live slots are not. With ``demote=True`` (owner thread only) each
        reclaimed node's KV is handed to the tier hook first, so pressure
        relief swaps instead of discarding. Returns units freed."""
        freed = 0
        with self._lock:
            while freed < n_units:
                leaf = self._lru_leaf_locked(unpinned_only=True)
                if leaf is None:
                    break
                freed += self._detach_locked(leaf, demote=demote)
        if freed:
            obs_emit("prefix_evict", blocks=freed, resident=self.blocks,
                     reclaim=True)
        return freed

    def resize(self, capacity_blocks: int) -> int:
        """Shrink (or grow) the block budget; evicts immediately. The
        registry's HBM-pressure hook calls ``resize(0)`` to drop the cache
        without touching blocks an in-flight admit has pinned."""
        with self._lock:
            self.capacity = max(0, capacity_blocks)
            evicted = self._evict_to_locked(self.capacity)
        if evicted:
            obs_emit("prefix_evict", blocks=evicted, resident=self.blocks,
                     resized_to=self.capacity)
        return evicted

    def clear(self) -> int:
        with self._lock:
            return self._evict_to_locked(0)

    # -- introspection --------------------------------------------------------

    @property
    def blocks(self) -> int:
        return self._blocks

    @property
    def bytes(self) -> int:
        return self._bytes

    def counters(self) -> dict[str, int]:
        """Monotonic counters (the reference exposes them as
        ``lmstudio_prefix_cache_<name>_total``)."""
        return {
            "hits": self.hits,
            "misses": self.misses,
            "full_hits": self.full_hits,
            "hit_tokens": self.hit_tokens,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
            "demoted_blocks": self.demoted_blocks,
            "demote_failures": self.demote_failures,
        }

    def stats(self) -> dict[str, Any]:
        snap = self.hit_tokens_hist.snapshot()
        return {
            **self.counters(),
            "blocks": self._blocks,
            "capacity_blocks": self.capacity,
            "bytes": self._bytes,
            "hit_tokens_p50": round(snap.percentile(0.5), 1),
        }
