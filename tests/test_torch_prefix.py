"""The port's prefix cache, copy-on-write and group admits against the JAX
package, on the CPU, on one tiny model (2 layers, max_seq 64, serving
chunk 8) whose params cross through numpy.

* Serving cases of ``tests/test_prefix_cache.py`` and
  ``tests/test_paged_kv.py`` (full hit, partial hit off a chunk edge, int8
  blocks, eviction under a 2-block budget, cache off, a hit beside a miss,
  the pool free after drain, pool exhaustion shed without a reset) and
  batched short / chunked admits, each in both KV modes: greedy ids
  identical to the JAX ``Generator``'s, computed once per module.
* One shared scenario run through the JAX ``ContinuousBatcher(paged=True)``
  and the port: identical ids and identical ``hits``, ``full_hits``,
  ``hit_tokens``, ``cow_copies``, ``grouped_admits`` and
  ``chunked_group_admits``.
* A seeded sampled request gives the same text with the cache on and off.
* A forced copy-on-write (a shared block in a decode write range) gives a
  private copy equal bit for bit, in both KV modes, and the decode write
  then lands only in it.
* ``kv_pool_copy_block`` / ``kv_pool_read_blocks`` equal the JAX ops; the
  ``PrefixCache`` unit cases of ``tests/test_prefix_cache.py``.
* ``estimate_load_bytes``' prefix, pool and group terms, and the
  registry's shrink tier dropping another engine's prefix cache before it
  evicts.

TF32 is switched off so no f32 matmul is rounded.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import async_test
from nats_llm_studio_tpu.engine.generator import Generator
from nats_llm_studio_tpu.engine.generator import SamplingParams as JSamplingParams
from nats_llm_studio_tpu.models import llama as jllama
from nats_llm_studio_tpu.models.config import ModelConfig as JConfig
from nats_llm_studio_tpu.models.export import export_params_to_gguf
from nats_llm_studio_tpu.ops import kvcache as jkv
from nats_llm_studio_tpu.serve import prefix_cache as jprefix
from nats_llm_studio_tpu.serve.batcher import ContinuousBatcher as JBatcher
from nats_llm_studio_tpu_torch.engine.generator import SamplingParams
from nats_llm_studio_tpu_torch.models.config import ModelConfig as TConfig
from nats_llm_studio_tpu_torch.models.convert import kvq_from_numpy, params_from_numpy
from nats_llm_studio_tpu_torch.models.llama import forward_decode_paged
from nats_llm_studio_tpu_torch.obs import EVENTS
from nats_llm_studio_tpu_torch.ops import kvcache as tkv
from nats_llm_studio_tpu_torch.parallel import memory as tmemory
from nats_llm_studio_tpu_torch.serve.batcher import BatcherOverloaded, ContinuousBatcher
from nats_llm_studio_tpu_torch.serve.prefix_cache import (
    PrefixCache,
    prefix_block_bytes,
    serving_chunk,
)
from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
from nats_llm_studio_tpu_torch.store import ModelStore
from test_serve_e2e import byte_level_tokenizer_md

torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
torch.backends.cudnn.allow_tf32 = False

MAX_SEQ, CHUNK = 64, 8
KV_MODES = ["none", "int8"]
V = 512  # ModelConfig.tiny's vocab


def _seq(n: int, a: int, b: int) -> list[int]:
    return [(i * a + b) % V for i in range(n)]


# every prompt a case below sends, by name: (ids, tokens generated)
SHARED11 = _seq(11, 5, 1)
PROMPTS = {
    "aligned": (_seq(16, 7, 3), 6),  # two whole chunks: full hits
    "p1": (SHARED11 + _seq(9, 3, 2), 5),  # share one chunk, then diverge
    "p2": (SHARED11 + _seq(7, 11, 4), 5),
    "kvq19": (_seq(19, 7, 3), 6),
    "ev0": (_seq(16, 7, 3), 4),
    "ev1": (_seq(16, 5, 1), 4),
    "ev2": (_seq(16, 11, 4), 4),
    "hit25": (_seq(25, 7, 3), 5),
    "miss30": (_seq(30, 5, 1), 5),
    "s0": ([1, 2, 3], 6),
    "s1": ([9, 8, 7, 6], 6),
    "s2": ([5], 6),
    "s3": ([10, 20, 30, 40, 50], 6),
    "l0": (_seq(20, 13, 2), 5),
    "l1": (_seq(33, 11, 4), 5),
    "l2": (_seq(26, 3, 7), 5),
    "a+12": (_seq(16, 7, 3) + _seq(12, 5, 2), 4),  # two cached chunks, two more
    "live": ([1, 2, 3], 30),
}


@pytest.fixture(scope="module")
def jax_model():
    """The tiny model's JAX params, and each prompt's greedy ids from the
    JAX Generator in both KV modes."""
    cfg = JConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ)
    # the reference tests' model (tests/test_prefix_cache.py)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    want = {}
    for kv in KV_MODES:
        # one prefill bucket (one compile): right padding never reaches a
        # causal row
        gen = Generator(params, cfg.with_(kv_quant=kv), max_seq_len=MAX_SEQ,
                        buckets=[MAX_SEQ])
        for name, (ids, n) in PROMPTS.items():
            sp = JSamplingParams(temperature=0.0, max_tokens=n)
            want[kv, name] = [t for t, _ in gen.generate(ids, sp)]
    return cfg, params, want


@pytest.fixture(scope="module")
def port_params(jax_model):
    return params_from_numpy(jax.tree.map(np.asarray, jax_model[1]), "cpu", "float32")


def _batcher(port_params, kv: str, **kw) -> ContinuousBatcher:
    cfg = TConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ, kv_quant=kv)
    kw = {"max_slots": 2, "prefill_chunk": CHUNK, **kw}
    return ContinuousBatcher(port_params, cfg, max_seq_len=MAX_SEQ, **kw)


async def _greedy(b, name: str) -> list[int]:
    ids, n = PROMPTS[name]
    sp = SamplingParams(temperature=0.0, max_tokens=n)
    return [t async for t in b.submit(ids, sp)]


async def _together(b, names: list[str]) -> list[list[int]]:
    return list(await asyncio.gather(*[_greedy(b, nm) for nm in names]))


# -- serving cases ------------------------------------------------------------------


@pytest.mark.parametrize("kv", KV_MODES)
@async_test
async def test_full_and_partial_hits_match_jax(jax_model, port_params, kv):
    """A resent chunk-aligned prompt full-hits (token 0 from the stored
    logits, no prefill); a prompt sharing 11 tokens with a cached one
    resumes from the chunk edge (8 tokens); a 19-token prompt resent takes
    a partial hit. Ids equal the JAX Generator's."""
    want = jax_model[2]
    b = _batcher(port_params, kv, prefix_cache_blocks=8)
    try:
        assert await _greedy(b, "aligned") == want[kv, "aligned"]  # miss: populates
        assert await _greedy(b, "aligned") == want[kv, "aligned"]  # full hit
        c = b.prefix_cache.counters()
        assert c["full_hits"] == 1 and c["hit_tokens"] == 16
        assert b.stats.program_calls.get("sample_first") == 1
        ev = EVENTS.snapshot(kind="prefix_hit", limit=1)[0]
        assert (ev["tokens"], ev["prompt"], ev["full"]) == (16, 16, True)
        assert await _greedy(b, "p1") == want[kv, "p1"]
        assert await _greedy(b, "p2") == want[kv, "p2"]
        assert b.prefix_cache.counters()["hit_tokens"] == 16 + 8
        assert await _greedy(b, "kvq19") == want[kv, "kvq19"]
        assert await _greedy(b, "kvq19") == want[kv, "kvq19"]  # 16 of 19 cached
        assert b.stats.program_calls.get("fill_row_chunk", 0) >= 2
        assert b.pool_stats()["cow_copies"] == 0
    finally:
        b.stop()


@pytest.mark.parametrize("kv", KV_MODES)
@async_test
async def test_eviction_and_cache_off_match_jax(jax_model, port_params, kv):
    """A 2-block budget under three 2-chunk prompts evicts, and every admit
    (miss, post-eviction re-miss) matches; with the cache off there is no
    PrefixCache and resends still match."""
    want = jax_model[2]
    b = _batcher(port_params, kv, prefix_cache_blocks=2)
    try:
        for nm in ("ev0", "ev1", "ev2", "ev0"):
            assert await _greedy(b, nm) == want[kv, nm]
        pc = b.prefix_cache
        assert pc.counters()["evicted_blocks"] > 0 and pc.blocks <= 2
    finally:
        b.stop()
    b = _batcher(port_params, kv)
    try:
        assert b.prefix_cache is None
        for _ in range(2):
            assert await _greedy(b, "aligned") == want[kv, "aligned"]
    finally:
        b.stop()


@async_test
async def test_hit_beside_miss_and_groups_match_jax(jax_model, port_params):
    """A cached long prompt arriving with a fresh one is admitted alone on
    its hit path; four short prompts admit as one batch, three long ones as
    one chunked batch. After the drain only the cache holds blocks, and
    after drop_prefix_cache every block is free. (Under int8 a prompt
    prefilled in chunks attends over the quantized prefix where the
    Generator's fresh prefill attends over raw rows, so the int8 versions
    of these cases are held against the JAX batcher, which chunks alike, in
    the shared scenario below.)"""
    kv = "none"
    want = jax_model[2]
    b = _batcher(port_params, kv, max_slots=4, prefix_cache_blocks=16,
                 admit_coalesce_ms=20.0)
    try:
        assert await _greedy(b, "hit25") == want[kv, "hit25"]
        got = await _together(b, ["hit25", "miss30"])
        assert got == [want[kv, "hit25"], want[kv, "miss30"]]
        assert b.prefix_cache.counters()["hits"] >= 1
        names = ["s0", "s1", "s2", "s3"]
        assert await _together(b, names) == [want[kv, nm] for nm in names]
        assert b.stats.grouped_admits == 4
        names = ["l0", "l1", "l2"]
        assert await _together(b, names) == [want[kv, nm] for nm in names]
        assert b.stats.chunked_group_admits == 3
        st = b.pool_stats()
        assert st["blocks_shared"] == 0
        assert st["blocks_live"] == b.prefix_cache.blocks > 0
        assert b.drop_prefix_cache() > 0
        st = b.pool_stats()
        assert st["blocks_free"] == st["blocks_total"] and st["blocks_live"] == 0
    finally:
        b.stop()


@pytest.mark.parametrize("kv", KV_MODES)
@async_test
async def test_partial_hit_beside_a_live_stream_keeps_cached_blocks_intact(
        jax_model, port_params, kv):
    """A partial hit admitted beside a live stream runs a decode burst
    between its suffix chunks while its slot is still reserved, with the
    cached prefix blocks already in its table. That burst computes the
    reserved row as junk; the junk must go to the null block, not into the
    shared prefix blocks: the hit and a later full hit of the cached prompt
    keep the Generator's ids. (The reference batcher's decode table keeps a
    reserved slot's row, and under this sequence its later full hit
    departs from its Generator.)"""
    want = jax_model[2]
    b = _batcher(port_params, kv, prefix_cache_blocks=8, decode_burst=2)
    try:
        assert await _greedy(b, "aligned") == want[kv, "aligned"]
        first = asyncio.Event()

        async def live():
            out = []
            async for t in b.submit(PROMPTS["live"][0],
                                    SamplingParams(temperature=0.0, max_tokens=30)):
                out.append(t)
                first.set()
            return out

        task = asyncio.ensure_future(live())
        await first.wait()
        assert await _greedy(b, "a+12") == want[kv, "a+12"]  # decode between its chunks
        assert await task == want[kv, "live"]
        assert await _greedy(b, "aligned") == want[kv, "aligned"]  # full hit
        c = b.prefix_cache.counters()
        assert c["full_hits"] == 1 and c["hit_tokens"] == 32
    finally:
        b.stop()


@async_test
async def test_pool_exhausted_sheds_without_reset(jax_model, port_params):
    """Seven usable 16-token blocks: four 33-token prompts (3 blocks each)
    arriving together do not all fit; what does not is shed with a
    retryable error naming the pool, the batcher keeps serving and ends
    with every block free and no reset."""
    b = _batcher(port_params, "none", max_slots=4, prefill_chunk=256, kv_pool_blocks=7,
                 decode_burst=2)
    try:
        long_p = _seq(33, 5, 1)
        sp = SamplingParams(temperature=0.0, max_tokens=4)

        async def one(p):
            return [t async for t in b.submit(list(p), sp)]

        results = await asyncio.gather(*[one(long_p[j:] + long_p[:j]) for j in range(4)],
                                       return_exceptions=True)
        assert all(isinstance(r, (list, BatcherOverloaded)) for r in results), results
        served = [r for r in results if isinstance(r, list)]
        shed = [r for r in results if isinstance(r, BatcherOverloaded)]
        assert len(served) >= 2 and len(served) + len(shed) == 4
        assert all("pool" in str(e) for e in shed)
        assert len(await one([1, 2, 3])) == 4
        st = b.pool_stats()
        assert st["blocks_free"] == st["blocks_total"] and st["epoch"] == 0
    finally:
        b.stop()


# -- the shared scenario: counters equal the JAX batcher's ----------------------------


async def _scenario(b, sp) -> tuple[list, dict]:
    """Full hit, partial hit, a short group, a chunked group, a hit beside a
    miss. Returns every request's ids and the six counters."""
    async def one(ids):
        return [t async for t in b.submit(ids, sp)]

    a = _seq(16, 7, 3)
    out = [await one(a), await one(a), await one(a + [3, 1, 4, 1, 5])]
    out += await asyncio.gather(*[one(p) for p in ([1, 2, 3], [4, 5, 6, 7], [8], [9, 9])])
    out += await asyncio.gather(*[one(_seq(n, 3, s)) for n, s in ((20, 11), (27, 13),
                                                                   (17, 17))])
    out += await asyncio.gather(one(a + [2, 7, 1]), one(_seq(30, 13, 2)))
    c = b.prefix_cache.counters()
    return out, {"hits": c["hits"], "full_hits": c["full_hits"],
                 "hit_tokens": c["hit_tokens"], "cow_copies": b.pool_stats()["cow_copies"],
                 "grouped_admits": b.stats.grouped_admits,
                 "chunked_group_admits": b.stats.chunked_group_admits}


@async_test
async def test_shared_scenario_counters_equal_jax_batcher(jax_model, port_params,
                                                          monkeypatch):
    """The scenario under the int8 KV cache through the JAX batcher and the
    port: the same ids and the same counters."""
    cfg, params, _ = jax_model
    kw = dict(max_slots=4, prefill_chunk=CHUNK, prefix_cache_blocks=16,
              admit_coalesce_ms=20.0)
    # one decode window (one compile per burst width) for the JAX batcher
    monkeypatch.setenv("DECODE_LADDER_RUNGS", "1")
    jb = JBatcher(params, cfg.with_(kv_quant="int8"), max_seq_len=MAX_SEQ, paged=True, **kw)
    try:
        want, want_c = await _scenario(jb, JSamplingParams(temperature=0.0, max_tokens=4))
    finally:
        jb.stop()
    tb = _batcher(port_params, "int8", **kw)
    try:
        got, got_c = await _scenario(tb, SamplingParams(temperature=0.0, max_tokens=4))
    finally:
        tb.stop()
    assert got == want
    assert got_c == want_c
    assert got_c["full_hits"] == 1 and got_c["grouped_admits"] == 4
    assert got_c["chunked_group_admits"] == 3 and got_c["cow_copies"] == 0


@async_test
async def test_seeded_sampling_same_with_cache_on_and_off(port_params):
    """A seeded sampled request sent twice: the resend's full hit (token 0
    from the stored logits) and partial hit give the text the uncached
    batcher gives."""
    sp = SamplingParams(temperature=0.9, top_p=0.9, top_k=20, max_tokens=8, seed=1234)
    outs = {}
    for blocks in (0, 8):
        b = _batcher(port_params, "none", prefix_cache_blocks=blocks)
        try:
            outs[blocks] = [[t async for t in b.submit(p, sp)]
                            for p in (PROMPTS["aligned"][0],) * 2 + (PROMPTS["kvq19"][0],) * 2]
        finally:
            b.stop()
        assert blocks == 0 or b.prefix_cache.counters()["full_hits"] == 1
    assert outs[0] == outs[8]


@pytest.mark.parametrize("kv", KV_MODES)
@async_test
async def test_forced_copy_on_write_gives_a_private_copy(port_params, kv):
    """A slot's table holding a cached (shared) block inside a decode write
    range: the block is copied bit for bit into a fresh one, which replaces
    it in the table; the decode write then changes the copy only."""
    b = _batcher(port_params, kv, prefix_cache_blocks=8)
    try:
        await _greedy(b, "aligned")  # caches two chunks, one block each
        pool, (kp, vp) = b._pool, b._kv
        node = next(iter(b.prefix_cache._root.values()))
        src = node.payload[1][0]
        assert pool.refcount(src) == 1  # the cache's reference
        tbl = [src]
        pool.incref(tbl)  # a slot shares it: refcount 2
        T = b.kv_block_tokens
        leaves = (lambda p: [p.q, p.s]) if kv == "int8" else (lambda p: [p])
        before = [x[src].clone() for p in (kp, vp) for x in leaves(p)]
        assert b._ensure_private(tbl, 3, 5) == 1  # positions 3..4 of block 0
        dst = tbl[0]
        assert dst != src and pool.refcount(src) == 1 and pool.refcount(dst) == 1
        assert pool.cow_copies == 1
        for x, y in zip(before, [x[dst] for p in (kp, vp) for x in leaves(p)]):
            assert torch.equal(x, y)  # bit for bit
        assert b._ensure_private(tbl, 3, 5) == 0  # private now
        forward_decode_paged(b.params, b.cfg, torch.tensor([[7]], dtype=torch.int32), kp, vp,
                             torch.tensor([tbl + [0] * (b.blocks_per_row - 1)],
                                          dtype=torch.int32), torch.tensor([3]))
        assert all(torch.equal(x, p[src]) for x, p in zip(before, leaves(kp)))
        k_dst = leaves(kp)[0][dst]
        assert not torch.equal(k_dst[:, :, 3], before[0][:, :, 3])  # written at 3
        assert torch.equal(k_dst[:, :, 4:T], before[0][:, :, 4:T])
        pool.decref(tbl)
    finally:
        b.stop()


# -- ops and the PrefixCache structure ----------------------------------------------


@pytest.mark.parametrize("kv", KV_MODES)
def test_pool_copy_and_read_blocks_equal_jax(kv):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 2, 2, 4, 8)).astype(np.float32)
    if kv == "int8":
        jpool = jkv.quantize_rows(jnp.asarray(x))
        tpool = kvq_from_numpy(np.asarray(jpool.q), np.asarray(jpool.s), "cpu")
    else:
        jpool, tpool = jnp.asarray(x), torch.from_numpy(x.copy())

    def host(p):
        return ([p.q.numpy(), p.s.numpy()] if isinstance(p, tkv.KVQ)
                else [p.numpy()])

    def jhost(p):
        return ([np.asarray(p.q), np.asarray(p.s)] if isinstance(p, jkv.KVQ)
                else [np.asarray(p)])

    bids = [4, 1, 3]
    want = jkv.kv_pool_read_blocks(jpool, jnp.asarray(bids, jnp.int32))
    got = tkv.kv_pool_read_blocks(tpool, torch.tensor(bids, dtype=torch.int32))
    for g, w in zip(host(got), jhost(want)):
        np.testing.assert_array_equal(g, w)
    want = jkv.kv_pool_copy_block(jpool, jnp.int32(2), jnp.int32(5))
    got = tkv.kv_pool_copy_block(tpool, 2, 5)
    for g, w in zip(host(got), jhost(want)):
        np.testing.assert_array_equal(g, w)


def _blk(v, chunk=4):
    a = torch.full((1, 2, 1, chunk, 2), float(v))
    return a.clone(), a.clone()


def test_prefix_cache_pins_survive_eviction():
    """Evicting a pinned node detaches it without freeing its blocks;
    release() frees the dead node."""
    pc = PrefixCache(chunk=4, capacity_blocks=2)
    p1 = list(range(8))
    assert pc.insert(p1, [_blk(1), _blk(2)]) == 2
    hit = pc.match(p1 + [91, 92, 93, 94])
    assert hit is not None and hit.tokens == 8 and len(hit.nodes) == 2
    pinned = list(hit.nodes)
    pc.insert(list(range(100, 108)), [_blk(3), _blk(4)])
    assert pc.counters()["evicted_blocks"] >= 2 and pc.blocks <= 2
    assert all(nd.dead and nd.kb is not None for nd in pinned)
    assert pc.match(p1 + [91]) is None
    pc.release(hit)
    assert all(nd.kb is None and nd.vb is None for nd in pinned) and hit.nodes == []


def test_prefix_cache_full_coverage_needs_end_logits_and_resize():
    pc = PrefixCache(chunk=4, capacity_blocks=8)
    p = list(range(8))
    pc.insert(p, [_blk(1), _blk(2)])  # harvested without logits
    hit = pc.match(p)
    assert hit.tokens == 4 and hit.end_logits is None  # last chunk dropped
    pc.release(hit)
    pc.insert(p, [None, None], logits_list=[None, torch.zeros((1, 1, 16))])
    hit = pc.match(p)
    assert hit.tokens == 8 and hit.end_logits is not None
    pc.release(hit)
    assert pc.resize(0) == 2 and pc.blocks == 0 and pc.bytes == 0
    assert pc.insert(p, [_blk(1), _blk(2)]) == 0  # capacity 0


@pytest.mark.parametrize("kv", KV_MODES)
def test_prefix_sizing_equals_the_reference(kv):
    jcfg = JConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ, kv_quant=kv)
    tcfg = TConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ, kv_quant=kv)
    for seq, chunk in ((64, 8), (4096, 256), (96, 256)):
        assert serving_chunk(seq, chunk) == jprefix.serving_chunk(seq, chunk)
    c = serving_chunk(MAX_SEQ, CHUNK)
    assert prefix_block_bytes(tcfg, c) == jprefix.prefix_block_bytes(jcfg, c)
    pc = PrefixCache(chunk=c, capacity_blocks=4)
    k = torch.zeros((1, 2, tcfg.n_kv_heads, c, tcfg.head_dim),
                    dtype=torch.int8 if kv == "int8" else torch.float32)
    blk = (tkv.KVQ(k, torch.zeros(k.shape[:-1])) if kv == "int8" else k)
    pc.insert(list(range(c)), [(blk, blk)])
    assert pc.bytes <= prefix_block_bytes(tcfg, c)


# -- memory: the estimate and the registry's shrink tier ------------------------------

LLAMA3_8B = dict(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                 head_dim=128, d_ff=14336, max_seq_len=8192)


@pytest.mark.parametrize("kv", KV_MODES)
def test_estimate_prices_prefix_blocks_and_group_admits(kv):
    """The prefix blocks in the pool plus the prefix term are the
    reference's prefix_block_bytes a node; the group workspace (mpad row
    pairs at max_seq, an [mpad, C] chunk's activations, the kept chunk
    logits) sets the workspace when max_group_long > 1."""
    jcfg = JConfig(**LLAMA3_8B, dtype="bfloat16", kv_quant=kv)
    tcfg = TConfig(**LLAMA3_8B, dtype="bfloat16", kv_quant=kv)
    seq, P = 4096, 64
    C, T = tmemory.serving_geometry(seq)
    base = tmemory.estimate_load_bytes(tcfg, 8, seq, prefix_cache_blocks=0)
    est = tmemory.estimate_load_bytes(tcfg, 8, seq, prefix_cache_blocks=P)
    assert est["kv_pool"] - base["kv_pool"] == P * tmemory.kv_pool_block_bytes(tcfg, T)
    assert est["kv_pool"] == (8 * seq // T + P + 1) * tmemory.kv_pool_block_bytes(tcfg, T)
    nodes = P // (C // T)
    assert (est["kv_pool"] - base["kv_pool"] + est["prefix"]
            == nodes * jprefix.prefix_block_bytes(jcfg, C))
    alone = tmemory.estimate_load_bytes(tcfg, 8, seq, prefix_cache_blocks=P,
                                        max_group_long=1)
    row = tmemory.kv_pool_block_bytes(tcfg, seq)
    assert alone["workspace"] == (8 * 4 * tcfg.vocab_size + 64 * 2**20 + row
                                  + tmemory.prefill_activation_bytes(tcfg, seq))
    group = (4 * row + tmemory.prefill_activation_bytes(tcfg, 4 * C)
             + (16 * 4 + 4 + 16) * 4 * tcfg.vocab_size)
    assert est["workspace"] - alone["workspace"] == group - (
        row + tmemory.prefill_activation_bytes(tcfg, seq)) > 0
    assert est["total"] == est["params"] + est["kv_pool"] + est["prefix"] + est["workspace"]


def _publish_512(models_dir, model_id: str, seed: int) -> None:
    """A tiny GGUF at max_seq 512: the registry's batchers serve 256-token
    chunks, so a chat of a few hundred bytes is cached."""
    cfg = JConfig.tiny(n_layers=2, max_seq_len=512)
    d = models_dir / model_id
    d.mkdir(parents=True)
    export_params_to_gguf(d / "m.gguf", jllama.init_params(cfg, jax.random.PRNGKey(seed)), cfg,
                          name=model_id, tokenizer_md=byte_level_tokenizer_md(cfg.vocab_size))


@async_test
async def test_shrink_tier_drops_another_prefix_cache_before_evicting(tmp_path, monkeypatch):
    """Under a budget one engine's prefix term short of two engines, the
    second load drops the first engine's prefix cache (its blocks back in
    its pool) and both stay loaded."""
    models = tmp_path / "models"
    _publish_512(models, "acme/a", 1)
    _publish_512(models, "acme/b", 2)
    monkeypatch.delenv("TPU_HBM_BUDGET_BYTES", raising=False)
    kw = dict(device="cpu", max_batch_slots=2, max_seq_len=512, prefix_cache_blocks=16)
    probe = TorchRegistry(ModelStore(models), **kw)
    paths = [str(f) for f in probe.store.lookup("acme/a").files]
    total, prefix = probe._estimate_load_bytes(paths), probe._estimate_prefix_bytes(paths)
    assert prefix > 0
    monkeypatch.setenv("TPU_HBM_BUDGET_BYTES", str(2 * total - prefix // 2))
    reg = TorchRegistry(ModelStore(models), **kw)
    reg.evict_grace_s = 0.0
    try:
        eng_a = await reg.get_engine("acme/a")
        body = {"messages": [{"role": "user", "content": "the tide tables " * 20}],
                "max_tokens": 2, "temperature": 0.0}
        await eng_a.chat(body)
        assert eng_a.batcher.prefix_cache.blocks > 0
        await reg.get_engine("acme/b")
        assert set(reg.loaded_engines()) == {"acme/a", "acme/b"}  # nothing evicted
        assert eng_a.batcher.prefix_cache.blocks == 0
        st = eng_a.batcher.pool_stats()
        assert st["blocks_free"] == st["blocks_total"]
        assert reg.stats()["hbm_committed_bytes"] == 2 * total - prefix
    finally:
        await reg.close()
