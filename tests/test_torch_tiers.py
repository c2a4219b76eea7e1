"""The port's swap-don't-shed against the JAX package, on the CPU, in
float32: the host KV tier, slot suspend and resume, the growth park, QoS
preemption and brownout's suspend lever.

* ``KVTierManager`` (the port's copy) beside the JAX package's: the same
  demotes give the same counters and spill byte-identical objects; an
  object either manager spilled is fetched by the other; a severed spill
  loses only its blob; a faulted fetch is an honest miss; restart chains
  skip a lost ancestor.
* KVX1 blobs cross the packages both ways, byte for byte: bf16 and f32
  dense leaves and int8 codes with f32 scales.
* Through the port's paged batcher on the reference tests' tiny model
  (``tests/test_kv_tiers.py``, ``tests/test_qos.py`` geometry: two slots,
  32-token chunks and blocks, single-step bursts), against the JAX
  ``ContinuousBatcher`` on an ample pool as the oracle: identical greedy
  tokens after demote then promote (dense and int8 KV), after a suspend
  and resume (dense and int8), mid spec decode, in a schema-constrained
  slot, in a suspend/resume storm (the pool fully free after), after a
  decode growth that parked its slot, after a premium admit preempted a
  batch slot, and after brownout's SHED_ONLY edge suspended down to
  ``suspend_target``. Bookkeeping: a suspended slot's deadline keeps
  running, a ``batcher.suspend`` fault falls back to the retryable shed,
  growth that can never fit sheds one request without a pool reset, a
  fetch fault during promotion keeps serving.

TF32 is switched off so no f32 matmul is rounded.
"""

import asyncio
import json
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import async_test
from nats_llm_studio_tpu.engine.generator import SamplingParams as JSamplingParams
from nats_llm_studio_tpu.models import llama as jllama
from nats_llm_studio_tpu.models.config import ModelConfig as JConfig
from nats_llm_studio_tpu.serve import kv_tiers as jtiers
from nats_llm_studio_tpu.serve import kv_transfer as jtransfer
from nats_llm_studio_tpu.serve.batcher import ContinuousBatcher as JBatcher
from nats_llm_studio_tpu.serve.constrain import TokenDFA as JTokenDFA
from nats_llm_studio_tpu_torch.engine.generator import SamplingParams
from nats_llm_studio_tpu_torch.models.config import ModelConfig as TConfig
from nats_llm_studio_tpu_torch.models.convert import params_from_numpy
from nats_llm_studio_tpu_torch.serve import kv_tiers as ttiers
from nats_llm_studio_tpu_torch.serve import kv_transfer as ttransfer
from nats_llm_studio_tpu_torch.serve.batcher import BatcherOverloaded, ContinuousBatcher
from nats_llm_studio_tpu_torch.serve.brownout import BrownoutConfig
from nats_llm_studio_tpu_torch.serve.constrain import TokenDFA
from nats_llm_studio_tpu_torch.transport import faults

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# tests/test_kv_tiers.py's pool-pressure geometry: 32-token blocks and
# chunks at max_seq 64 (at most two blocks a row), single-step bursts
GEOM = dict(max_slots=2, max_seq_len=64, prefill_chunk=32, kv_block_tokens=32,
            decode_burst=1, admit_coalesce_ms=0.0)
KV_MODES = ["none", "int8"]


def _prompt(n, mul=7, add=3, vocab=509):
    return [(i * mul + add) % vocab for i in range(n)]


PA, PB = _prompt(33), _prompt(40, mul=11, add=5)
PA_SPEC = ([3, 4, 5] * 9 + _prompt(6, mul=13))[:33]  # repeats: drafts hit
PG_A, PG_B = _prompt(20), _prompt(17, mul=11, add=5)  # the growth pair
STORM = [_prompt(40, mul=5 + i, add=i) for i in range(6)]


class _EvenCharDFA:
    """Char DFA over the single character 'e'; lifted over a vocabulary in
    which even ids spell 'e' and odd ids nothing, it bans every odd token:
    a real mask on every step, before and after a suspension."""

    start = 0

    def step(self, state, ch):
        return 0 if ch == "e" else None

    def accepting(self, state):
        return True


def _even_dfa(cls, vocab):
    return cls(_EvenCharDFA(), ["e" if t % 2 == 0 else None for t in range(vocab)],
               vocab, frozenset())


def _jax_oracle(params, cfg, kv: str) -> dict:
    """Greedy tokens of every scenario's requests from one JAX batcher on an
    ample pool (the same geometry; max_tokens at each scenario's longest,
    whose shorter runs are prefixes)."""
    jobs = {"a": (PA, 12, None), "b": (PB, 8, None)}
    if kv == "none":
        dfa = _even_dfa(JTokenDFA, cfg.vocab_size)
        jobs |= {"a_spec": (PA_SPEC, 12, None), "a_dfa": (PA, 12, dfa), "b_dfa": (PB, 8, dfa),
                 "g_a": (PG_A, 14, None), "g_b": (PG_B, 15, None)}
        jobs |= {f"storm{i}": (p, 16, None) for i, p in enumerate(STORM)}

    async def run():
        b = JBatcher(params, cfg.with_(kv_quant=kv), paged=True, **GEOM)
        try:
            async def one(p, n, dfa):
                sp = JSamplingParams(temperature=0.0, max_tokens=n)
                return [int(t) async for t in b.submit(p, sp, constrain=dfa)]

            outs = await asyncio.gather(*[one(*j) for j in jobs.values()])
        finally:
            b.stop()
        return dict(zip(jobs, outs))

    return asyncio.run(run())


@pytest.fixture(scope="module")
def model():
    cfg = JConfig.tiny(n_layers=2, max_seq_len=128)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", "float32")
    oracle = {kv: _jax_oracle(params, cfg, kv) for kv in KV_MODES}
    return tparams, oracle


def _tb(model, kv="none", **kw):
    tparams, _ = model
    return ContinuousBatcher(tparams, TConfig.tiny(n_layers=2, max_seq_len=128, kv_quant=kv),
                             **{**GEOM, **kw})


async def _serve(b, prompts, n, **kw):
    sp = SamplingParams(temperature=0.0, max_tokens=n)

    async def one(p):
        return [t async for t in b.submit(p, sp, **kw)]

    return await asyncio.gather(*[one(p) for p in prompts])


async def _pressure_pair(b, pa, pb, na, nb, qa=None, qb=None, **kw):
    """A first; once two of A's tokens arrived, B, whose admit finds the
    pool full. ``qa``/``qb``: (tenant, priority). Returns both token lists."""
    started = asyncio.get_running_loop().create_future()

    async def run_a():
        out = []
        q = {"tenant": qa[0], "priority": qa[1]} if qa else {}
        async for t in b.submit(pa, SamplingParams(temperature=0.0, max_tokens=na), **kw, **q):
            out.append(t)
            if len(out) == 2 and not started.done():
                started.set_result(None)
        return out

    async def run_b():
        q = {"tenant": qb[0], "priority": qb[1]} if qb else {}
        return [t async for t in b.submit(pb, SamplingParams(temperature=0.0, max_tokens=nb),
                                          **kw, **q)]

    ta = asyncio.ensure_future(run_a())
    await started
    tb = asyncio.ensure_future(run_b())
    return await ta, await tb


async def _wait(pred, timeout=10.0, what="condition"):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.002)


async def _drained(b):
    """Idle, nothing parked, and every block back in the free list."""
    await _wait(lambda: b.idle, what="slots drained")
    assert not b._suspended
    st = b.pool_stats()
    assert st["blocks_free"] == st["blocks_total"], st


# -- KVTierManager against the reference's ---------------------------------------


def _leaves(seed, shape=(2, 4, 16, 8)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_tier_demote_lookup_and_lru_spill_equal_jax():
    """Three chunks into a two-entry host budget in both managers: the LRU
    spills, a host hit refreshes recency, the spilled key comes back
    through ``lookup``; equal counters, and byte-identical objects in the
    two spill stores. Each manager then fetches a blob the other spilled."""
    stores, stats = [], []
    for mod in (jtiers, ttiers):
        store = mod.MemorySpillStore()
        k, _ = _leaves(1)
        m = mod.KVTierManager(2 * 2 * k.nbytes + 64, chunk_tokens=16, spill=store,
                              namespace="kv/t")
        try:
            keys = [tuple(range(i * 16, i * 16 + 16)) for i in range(3)]
            for i, key in enumerate(keys):
                assert m.demote(key, *_leaves(10 + i), None)
            assert m.flush(), "spill thread did not drain"
            assert m.lookup(keys[2]) is not None  # host hit
            got = m.lookup(keys[0])  # spilled: fetched from the store
            assert got is not None and np.array_equal(np.asarray(got.k), _leaves(10)[0])
            assert m.flush()  # the fetch's re-hosting spilled another entry
            stats.append(m.stats())
        finally:
            m.close()
        stores.append(store)
    assert stats[1] == stats[0]
    assert stats[1]["host_hits"] == 1 and stats[1]["fetched_blobs"] == 1
    assert stores[1]._objects == stores[0]._objects  # every blob byte for byte
    for src, mod in ((stores[0], ttiers), (stores[1], jtiers)):
        m = mod.KVTierManager(0, chunk_tokens=16, spill=src, namespace="kv/t")
        try:
            got = m.lookup(tuple(range(16)))
            assert got is not None and np.array_equal(np.asarray(got.v), _leaves(10)[1])
        finally:
            m.close()


def test_tier_spill_sever_is_contained():
    """A store severed mid-demotion loses exactly that blob: the failure is
    counted, later spills land, the index names only written blobs."""
    store = ttiers.MemorySpillStore()
    faults.install(faults.FaultPlan().sever(faults.TIER_SPILL, 0))
    m = ttiers.KVTierManager(0, chunk_tokens=16, spill=store, namespace="kv/s")
    try:
        for i in range(3):
            m.demote(tuple(range(i * 16, i * 16 + 16)), *_leaves(20 + i), None)
        assert m.flush()
        st = m.stats()
        assert st["spill_failures"] == 1 and st["spilled_blobs"] == 2
    finally:
        faults.clear()
        m.close()
    idx = json.loads(store.get("kv/s/index"))
    assert len(idx) == 2
    assert all(store.get(f"kv/s/{h}") is not None for h in idx)


def test_tier_fetch_fault_is_honest_miss():
    store = ttiers.MemorySpillStore()
    m = ttiers.KVTierManager(0, chunk_tokens=16, spill=store, namespace="kv/f")
    try:
        key = tuple(range(16))
        ki, vi = _leaves(33)
        m.demote(key, ki, vi, None)
        assert m.flush()
        faults.install(faults.FaultPlan().drop(faults.TIER_FETCH, 0))
        try:
            assert m.lookup(key) is None
            assert m.stats()["fetch_failures"] == 1
        finally:
            faults.clear()
        got = m.lookup(key)  # the rule fired: the next read succeeds
        assert got is not None and np.array_equal(got.k, ki)
    finally:
        m.close()


def test_tier_warm_exports_skip_a_chain_with_a_lost_ancestor():
    store = ttiers.MemorySpillStore()
    m = ttiers.KVTierManager(0, chunk_tokens=16, spill=store, namespace="kv/w")
    try:
        for i, key in enumerate(([1] * 16, [1] * 32, [2] * 16, [2] * 32)):
            m.demote(key, *_leaves(40 + i), None)
        assert m.flush()
    finally:
        m.close()
    store.delete(f"kv/w/{ttiers.path_hash([2] * 16)}")  # chain 2 loses its root
    m = ttiers.KVTierManager(0, chunk_tokens=16, spill=store, namespace="kv/w")
    try:
        ex = m.warm_exports(limit=4)
    finally:
        m.close()
    assert [e["token_ids"] for e in ex] == [[1] * 32]
    assert len(ex[0]["chunks"]) == 2


# -- KVX1 across the packages ------------------------------------------------


def _bf16(a):
    return torch.from_numpy(a.astype(ml_dtypes.bfloat16).view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("layout", ["bf16", "f32", "int8"])
def test_kvx1_blobs_cross_the_packages_byte_for_byte(layout):
    """The same chunks encoded by each package give the same bytes, and
    each package decodes the other's blob into the leaves it was given."""
    rng = np.random.default_rng(5)
    shape = (1, 2, 2, 16, 8)
    logits = rng.standard_normal(12).astype(np.float32)
    if layout == "int8":
        leaves = [(rng.integers(-127, 128, shape).astype(np.int8),
                   rng.random(shape[:-1]).astype(np.float32)) for _ in range(4)]
        jl = tl = leaves
    else:
        raw = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
        jl = [a.astype(ml_dtypes.bfloat16) for a in raw] if layout == "bf16" else raw
        tl = [_bf16(a) for a in raw] if layout == "bf16" else [torch.from_numpy(a) for a in raw]

    def export(ls, lg):
        return {"token_ids": list(range(32)), "chunk_tokens": 16,
                "chunks": [{"k": ls[0], "v": ls[1], "logits": lg},
                           {"k": ls[2], "v": ls[3], "logits": None}]}

    jb = jtransfer.encode_kv_blob(export(jl, logits))
    tb = ttransfer.encode_kv_blob(export(tl, torch.from_numpy(logits)))
    assert tb == jb
    assert ttransfer.encode_kv_blob(ttransfer.decode_kv_blob(jb)) == jb
    assert jtransfer.encode_kv_blob(jtransfer.decode_kv_blob(tb)) == tb
    got = ttransfer.decode_kv_blob(jb)["chunks"][0]
    if layout == "bf16":
        assert got["k"].dtype == torch.bfloat16 and torch.equal(got["k"], tl[0])
    np.testing.assert_array_equal(got["logits"], logits)


# -- demote, promote, suspend and resume through the batcher ----------------------


@pytest.mark.parametrize("kv", KV_MODES)
@async_test
async def test_demote_promote_bit_identical(model, kv):
    """P caches its chunk, Q evicts it (demoted to the host tier), P again
    promotes it back: the JAX tokens both times; under int8 the codes and
    scales travel together."""
    want = model[1][kv]
    b = _tb(model, kv, prefix_cache_blocks=1)
    b.kv_tiers = ttiers.KVTierManager(32 << 20, chunk_tokens=b.prefill_chunk)
    try:
        first = (await _serve(b, [PB], 8))[0]
        await _serve(b, [PA], 12)
        second = (await _serve(b, [PB], 8))[0]
        assert first == want["b"] and second == want["b"]
        st = b.tier_stats()
        assert st["demoted_chunks"] >= 1 and st["promoted_chunks"] >= 1, st
        assert st["demoted_blocks"] >= 1
        assert b.prefix_cache.hit_tokens >= 32
    finally:
        b.stop()


@pytest.mark.parametrize("kv", KV_MODES)
@async_test
async def test_suspend_resume_greedy_bit_identical(model, kv):
    """A three-block pool: B's admit suspends A (two blocks) to host
    memory, B finishes, A resumes into fresh blocks and ends with the JAX
    tokens; nothing shed, the pool fully free."""
    want = model[1][kv]
    b = _tb(model, kv, kv_pool_blocks=3)
    try:
        got_a, got_b = await _pressure_pair(b, PA, PB, 12, 8)
        assert got_a == want["a"], "the suspended slot did not resume bit-identically"
        assert got_b == want["b"]
        assert b._suspend_stats["suspended_total"] >= 1
        assert b._suspend_stats["resumed_total"] == b._suspend_stats["suspended_total"]
        assert b.stats.shed_cause_counts().get("kv_pool", 0) == 0
        await _drained(b)
        # the readback and the restore are no dispatches: the ledger still
        # sums to dispatch_ms_total, every delivered token served
        dt = b.stats.device_time_snapshot()
        assert sum(dt["ms"].values()) == pytest.approx(b.stats.dispatch_ms_total, rel=1e-9)
        assert dt["tokens"]["served"] == b.stats.tokens == 20
    finally:
        b.stop()


@async_test
async def test_suspend_resume_mid_spec_decode(model):
    """The spec-decode slot state rides the suspended record: A verifies
    drafts before and after its suspension and ends with the JAX tokens."""
    want = model[1]["none"]
    b = _tb(model, kv_pool_blocks=3, spec_decode_k=4)
    try:
        got_a, got_b = await _pressure_pair(b, PA_SPEC, PB, 12, 8)
        assert got_a == want["a_spec"] and got_b == want["b"]
        assert b._suspend_stats["suspended_total"] >= 1
        assert b.stats.spec_accepted > 0
        assert b.stats.shed_cause_counts().get("kv_pool", 0) == 0
    finally:
        b.stop()


@async_test
async def test_suspend_resume_constrained_slot(model):
    """A constrained (ext-regime) slot suspends and resumes with its DFA
    state: all-even output, the JAX tokens."""
    want = model[1]["none"]
    b = _tb(model, kv_pool_blocks=3)
    dfa = _even_dfa(TokenDFA, b.cfg.vocab_size)
    try:
        got_a, got_b = await _pressure_pair(b, PA, PB, 12, 8, constrain=dfa)
        assert got_a == want["a_dfa"] and all(t % 2 == 0 for t in got_a)
        assert got_b == want["b_dfa"]
        assert b._suspend_stats["suspended_total"] >= 1
    finally:
        b.stop()


@async_test
async def test_suspend_resume_storm_leaves_the_pool_free(model):
    """Six two-block requests on two slots over a three-block pool with a
    one-block prefix cache over a host tier: admits suspend (never shed),
    every request ends with the JAX tokens, every suspend resumed, and the
    pool is fully free once the cache is dropped."""
    want = model[1]["none"]
    b = _tb(model, kv_pool_blocks=3, prefix_cache_blocks=1)
    b.kv_tiers = ttiers.KVTierManager(1 << 20, chunk_tokens=b.prefill_chunk)
    try:
        got = await _serve(b, STORM, 8)
        assert got == [want[f"storm{i}"][:8] for i in range(6)]
        sus = b._suspend_stats
        assert sus["suspended_total"] >= 1 and sus["resumed_total"] == sus["suspended_total"]
        assert b.stats.shed_cause_counts().get("kv_pool", 0) == 0
        await _wait(lambda: b.idle, what="slots drained")
        b.drop_prefix_cache()
        st = b.pool_stats()
        assert st["blocks_free"] == st["blocks_total"] and st["blocks_live"] == 0, st
    finally:
        b.stop()


@async_test
async def test_suspended_slot_deadline_keeps_running(model):
    """A parked slot's clock keeps running: past its deadline it fails
    with the retryable deadline cause instead of resuming."""
    b = _tb(model, kv_pool_blocks=3)
    try:
        started = asyncio.get_running_loop().create_future()

        async def run_a():
            out = []
            async for t in b.submit(PA, SamplingParams(temperature=0.0, max_tokens=20)):
                out.append(t)
                if len(out) == 2 and not started.done():
                    started.set_result(None)
            return out

        ta = asyncio.ensure_future(run_a())
        await started
        tb = asyncio.ensure_future(_serve(b, [PB], 20))
        await _wait(lambda: b._suspended, what="a suspension")
        b._suspended[0].req.deadline = time.monotonic() - 1.0
        with pytest.raises(BatcherOverloaded) as ei:
            await ta
        assert "deadline exceeded while suspended" in str(ei.value)
        assert "retry" in str(ei.value)
        await tb  # the admit that caused the suspension still serves
        assert b._suspend_stats["suspended_deadline_expired"] == 1
        assert b.stats.shed_cause_counts().get("deadline", 0) == 1
        await _drained(b)
    finally:
        b.stop()


@async_test
async def test_suspend_fault_falls_back_to_a_retryable_shed(model):
    """A ``batcher.suspend`` drop (a worker dying mid-suspend): the victim
    keeps decoding untouched, the admit that needed its blocks is shed
    retryably, and no reference is stranded."""
    b = _tb(model, kv_pool_blocks=3)
    faults.install(faults.FaultPlan().drop(faults.SUSPEND, 0))
    try:
        started = asyncio.get_running_loop().create_future()

        async def run_a():
            out = []
            async for t in b.submit(PA, SamplingParams(temperature=0.0, max_tokens=12)):
                out.append(t)
                if len(out) == 2 and not started.done():
                    started.set_result(None)
            return out

        ta = asyncio.ensure_future(run_a())
        await started
        with pytest.raises(BatcherOverloaded) as ei:
            await _serve(b, [PB], 8)
        assert "retry" in str(ei.value)
        assert len(await ta) == 12
        assert b._suspend_stats["suspend_failures"] >= 1
        assert b._suspend_stats["suspended_total"] == 0
        assert b.stats.shed_cause_counts().get("kv_pool", 0) == 1
        await _drained(b)
    finally:
        faults.clear()
        b.stop()


@async_test
async def test_decode_growth_exhaustion_parks_the_grower(model):
    """A two-block pool: A (20 + 14 tokens) must grow a second block at
    position 32 while B (17 + 15, one block) is live. The growth parks A
    (reason ``growth``) instead of shedding it; A resumes once B's block
    frees and ends with the JAX tokens."""
    want = model[1]["none"]
    b = _tb(model, kv_pool_blocks=2)
    try:
        got_a, got_b = await asyncio.gather(*[
            _serve(b, [p], n) for p, n in ((PG_A, 14), (PG_B, 15))])
        assert got_a[0] == want["g_a"], "the grower did not resume bit-identically"
        assert got_b[0] == want["g_b"]
        assert b._suspend_stats["suspended_total"] >= 1
        assert b.stats.shed_cause_counts().get("kv_pool", 0) == 0
        await _drained(b)
    finally:
        b.stop()


@async_test
async def test_decode_growth_that_cannot_fit_sheds_without_a_reset(model):
    """A lone slot whose full extent exceeds a one-block pool can never be
    parked profitably: its growth sheds that request alone, retryably, the
    pool's epoch stays 0 and the engine keeps serving."""
    b = _tb(model, kv_pool_blocks=1)
    try:
        with pytest.raises(BatcherOverloaded) as ei:
            await _serve(b, [PG_A], 14)
        assert "retry" in str(ei.value)
        assert b.stats.shed_cause_counts().get("kv_pool", 0) == 1
        assert len((await _serve(b, [_prompt(10)], 4))[0]) == 4
        await _drained(b)
        assert b.pool_stats()["epoch"] == 0, "a growth shed must not reset the pool"
    finally:
        b.stop()


@async_test
async def test_premium_preempts_batch_bit_identical(model):
    """A premium admit on a full pool preempts the batch slot (reason
    ``preempted``, counted per tenant, not a shed); both end with the JAX
    tokens."""
    want = model[1]["none"]
    b = _tb(model, kv_pool_blocks=3, qos_preempt=True)
    try:
        got_a, got_b = await _pressure_pair(b, PA, PB, 12, 8, ("hobby", "batch"),
                                             ("acme", "premium"))
        assert got_a == want["a"] and got_b == want["b"]
        assert b._suspend_stats["suspended_total"] >= 1
        snap = b.tenant_stats.snapshot()
        assert snap["hobby"]["preempted"] >= 1
        assert snap["hobby"]["shed"] == 0 and snap["acme"]["shed"] == 0
        assert snap["hobby"]["served"] == 1 and snap["acme"]["served"] == 1
        assert b.stats.shed_cause_counts().get("kv_pool", 0) == 0
    finally:
        b.stop()


@async_test
async def test_shed_only_edge_suspends_down_to_the_target(model):
    """Two live streams; the headroom signal drops to 0 (SHED_ONLY): the
    younger stream is suspended (reason ``brownout``) down to
    ``suspend_target`` = 1, the older keeps decoding; once the signal
    recovers and the level falls below SHED_ONLY it resumes. Both end with
    the JAX tokens."""
    want = model[1]["none"]
    hot = {"on": False, "done": False}
    b = None

    def headroom():
        live = [r for r in b._slots if hasattr(r, "emitted")]
        if not hot["done"] and len(live) == 2 and all(len(r.emitted) >= 2 for r in live):
            hot["on"] = hot["done"] = True  # the incident edge, once
        elif hot["on"] and b._suspended:
            hot["on"] = False  # parked: the pressure passes
        return 0.0 if hot["on"] else 1.0

    b = _tb(model, brownout=BrownoutConfig(dwell_s=0.02), hbm_headroom_fn=headroom)
    try:
        got = await _serve(b, STORM[:2], 16)
        assert got == [want["storm0"], want["storm1"]]
        sus = b._suspend_stats
        assert sus["suspended_total"] == 1 and sus["resumed_total"] == 1, sus
        assert b.brownout.transitions >= 2
        await _drained(b)
    finally:
        b.stop()


@async_test
async def test_fetch_fault_during_promotion_keeps_serving(model):
    """The host budget is 0, so the demoted chunk spills; a dropped fetch
    during the promotion degrades to a plain prefill: the same tokens, a
    counted fetch failure."""
    want = model[1]["none"]
    b = _tb(model, prefix_cache_blocks=1)
    b.kv_tiers = ttiers.KVTierManager(0, chunk_tokens=b.prefill_chunk,
                                      spill=ttiers.MemorySpillStore(), namespace="kv/test")
    try:
        assert (await _serve(b, [PB], 8))[0] == want["b"]
        await _serve(b, [PA], 12)
        assert b.kv_tiers.flush()
        faults.install(faults.FaultPlan().drop(faults.TIER_FETCH, 0))
        try:
            assert (await _serve(b, [PB], 8))[0] == want["b"]
        finally:
            faults.clear()
        assert b.kv_tiers.stats()["fetch_failures"] >= 1
    finally:
        b.stop()
