"""The port's overload control against the JAX package, on the CPU.

* Pure-Python copies, equal outputs on the same inputs: the brownout
  controller's levels and levers over seeded signal traces with an
  injected clock; ``DrrScheduler.order`` over seeded queues;
  ``TenantStats`` snapshots (with the top-K rollup); the deadline
  feasibility estimate from the same rate EWMAs.
* One scenario through the port's batcher (float32, ``device="cpu"``) and
  the JAX ``ContinuousBatcher`` (paged, the reference tests' setup of
  ``tests/test_deadline_brownout.py``): an expired-at-submit shed, the
  depth shed, the admission order of two tenants of different classes at
  ``max_slots=1``, a mid-decode deadline abort, a queued expiry and an
  infeasible queued deadline (the estimate pinned, so each takes its
  branch), and the age shed. Error strings equal once their numbers are
  masked, the same ids served, the same ``shed_cause_counts`` and cancel
  causes, and every pool block free again.
* Supervision, port only, through the torch ``Worker``'s supervisor over
  NATS on a ``TorchRegistry(device="cpu")``: a program that crashes the
  owner thread once, the restart, the same greedy text after it; repeated
  crashes poison the model until ``pull`` or ``delete`` resets it; a crash
  with a context-killing CUDA error text poisons at once; after a crash
  the loop's frames are gone (a weakref to a pool tensor dies at the
  unload).
"""

import asyncio
import gc
import json
import re
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from conftest import async_test
from nats_llm_studio_tpu.engine.generator import SamplingParams as JSamplingParams
from nats_llm_studio_tpu.models import llama as jllama
from nats_llm_studio_tpu.models.config import ModelConfig as JConfig
from nats_llm_studio_tpu.serve import brownout as jbrownout
from nats_llm_studio_tpu.serve import qos as jqos
from nats_llm_studio_tpu.serve.batcher import ContinuousBatcher as JBatcher
from nats_llm_studio_tpu_torch.config import WorkerConfig
from nats_llm_studio_tpu_torch.engine.generator import SamplingParams
from nats_llm_studio_tpu_torch.models.config import ModelConfig as TConfig
from nats_llm_studio_tpu_torch.models.convert import params_from_numpy
from nats_llm_studio_tpu_torch.serve import brownout as tbrownout
from nats_llm_studio_tpu_torch.serve import qos as tqos
from nats_llm_studio_tpu_torch.serve.batcher import ContinuousBatcher
from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
from nats_llm_studio_tpu_torch.serve.worker import Worker
from nats_llm_studio_tpu_torch.store import ModelStore
from nats_llm_studio_tpu_torch.transport import EmbeddedBroker, connect
from nats_llm_studio_tpu_torch.transport.envelope import error_is_retryable
from test_torch_serve import _export

torch.backends.cuda.matmul.allow_tf32 = False

MAX_SEQ = 64


def _mask(text: str) -> str:
    """An error text with its numbers masked (waits and counts vary)."""
    return re.sub(r"\d+", "N", text)


# -- pure-Python copies -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_brownout_levels_and_levers_equal_jax(seed):
    """The same seeded signal trace (depth fraction, age p95, headroom,
    clock) through both controllers: every tick's level, transition count
    and levers equal."""
    rng = np.random.default_rng(seed)
    kw = dict(depth_hi=0.6, depth_lo=0.3, age_hi_ms=800.0, age_lo_ms=200.0,
              hbm_lo_frac=0.05, dwell_s=float(rng.uniform(0.1, 1.0)),
              shed_only_scale=1.5, tighten_frac=0.5)
    j = jbrownout.BrownoutController(jbrownout.BrownoutConfig(**kw), engine="e")
    t = tbrownout.BrownoutController(tbrownout.BrownoutConfig(**kw), engine="e")
    now = 100.0
    for i in range(300):
        now += float(rng.uniform(0.0, 0.3))
        if (i // 25) % 2:  # a calm stretch, with a blip now and then
            depth, age = float(rng.uniform(0, 0.35)), float(rng.uniform(0, 250))
            hbm = None if rng.random() < 0.5 else float(rng.uniform(0.04, 0.5))
        else:  # pressure on one signal or another
            depth, age = float(rng.uniform(0, 1.2)), float(rng.choice([0.0, rng.uniform(0, 1500)]))
            hbm = None if rng.random() < 0.5 else float(rng.uniform(0.0, 0.2))
        sig = dict(depth_frac=depth, age_p95_ms=age, hbm_headroom_frac=hbm, now=now)
        assert t.update(**sig) == j.update(**sig)
        assert t.transitions == j.transitions
        assert (t.pause_spec, t.pause_prefix_harvest) == (j.pause_spec, j.pause_prefix_harvest)
        for burst in (1, 8):
            assert t.effective_burst(burst) == j.effective_burst(burst)
        for limit in (0, 1, 32):
            assert t.effective_queue_limit(limit) == j.effective_queue_limit(limit)
        assert t.suspend_target(8) == j.suspend_target(8)
    assert t.transitions > 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drr_order_equals_jax(seed):
    """Seeded queues of tenants of mixed classes and prompt lengths,
    reordered by both schedulers over several passes (the deficits carry
    between passes): the same order every time."""
    rng = np.random.default_rng(seed)
    quantum = float(rng.choice([4, 32, 256]))
    js, ts = jqos.DrrScheduler(quantum=quantum), tqos.DrrScheduler(quantum=quantum)
    classes = ["batch", "standard", "premium", "garbage"]
    for _ in range(6):
        items = [(f"t{int(rng.integers(0, 4))}", classes[int(rng.integers(0, 4))],
                  int(rng.integers(1, 300)), i) for i in range(int(rng.integers(0, 14)))]
        args = dict(tenant_of=lambda it: it[0], cost_of=lambda it: it[2])
        want = js.order(items, weight_of=lambda it: jqos.class_weight(it[1]), **args)
        got = ts.order(items, weight_of=lambda it: tqos.class_weight(it[1]), **args)
        assert got == want


@pytest.mark.parametrize("topk", [0, 2, 8])
def test_tenant_stats_snapshots_equal_jax(topk):
    """The same seeded stream of requests, serves, sheds and preemptions
    over seven tenants (one literally named ``other``): equal snapshots,
    with and without the top-K rollup; the priority header codec too."""
    rng = np.random.default_rng(topk)
    js, ts = jqos.TenantStats(), tqos.TenantStats()
    for _ in range(200):
        tenant = f"tenant{int(rng.integers(0, 6))}" if rng.random() < 0.9 else "other"
        op, tokens, age = int(rng.integers(0, 4)), int(rng.integers(0, 50)), float(rng.uniform(0, 90))
        for s in (js, ts):
            if op == 0:
                s.record_request(tenant)
            elif op == 1:
                s.record_served(tenant, tokens, age)
            elif op == 2:
                s.record_shed(tenant)
            else:
                s.record_preempted(tenant)
    assert ts.snapshot(topk) == js.snapshot(topk)
    for value in ("batch", "premium:2.5", " PREMIUM ", "root:-3", "x:y", None, ""):
        assert tqos.parse_priority_header(value) == jqos.parse_priority_header(value)
    for p, w in (("premium", 2.5), ("batch", 0.0), ("nope", 1.0)):
        assert tqos.format_priority_header(p, w) == jqos.format_priority_header(p, w)


# -- the batcher scenario -----------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg = JConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ, use_flash_attention=True)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", "float32")
    return cfg, params, tparams


async def _collect(req) -> tuple[list, str]:
    """Drain a queued request's events: (tokens, end reason or error text)."""
    toks = []
    while True:
        kind, value = await req.out.get()
        if kind == "tok":
            toks.append(value)
        elif kind == "end":
            return toks, value
        else:
            return toks, f"ERR {value}"


async def _scenario(b, sp_cls) -> dict:
    """Every overload path on one batcher (max_slots 1, max_queue 4)."""
    out: dict = {}
    free0 = b._pool.free_blocks

    def sp(n):
        return sp_cls(temperature=0.0, max_tokens=n)

    async def occupied(fn):
        """Run ``fn`` (which queues a waiter) while a 60-token greedy
        request holds the one slot; returns (waiter result, its tokens)."""
        base = b.stats.requests
        occ = asyncio.ensure_future(_collect(b._enqueue([7, 8], sp(60))))
        while b.stats.requests < base + 1:
            await asyncio.sleep(0.002)
        res = await fn()
        return res, (await occ)[0]

    # 1. expired at submit, before the owner thread exists: no admit
    with pytest.raises(Exception) as ei:
        b._enqueue([1, 2, 3], sp(4), deadline=time.monotonic() - 0.5)
    out["submit_expired"] = str(ei.value)
    # 2. four requests of two tenants queued before the owner starts, then
    # a fifth past the depth bound
    reqs = [b._enqueue([3 + i, 4, 5], sp(3), tenant=t, priority=p)
            for i, (t, p) in enumerate([("acme", "batch"), ("acme", "batch"),
                                        ("zeta", "premium"), ("zeta", "premium")])]
    with pytest.raises(Exception) as ei:
        b._enqueue([9, 9], sp(2), tenant="late")
    out["depth"] = str(ei.value)
    b.start()
    done = []

    async def watch(i, r):
        res = await _collect(r)
        done.append(i)
        return res

    out["drr"] = await asyncio.gather(*[watch(i, r) for i, r in enumerate(reqs)])
    out["drr_order"] = done
    # 3. mid-decode abort: the deadline moves to the past at the first
    # delivery, so the active sweep fires on the next pass
    r = b._enqueue([1, 2, 3], sp(50), deadline=time.monotonic() + 300.0)
    kind, value = await r.out.get()
    assert kind == "tok"
    r.deadline = time.monotonic() - 0.001
    toks, out["abort"] = await _collect(r)
    out["abort_tokens_lt_50"] = len(toks) + 1 < 50
    while not all(s is None for s in b._slots):
        await asyncio.sleep(0.005)

    # 4. a queued waiter whose deadline passes: moved to the past right
    # after the enqueue, so the next sweep takes the expired branch
    async def expired():
        w = b._enqueue([3, 4], sp(4), deadline=time.monotonic() + 30.0)
        w.deadline = time.monotonic() - 0.001
        return (await _collect(w))[1]

    out["queued_expired"], out["queued_expired_occupier"] = await occupied(expired)

    # 5. an infeasible queued deadline: the estimate pinned past its budget
    async def infeasible():
        b._estimate_serve_s = lambda r: 1e9
        try:
            return (await _collect(b._enqueue([3, 4], sp(4),
                                              deadline=time.monotonic() + 30.0)))[1]
        finally:
            del b._estimate_serve_s

    out["queued_infeasible"], out["queued_infeasible_occupier"] = await occupied(infeasible)

    # 6. the age bound, with the waiter's enqueue time a second back
    async def aged():
        b.max_queue_age_ms = 30.0
        w = b._enqueue([3, 4], sp(4))
        w.t_enq -= 1.0
        try:
            return (await _collect(w))[1]
        finally:
            b.max_queue_age_ms = 0.0

    out["age"], out["age_occupier"] = await occupied(aged)
    while not all(s is None for s in b._slots):
        await asyncio.sleep(0.005)
    out["shed_causes"] = b.stats.shed_cause_counts()
    out["cancel_deadline"] = b.stats.cancel_causes.get("deadline")
    out["free_back"] = b._pool.free_blocks == free0
    out["tenants"] = {t: {k: r[k] for k in ("requests", "served", "shed", "tokens")}
                      for t, r in b.tenant_stats.snapshot().items()}
    return out


@async_test
async def test_overload_scenario_matches_jax(model):
    cfg, params, tparams = model
    kw = dict(max_slots=1, max_seq_len=MAX_SEQ, max_queue=4, qos_quantum_tokens=2,
              prefix_cache_blocks=0)
    jb = JBatcher(params, cfg, paged=True, kv_suspend=False, qos_preempt=False, **kw)
    try:
        want = await _scenario(jb, JSamplingParams)
    finally:
        jb.stop()
    tb = ContinuousBatcher(tparams, TConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ), **kw)
    try:
        got = await _scenario(tb, SamplingParams)
    finally:
        tb.stop()
    for key in ("submit_expired", "depth", "abort", "queued_expired", "queued_infeasible",
                "age"):
        assert got[key].startswith("ERR ") or key in ("submit_expired", "depth"), got[key]
        assert error_is_retryable(got[key]), (key, got[key])
        assert _mask(got[key]) == _mask(want[key]), key
    assert "deadline exceeded mid-decode" in got["abort"]
    assert "deadline expired after" in got["queued_expired"]
    assert "deadline infeasible" in got["queued_infeasible"]
    # premium (weight 16) drains ahead of batch (weight 1) at a 2-token quantum
    assert got["drr_order"] == want["drr_order"] == [2, 3, 0, 1]
    assert got["drr"] == [([int(t) for t in toks], end) for toks, end in want["drr"]]
    assert all(end == "length" and len(toks) == 3 for toks, end in got["drr"])
    for key in ("abort_tokens_lt_50", "queued_expired_occupier",
                "queued_infeasible_occupier", "age_occupier", "shed_causes",
                "cancel_deadline", "free_back", "tenants"):
        assert got[key] == want[key], key
    assert got["shed_causes"] == {"deadline": 3, "depth": 1, "age": 1}
    assert got["free_back"] and got["cancel_deadline"] == 1


def test_deadline_estimate_equals_jax(model):
    """The feasibility estimate from the same rate EWMAs, across prompt
    lengths, token floors and max_tokens."""
    cfg, params, tparams = model
    tb = ContinuousBatcher(tparams, TConfig.tiny(n_layers=2, max_seq_len=MAX_SEQ), max_slots=1)
    jb = JBatcher.__new__(JBatcher)  # only the estimate's fields are read
    for rate, spt, floor in ((0.0, 0.0, 1), (0.0, 0.004, 3), (900.0, 0.002, 8), (50.0, 0.1, 1)):
        for b in (tb, jb):
            b._prefill_rate_ewma, b._decode_spt_ewma, b.deadline_min_tokens = rate, spt, floor
        for n, mt in ((3, 1), (40, 16), (500, 4)):
            jr = type("R", (), {"prompt_ids": [0] * n, "sp": JSamplingParams(max_tokens=mt)})
            tr = type("R", (), {"prompt_ids": [0] * n, "sp": SamplingParams(max_tokens=mt)})
            assert tb._estimate_serve_s(tr) == JBatcher._estimate_serve_s(jb, jr)


# -- supervision (port only) ----------------------------------------------------


class _Crash(BaseException):
    """A fault that escapes the loop's dispatch handlers (they catch
    Exception): the owner thread ends, as on a real pump crash."""


def _arm(batcher, exc, program="_decode_pos_pallas", times=1):
    """Make ``program`` raise ``exc`` on its next ``times`` calls."""
    orig = getattr(batcher, program)
    left = [times]

    def faulty(*a, **kw):
        if left[0] > 0:
            left[0] -= 1
            raise exc
        return orig(*a, **kw)

    setattr(batcher, program, faulty)


class _Served:
    """A broker, the torch Worker (supervisor every 50 ms) over a CPU
    TorchRegistry on the tiny GGUF, pulled in by file URL, and a client."""

    def __init__(self, tmp_path, **reg_kw):
        self.tmp_path, self.reg_kw = tmp_path, reg_kw

    async def __aenter__(self):
        src = _export(self.tmp_path / "src")
        self.url = f"file://{src}"
        self.broker = await EmbeddedBroker().start()
        store = ModelStore(self.tmp_path / "models", url_schemes=("file",))
        self.registry = TorchRegistry(store, device="cpu", **self.reg_kw)
        cfg = WorkerConfig(nats_url=self.broker.url, supervise_interval_s=0.05,
                           engine_heartbeat_timeout_s=0.0)
        self.worker = Worker(cfg, self.registry)
        await self.worker.start()
        self.nc = await connect(self.broker.url)
        await self.pull()
        return self

    async def __aexit__(self, *exc):
        await self.nc.close()
        await self.worker.drain()
        await self.registry.close()
        await self.broker.stop()

    async def pull(self):
        env = json.loads((await self.nc.request(
            "lmstudio.pull_model", json.dumps({"identifier": self.url}).encode(),
            timeout=30)).payload)
        assert env["ok"], env
        self.mid = "downloads/m"  # a file:// pull files it under downloads/<stem>

    async def chat(self, content="tell me about ships", n=6):
        body = {"model": self.mid, "messages": [{"role": "user", "content": content}],
                "temperature": 0, "max_tokens": n}
        return json.loads((await self.nc.request(
            "lmstudio.chat_model", json.dumps(body).encode(), timeout=30)).payload)

    async def engine(self):
        return await self.registry.get_engine(self.mid)

    async def wait(self, pred, what, timeout=20.0):
        t_end = time.monotonic() + timeout
        while not pred():
            assert time.monotonic() < t_end, f"timed out waiting for {what}"
            await asyncio.sleep(0.02)


@async_test
async def test_crash_restart_then_same_greedy_text(tmp_path):
    async with _Served(tmp_path, restart_backoff_s=0.01) as h:
        first = await h.chat()
        assert first["ok"], first
        eng = await h.engine()
        ref = weakref.ref(eng.batcher._kv[0])
        _arm(eng.batcher, _Crash("injected fault"))
        env = await h.chat()
        assert not env["ok"] and "engine crashed (_Crash: injected fault)" in env["error"]
        assert env.get("retryable") is True and error_is_retryable(env["error"])
        await h.wait(lambda: h.registry.engine_restarts_total == 1, "the restart")
        del eng
        gc.collect()
        assert ref() is None  # the crashed loop's pool went with the unload
        again = await h.chat()
        assert again["ok"], again
        assert (again["data"]["response"]["choices"][0]["message"]
                == first["data"]["response"]["choices"][0]["message"])
        health = json.loads((await h.nc.request("lmstudio.health", b"", timeout=10)).payload)
        e = health["data"]["engines"][h.mid]
        assert e["alive"] and e["crashed"] is None and e["brownout_level"] == 0
        assert "poisoned" not in health["data"]
        text = h.worker.render_prometheus()
        assert re.search(r"^lmstudio_engine_restarts_total\{[^}]*\} 1$", text, re.M)
        assert re.search(r"^lmstudio_inflight_failed_retryable_total\{[^}]*\} 1$", text, re.M)


@async_test
async def test_repeated_crashes_poison_until_pull_or_delete(tmp_path):
    async with _Served(tmp_path, restart_backoff_s=0.01, max_restarts=1) as h:
        for outcome_restarts in (1, 1):  # the second crash is past max_restarts=1
            assert (await h.chat())["ok"]
            _arm((await h.engine()).batcher, _Crash("again"))
            assert not (await h.chat())["ok"]
            await h.wait(lambda: h.registry.poisoned_models() or
                         h.registry.engine_restarts_total == outcome_restarts
                         and h.mid in h.registry.loaded_engines(), "restart or poison")
        await h.wait(lambda: h.registry.poisoned_models(), "the poison")
        env = await h.chat()
        assert not env["ok"] and f"model {h.mid} is poisoned (2 crashes in 120s" in env["error"]
        assert env.get("retryable") is True
        health = json.loads((await h.nc.request("lmstudio.health", b"", timeout=10)).payload)
        assert health["data"]["poisoned"] == [h.mid]
        await h.pull()  # a pull resets it
        assert not h.registry.poisoned_models()
        assert (await h.chat())["ok"]
        _arm((await h.engine()).batcher, _Crash("once more"))
        h.registry.max_restarts = 0
        assert not (await h.chat())["ok"]
        await h.wait(lambda: h.registry.poisoned_models(), "the poison")
        env = json.loads((await h.nc.request(
            "lmstudio.delete_model", json.dumps({"model_id": h.mid}).encode(),
            timeout=10)).payload)
        assert env["ok"], env  # a delete resets it too
        assert not h.registry.poisoned_models()
        env = await h.chat()
        assert not env["ok"] and env["error"].startswith("model not found")


@async_test
async def test_context_killing_cuda_error_poisons_at_once(tmp_path):
    async with _Served(tmp_path, restart_backoff_s=0.01) as h:
        assert (await h.chat())["ok"]
        err = RuntimeError("CUDA error: an illegal memory access was encountered")
        _arm((await h.engine()).batcher, err)
        env = await h.chat()
        assert not env["ok"] and "illegal memory access" in env["error"]
        await h.wait(lambda: h.registry.poisoned_models(), "the poison")
        assert h.registry.engine_restarts_total == 0  # no reload was spent on it
        why = h.registry.poisoned_models()[h.mid]
        assert why.startswith("CUDA context lost (RuntimeError: CUDA error: an illegal")
        env = await h.chat()
        assert "is poisoned (CUDA context lost" in env["error"]
        health = json.loads((await h.nc.request("lmstudio.health", b"", timeout=10)).payload)
        assert health["data"]["poisoned"] == [h.mid]
        assert "illegal memory access" in health["data"]["poisoned_reasons"][h.mid]
