"""The port's chaos harness, connection events, ``chat`` command and pool
settings against the JAX package, on the CPU.

* ``faults.plan_from_env``: the same rules, sites and grammar errors as the
  JAX package's copy.
* C2: a torch worker whose connection the broker severs reconnects, and
  ``lmstudio.events`` returns its ``client_reconnect`` with the keys the
  JAX worker's carries (``url``, ``attempts``, ``seconds``).
* ``tests/test_faults.py``'s acceptance flow against a torch worker on
  ``device="cpu"``: one seeded plan severs the requester's connection on
  the third chat publish and raises inside the batcher's pump loop; every
  chat completes (reconnect, retry, supervised restart), a crash mid-flight
  fails its chat retryably, and the reconnect and restart families reach
  the exposition.
* ``python -m nats_llm_studio_tpu_torch chat``, in-process against a torch
  worker on an embedded broker: the unary and the streamed answer are the
  worker's own.
* ``KV_BLOCK_TOKENS`` and ``KV_POOL_BLOCKS`` reach the batcher's block size
  and pool, and the admission estimate prices exactly the pool allocated.
"""

import asyncio
import json
import threading
import time

import pytest

from conftest import async_test
from fakes import FakeRegistry
from nats_llm_studio_tpu.config import WorkerConfig as JWorkerConfig
from nats_llm_studio_tpu.serve.worker import Worker as JWorker
from nats_llm_studio_tpu.transport import EmbeddedBroker as JBroker
from nats_llm_studio_tpu.transport import connect as jconnect
from nats_llm_studio_tpu.transport import faults as jfaults
from nats_llm_studio_tpu_torch.__main__ import main
from nats_llm_studio_tpu_torch.config import WorkerConfig
from nats_llm_studio_tpu_torch.parallel.memory import kv_pool_block_bytes
from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
from nats_llm_studio_tpu_torch.serve.worker import Worker
from nats_llm_studio_tpu_torch.store import ModelStore
from nats_llm_studio_tpu_torch.transport import EmbeddedBroker, RetryPolicy, connect
from nats_llm_studio_tpu_torch.transport import faults
from test_torch_serve import MID, _export


async def _wait_for(pred, timeout=15.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _chat_body(text, max_tokens=6, stream=False):
    return json.dumps({"model": MID, "messages": [{"role": "user", "content": text}],
                       "max_tokens": max_tokens, "temperature": 0.0,
                       "stream": stream}).encode()


@pytest.mark.parametrize("spec", [
    "sever@broker.publish:3:subject=lmstudio.chat_model;raise@batcher.pump:40",
    "drop@tier.fetch:0;delay@client.connect:1:delay=0.5;raise@batcher.suspend:2:msg=boom",
    "sever@broker.publish:0:client=tpu-worker-w-*;drop@tier.spill:4",
    "explode@batcher.pump:1", "raise@nowhere:1", "raise@batcher.pump", "drop@tier.fetch:0:x=1",
])
def test_plan_from_env_equals_jax(spec):
    env = {"CHAOS_SPEC": spec, "CHAOS_SEED": "7"}
    try:
        want = jfaults.plan_from_env(env).describe()
    except ValueError as e:
        with pytest.raises(ValueError) as ei:
            faults.plan_from_env(env)
        assert str(ei.value) == str(e)
        return
    assert faults.plan_from_env(env).describe() == want
    assert faults.SITES == jfaults.SITES and faults.KINDS == jfaults.KINDS


async def _reconnect_event(broker_cls, worker_cls, cfg_cls, connect_fn, fmod, registry):
    """Sever the worker's connection on its first publish (a health reply)
    and read its ``client_reconnect`` back over ``lmstudio.events``."""
    broker = await broker_cls().start()
    fmod.install(fmod.FaultPlan().sever_worker("w-c2", 0))
    try:
        cfg = cfg_cls(nats_url=broker.url, worker_id="w-c2", supervise_interval_s=0.0,
                      cluster_advert_interval_s=0.0, reconnect_wait_s=0.02,
                      reconnect_max_wait_s=0.1)
        worker = worker_cls(cfg, registry)
        await worker.start()
        nc = await connect_fn(broker.url)
        with pytest.raises(asyncio.TimeoutError):
            await nc.request("lmstudio.health", b"", timeout=0.5)  # the reply is lost
        await _wait_for(lambda: worker.nc.reconnects >= 1, what="worker reconnect")
        reply = json.loads((await nc.request("lmstudio.events",
                                             b'{"kind": "client_reconnect"}',
                                             timeout=5)).payload)
        await nc.close()
        await worker.drain()
        return reply["data"]["events"][-1]
    finally:
        fmod.clear()
        await broker.stop()


@async_test
async def test_worker_reconnect_lands_on_the_event_ring_as_jax(tmp_path):
    want = await _reconnect_event(JBroker, JWorker, JWorkerConfig, jconnect, jfaults,
                                  FakeRegistry())
    reg = TorchRegistry(ModelStore(tmp_path / "models"), device="cpu")
    got = await _reconnect_event(EmbeddedBroker, Worker, WorkerConfig, connect, faults, reg)
    assert got["kind"] == want["kind"] == "client_reconnect"
    assert set(got) == set(want)
    assert {"url", "attempts", "seconds"} <= set(got)
    assert got["attempts"] >= 1 and got["seconds"] > 0


@async_test
async def test_chaos_sever_and_pump_crash_full_recovery(tmp_path):
    models = tmp_path / "models"
    _export(models)
    broker = await EmbeddedBroker().start()
    try:
        reg = TorchRegistry(ModelStore(models), device="cpu", max_batch_slots=2, max_seq_len=64,
                            restart_backoff_s=0.05, restart_backoff_max_s=0.2, max_restarts=10,
                            restart_window_s=60.0)
        worker = Worker(WorkerConfig(nats_url=broker.url, supervise_interval_s=0.1,
                                     engine_heartbeat_timeout_s=0.0), reg)
        await worker.start()
        nc = await connect(broker.url, reconnect_wait_s=0.02, reconnect_max_wait_s=0.2)
        env = json.loads((await nc.request("lmstudio.chat_model", _chat_body("warmup"),
                                           timeout=60)).payload)
        assert env["ok"] is True, env
        plan = faults.install(
            faults.FaultPlan(seed=11)
            .sever(faults.BROKER_PUBLISH, 2, subject="lmstudio.chat_model")
            .raise_at(faults.PUMP, 8, message="chaos pump fault"))
        retry = RetryPolicy(max_attempts=12, backoff_s=0.2, max_backoff_s=1.0,
                            retry_on_timeout=True)
        for i in range(6):
            msg = await nc.request("lmstudio.chat_model", _chat_body(f"request {i}"),
                                   timeout=30, retry=retry)
            env = json.loads(msg.payload)
            assert env["ok"] is True, (i, env)
            assert env["data"]["response"]["object"] == "chat.completion"
        assert plan.done(), plan.describe()
        assert nc.reconnects >= 1 and reg.engine_restarts_total >= 1

        # a crash mid-request: the chat fails retryably, the engine restarts
        restarts = reg.engine_restarts_total
        faults.install(faults.FaultPlan().raise_at(faults.PUMP, 0, message="mid-flight"))
        env = json.loads((await nc.request("lmstudio.chat_model",
                                           _chat_body("victim", max_tokens=50),
                                           timeout=30)).payload)
        assert env["ok"] is False and env["retryable"] is True, env
        assert "retry on another worker" in env["error"]
        await _wait_for(lambda: reg.engine_restarts_total > restarts, what="restart")
        health = json.loads((await nc.request("lmstudio.health", b"", timeout=10)).payload)
        assert health["data"]["engines"][MID]["alive"] is True
        assert health["data"]["engines"][MID]["ready"] is True
        prom = (await nc.request("lmstudio.metrics.prom", b"", timeout=10)).payload.decode()

        def value(family):
            rows = [ln for ln in prom.splitlines() if ln.startswith(family)]
            assert rows, family
            return float(rows[0].split()[-1])

        assert "lmstudio_reconnects_total" in prom
        assert value("lmstudio_engine_restarts_total") >= 1
        assert value("lmstudio_inflight_failed_retryable_total") >= 1
        assert "lmstudio_engine_restart_ms" in prom
        await nc.close()
        await worker.drain()
        await reg.close()
    finally:
        faults.clear()
        await broker.stop()


def test_chat_command_unary_and_stream(tmp_path, monkeypatch, capsys):
    """``main(["chat", ...])`` runs its own event loop, so the broker and
    the worker serve from a second thread's loop."""
    models = tmp_path / "models"
    _export(models)
    loop = asyncio.new_event_loop()
    up = threading.Event()
    box = {}

    async def start():
        box["broker"] = await EmbeddedBroker().start()
        box["reg"] = TorchRegistry(ModelStore(models), device="cpu", max_batch_slots=2,
                                   max_seq_len=64)
        box["worker"] = Worker(WorkerConfig(nats_url=box["broker"].url,
                                            supervise_interval_s=0.0,
                                            cluster_advert_interval_s=0.0), box["reg"])
        await box["worker"].start()
        nc = await connect(box["broker"].url)
        msg = await nc.request("lmstudio.chat_model", _chat_body("say hi", max_tokens=5),
                               timeout=60)
        box["want"] = json.loads(msg.payload)["data"]["response"]["choices"][0]["message"]
        await nc.close()

    async def stop():
        await box["worker"].drain()
        await box["reg"].close()
        await box["broker"].stop()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(start())
        up.set()
        loop.run_forever()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        assert up.wait(60), "worker did not start"
        monkeypatch.setenv("NATS_URL", box["broker"].url)
        args = ["chat", MID, "say hi", "--max-tokens", "5", "--temperature", "0"]
        assert main(args) == 0
        unary = capsys.readouterr().out
        assert main(args + ["--stream"]) == 0
        streamed = capsys.readouterr().out
        assert unary == streamed == box["want"]["content"] + "\n"
        assert main(["chat", "no/such-model", "hi"]) == 1
        assert "model not found" in capsys.readouterr().err
    finally:
        asyncio.run_coroutine_threadsafe(stop(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        t.join(10)
        loop.close()


@async_test
async def test_kv_block_and_pool_settings_reach_the_batcher_and_the_estimate(
        tmp_path, monkeypatch):
    models = tmp_path / "models"
    path = _export(models)
    monkeypatch.setenv("KV_BLOCK_TOKENS", "32")
    monkeypatch.setenv("KV_POOL_BLOCKS", "7")
    cfg = WorkerConfig()
    assert (cfg.kv_block_tokens, cfg.kv_pool_blocks) == (32, 7)
    reg = TorchRegistry(ModelStore(models), device="cpu", max_batch_slots=2, max_seq_len=128)
    try:
        b = (await reg.get_engine(MID)).batcher
        pool = b.pool_stats()
        assert b.kv_block_tokens == 32 and pool["blocks_total"] == 7
        # the estimate prices the pool the batcher allocated: 7 + the null block
        est = reg._estimate([str(path)])
        assert est["kv_pool"] == pool["bytes"] == 8 * kv_pool_block_bytes(b.cfg, 32)
    finally:
        await reg.close()
    monkeypatch.delenv("KV_POOL_BLOCKS")
    reg = TorchRegistry(ModelStore(models), device="cpu", max_batch_slots=2, max_seq_len=128,
                        prefix_cache_blocks=4)
    try:
        b = (await reg.get_engine(MID)).batcher
        # the default population: every slot at max_seq plus the prefix budget
        assert b.pool_stats()["blocks_total"] == 2 * 128 // 32 + 4
        assert reg._estimate([str(path)])["kv_pool"] == b.pool_stats()["bytes"]
    finally:
        await reg.close()
