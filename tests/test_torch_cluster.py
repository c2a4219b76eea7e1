"""Cluster membership in the port against the JAX package, on the CPU.

* ``prompt_head_hash`` equals the JAX one; the port's ``ClusterRouter``
  makes the JAX router's picks on the same advert sequence
  (``tests/test_cluster.py``'s ranking, staleness and role cases).
* Two torch workers (``device="cpu"``, the tiny GGUF) on one broker: their
  adverts have the JAX worker's keys and types (built over the same
  registry) and the JAX ``ClusterRouter`` ingests them and steers a chat to
  one; the port's ``RouterProcess`` (``route.chat_model``, a repeated
  prompt steered to the worker whose ``heads`` hold it), the port's gateway
  (unary and SSE) and a direct ``chat_model`` give the same greedy text;
  the embedded aggregator's merged exposition carries both workers'
  ``lmstudio_mfu``/``lmstudio_mbu``; the excluded-workers bounce and the
  draining bounce equal a JAX worker's envelopes byte for byte (ids
  aside), as does ``kv_export``'s ``no_export``; a drain mid-stream ends
  the stream with the retryable draining envelope and the retry is served
  by the other worker with the same text.
* ``python -m nats_llm_studio_tpu_torch route|obs|gateway`` start and serve
  a torch worker.
"""

import asyncio
import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from conftest import async_test
from fakes import FakeRegistry
from nats_llm_studio_tpu.config import WorkerConfig as JWorkerConfig
from nats_llm_studio_tpu.serve import router as jrouter
from nats_llm_studio_tpu.serve.worker import Worker as JWorker
from nats_llm_studio_tpu.transport import connect as jconnect
from nats_llm_studio_tpu_torch import __main__ as cli
from nats_llm_studio_tpu_torch.config import WorkerConfig
from nats_llm_studio_tpu_torch.gateway import Gateway
from nats_llm_studio_tpu_torch.obs import Aggregator
from nats_llm_studio_tpu_torch.serve import router as trouter
from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
from nats_llm_studio_tpu_torch.serve.router import RouterProcess
from nats_llm_studio_tpu_torch.serve.worker import Worker
from nats_llm_studio_tpu_torch.store import ModelStore
from nats_llm_studio_tpu_torch.transport import EmbeddedBroker, RetryPolicy, connect
from nats_llm_studio_tpu_torch.transport import protocol as p
from test_torch_serve import MID, _export

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("model,messages,chars", [
    ("m", [{"role": "u", "content": "ab"}, {"role": "u", "content": "c"}], 256),
    ("m2", [{"role": "user", "content": "hello " * 80}], 256),
    ("m", [{"role": "user", "content": "abcdXY"}], 4),
    ("m", None, 256),
    ("m", "not-a-list", 0),
])
def test_prompt_head_hash_equals_jax(model, messages, chars):
    assert trouter.prompt_head_hash(model, messages, chars) == \
        jrouter.prompt_head_hash(model, messages, chars)


def test_router_picks_equal_jax():
    """``tests/test_cluster.py``'s advert sequence through both routers:
    every pick, pick_pair and counter equal."""
    msgs = [{"role": "user", "content": "the shared prompt head"}]
    head = trouter.prompt_head_hash("m", msgs)
    steps = [
        ("ingest", {"worker_id": "w-a", "queue_depth": 0, "draining": True}),
        ("ingest", {"worker_id": "w-b", "queue_depth": 9}),
        ("pick", {}), ("pick", {"excluded": ["w-b"]}),
        ("ingest", {"worker_id": "w-a", "queue_depth": 0, "brownout": 1, "draining": False}),
        ("pick", {}),
        ("ingest", {"worker_id": "w-a", "queue_depth": 0, "brownout": 0}),
        ("ingest", {"worker_id": "w-b", "queue_depth": 9, "models": ["m"]}),
        ("pick", {}),
        ("ingest", {"worker_id": "w-a", "queue_depth": 0, "models": ["m"], "heads": [head]}),
        ("pick", {}),
        ("ingest", {"worker_id": "w-a", "queue_depth": 0, "models": ["m"], "heads": [head],
                    "brownout": 2}),
        ("pick", {}),
        ("ingest", {"worker_id": "w-b", "queue_depth": 1, "models": ["m"], "seq": 10}),
        ("ingest", {"worker_id": "w-b", "queue_depth": 99, "models": [], "seq": 9}),
        ("pick", {}),
        ("ingest", {"worker_id": "w-b", "queue_depth": 3, "models": ["m"], "seq": 2}),
        ("ingest", {"worker_id": "w-c", "queue_depth": 1, "slots": 8, "models": ["m"]}),
        ("pick", {}),
        ("ingest", {"worker_id": "w-p", "queue_depth": 0, "role": "prefill"}),
        ("ingest", {"worker_id": "w-d", "queue_depth": 5, "role": "decode", "models": ["m"]}),
        ("pair", {}),
        ("dead", "w-b"), ("pick", {}), ("dead", "w-c"), ("dead", "w-a"), ("pair", {}),
        ("pair", {"excluded": ["w-d"]}),
    ]
    out = []
    for mod in (jrouter, trouter):
        r = mod.ClusterRouter(None, stale_after_s=5.0)
        got = []
        for op, arg in steps:
            if op == "ingest":
                r.ingest(dict(arg))
            elif op == "dead":
                r.mark_dead(arg)
            elif op == "pick":
                got.append(r.pick(model="m", messages=msgs, **arg))
            else:
                got.append(r.pick_pair(model="m", messages=msgs, **arg))
        got.append(r.stats.as_dict())
        got.append(sorted(m.worker_id for m in r.members()))
        out.append(got)
    assert out[1] == out[0]
    assert "w-a" in out[1][:-2] and out[1][-2]["locality_total"] >= 1


def _chat(content: str, n: int = 8, **kw) -> dict:
    return {"model": MID, "messages": [{"role": "user", "content": content}],
            "temperature": 0, "max_tokens": n, **kw}


def _text(env: dict) -> str:
    assert env["ok"], env
    return env["data"]["response"]["choices"][0]["message"]["content"]


async def _http(port: int, method: str, path: str, body: dict | None = None):
    """One HTTP/1.1 request; the gateway closes the connection after it."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                 f"Content-Length: {len(data)}\r\nConnection: close\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), head.decode(), payload


def _sse_text(payload: bytes) -> str:
    parts = []
    for line in payload.decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            ch = json.loads(line[6:])["choices"][0]
            parts.append(ch.get("delta", {}).get("content") or "")
    return "".join(parts)


async def _until(cond, timeout: float = 10.0, what: str = ""):
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, f"timed out waiting for {what}"
        await asyncio.sleep(0.02)


def _registry(models: Path) -> TorchRegistry:
    # spec decode off: each chat is alone in its batch either way
    return TorchRegistry(ModelStore(models), device="cpu", max_seq_len=512, spec_decode_k=0)


@async_test
async def test_cluster_path_on_torch_workers(tmp_path):
    models = tmp_path / "models"
    _export(models)
    broker = await EmbeddedBroker().start()
    regs = [_registry(models), _registry(models)]
    workers = [Worker(WorkerConfig(nats_url=broker.url, worker_id=w,
                                   cluster_advert_interval_s=0.05), r)
               for w, r in zip(("w-a", "w-b"), regs)]
    # the reference worker for the envelopes, on a prefix of its own
    jw = JWorker(JWorkerConfig(nats_url=broker.url, worker_id="w-jax", subject_prefix="jref",
                               queue_group="jref", cluster_advert_interval_s=0), FakeRegistry())
    for w in (*workers, jw):
        await w.start()
    nc = await connect(broker.url)
    jnc = await jconnect(broker.url)
    proc = RouterProcess(nc, retry=RetryPolicy(max_attempts=3, backoff_s=0.01))
    agg = Aggregator(nc, scrape_interval_s=0.1)
    gw = Gateway(nc, port=0)
    jr = jrouter.ClusterRouter(jnc)
    try:
        for x in (proc, agg, gw, jr):
            await x.start()

        async def req(subject, body, headers=None, timeout=30.0, retry=None):
            msg = await nc.request(subject, json.dumps(body).encode(), timeout=timeout,
                                   headers=headers, retry=retry)
            return json.loads(msg.payload), msg

        # the same greedy text straight from each worker
        chat = _chat("Tell me about the harbour.")
        text = _text((await req("lmstudio.worker.w-a.chat_model", chat))[0])
        assert _text((await req("lmstudio.worker.w-b.chat_model", chat))[0]) == text

        # adverts: the JAX worker's keys and types over the same registry,
        # ingested by the JAX router, which steers a chat to a torch worker
        mine = workers[0].build_advert()
        ref = JWorker(JWorkerConfig(worker_id="w-a"), regs[0]).build_advert()
        assert {k: type(v) for k, v in mine.items()} == {k: type(v) for k, v in ref.items()}
        assert mine["slots"] == 8 and mine["models"] == [MID] and mine["draining"] is False
        assert jrouter.WorkerAdvert.from_dict(mine).models == (MID,)
        await _until(lambda: len(jr.members()) == 2 and len(proc.router.members()) == 2,
                     what="both routers to see both workers")
        msg = await jr.request_chat(chat, timeout=30.0)
        assert (msg.headers or {}).get(p.WORKER_HEADER) in ("w-a", "w-b")
        assert _text(json.loads(msg.payload)) == text and jr.stats.routed_total == 1

        # the port's router and gateway give the same text
        assert _text((await req("lmstudio.route.chat_model", chat))[0]) == text
        status, _, body = await _http(gw.port, "POST", "/v1/chat/completions", chat)
        assert status == 200 and json.loads(body)["choices"][0]["message"]["content"] == text
        status, head, body = await _http(gw.port, "POST", "/v1/chat/completions",
                                         {**chat, "stream": True})
        assert status == 200 and "text/event-stream" in head and _sse_text(body) == text

        # locality: a prompt served by w-b is steered back to it
        local = _chat("A prompt only the second worker has seen. " * 3)
        await req("lmstudio.worker.w-b.chat_model", local)
        head_b = trouter.prompt_head_hash(MID, local["messages"])
        await _until(lambda: head_b in proc.router._members["w-b"].heads, what="w-b's heads")
        msg = await proc.router.request_chat(local, timeout=30.0)
        assert (msg.headers or {}).get(p.WORKER_HEADER) == "w-b"
        assert proc.router.stats.locality_total >= 1

        # the merged cluster exposition carries both workers' roofline gauges
        t_end = time.monotonic() + 10.0
        while True:
            prom = (await nc.request("lmstudio.cluster.metrics.prom", b"", timeout=10)).payload
            prom = prom.decode()
            if re.search(r"^lmstudio_cluster_workers 2", prom, re.M) and "lmstudio_mfu{" in prom:
                break
            assert time.monotonic() < t_end, prom[:2000]
            await asyncio.sleep(0.1)
        assert "lmstudio_mbu{" in prom and "worker_id=" not in prom

        # the excluded-workers bounce, byte for byte against the reference's
        hdr = {p.TRACE_HEADER: "t-bounce"}
        _, mine = await req("lmstudio.worker.w-a.chat_model", chat,
                            {**hdr, p.EXCLUDED_WORKERS_HEADER: "w-a"})
        _, ref = await req("jref.worker.w-jax.chat_model", chat,
                           {**hdr, p.EXCLUDED_WORKERS_HEADER: "w-jax"})
        assert mine.payload == ref.payload.replace(b"w-jax", b"w-a")
        env = json.loads(mine.payload)
        assert env["retryable"] and env["data"]["excluded_bounce"] is True
        # through the router's RetryPolicy the exclusion sends it to w-b
        msg = await proc.router.request_chat(chat, headers={p.EXCLUDED_WORKERS_HEADER: "w-a"},
                                             retry=RetryPolicy(max_attempts=3, backoff_s=0.01))
        assert (msg.headers or {}).get(p.WORKER_HEADER) == "w-b"
        assert _text(json.loads(msg.payload)) == text
        assert workers[0]._excluded_bounce_total == 1

        # kv_export: the reference's reply from an engine that cannot export
        _, mine = await req("lmstudio.worker.w-b.kv_export", {"model": MID})
        _, ref = await req("jref.worker.w-jax.kv_export", {"model": "fake-echo-1"})
        assert mine.payload == ref.payload == b'{"ok":true,"data":{"no_export":true}}'
        assert "Nats-Stream-Done" in (mine.headers or {})

        # a drain mid-stream: the cut stream ends retryably, its retry is
        # served by the other worker with the undrained text
        long = _chat("Count the ships in the harbour, one by one.", 24)
        want = _text((await req("lmstudio.worker.w-b.chat_model", long))[0])
        b = (await regs[0].get_engine(MID)).batcher
        fast = b._decode_pos_pallas

        def slow(*a, **kw):
            time.sleep(0.02)
            return fast(*a, **kw)

        b._decode_pos_pallas = slow
        frames = []

        async def stream():
            async for m in nc.request_stream("lmstudio.worker.w-a.chat_model",
                                             json.dumps({**long, "stream": True}).encode(),
                                             timeout=30.0):
                frames.append(m)

        live = asyncio.ensure_future(stream())
        await _until(lambda: frames, what="the first chunk")
        env, _ = await req("lmstudio.admin.drain", {"worker_id": "w-a", "deadline_s": 0.05})
        await live
        assert env["ok"] and env["data"]["draining"] is True
        assert env["data"]["finished_in_time"] is False and env["data"]["stopped_engines"] == [MID]
        last = json.loads(frames[-1].payload)
        assert "Nats-Stream-Done" in frames[-1].headers and len(frames) > 1
        assert not last["ok"] and last["retryable"] and "worker draining" in last["error"]
        env, msg = await req("lmstudio.chat_model", long,
                             retry=RetryPolicy(max_attempts=4, backoff_s=0.01))
        assert (msg.headers or {}).get(p.WORKER_HEADER) == "w-b" and _text(env) == want
        assert b.params is None  # the drain stopped the batcher and freed it

        # the drained worker: advertised, bounced like the reference's
        await _until(lambda: proc.router._members["w-a"].draining, what="the draining advert")
        assert proc.router.pick(model=MID) == "w-b"
        await jw.begin_drain(0.0)
        _, mine = await req("lmstudio.worker.w-a.chat_model", chat, hdr)
        _, ref = await req("jref.worker.w-jax.chat_model", chat, hdr)
        assert mine.payload == ref.payload.replace(b"w-jax", b"w-a")
        health = (await req("lmstudio.worker.w-a.health", {}))[0]["data"]
        assert health["status"] == "draining" and health["draining"] is True
        prom = workers[0].render_prometheus()
        assert re.search(r"^lmstudio_draining\{[^}]*\} 1$", prom, re.M)
        assert re.search(r"^lmstudio_drain_bounce_total\{[^}]*\} 1$", prom, re.M)
        env, _ = await req("lmstudio.admin.drain", {"worker_id": "w-a"})
        assert env["data"]["already_draining"] is True
        assert await regs[0].restart_engine(MID) == "draining"
    finally:
        for x in (gw, agg, proc, jr):
            await x.stop()
        await jnc.close()
        await nc.close()
        for w in (*workers, jw):
            await w.drain()
        for r in regs:
            await r.close()
        await broker.stop()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_roles_and_autoscale_are_refused():
    with pytest.raises(ValueError, match="WORKER_ROLE='decode'"):
        WorkerConfig(worker_role="decode")
    with pytest.raises(SystemExit, match="autoscaler"):
        cli._refuse_autoscale(WorkerConfig(obs_autoscale=True))


def test_cli_route_obs_and_gateway_serve_a_torch_worker(tmp_path):
    """Three processes start (each imports torch): a longer budget than
    ``async_test``'s, for a loaded host; a few seconds when idle."""
    asyncio.run(asyncio.wait_for(_cli_commands(tmp_path), timeout=180.0))


async def _cli_commands(tmp_path):
    models = tmp_path / "models"
    _export(models)
    broker = await EmbeddedBroker().start()
    reg = _registry(models)
    worker = Worker(WorkerConfig(nats_url=broker.url, worker_id="w-cli",
                                 cluster_advert_interval_s=0.05), reg)
    await worker.start()
    nc = await connect(broker.url)
    port = _free_port()
    env = {**os.environ, "NATS_URL": broker.url, "GATEWAY_PORT": str(port),
           "OBS_SCRAPE_INTERVAL_S": "0.2", "PYTHONPATH": str(ROOT)}
    cmds = ("route", "obs", "gateway")
    # logs to files: a full pipe would block a process that logs a lot
    logs = [open(tmp_path / f"{cmd}.log", "wb") for cmd in cmds]
    procs = [subprocess.Popen([sys.executable, "-m", "nats_llm_studio_tpu_torch", cmd],
                              cwd=tmp_path, env=env, stdout=log, stderr=subprocess.STDOUT)
             for cmd, log in zip(cmds, logs)]
    try:
        chat = _chat("hello there")
        direct = _text(json.loads((await nc.request("lmstudio.worker.w-cli.chat_model",
                                                    json.dumps(chat).encode(), timeout=30)
                                   ).payload))
        t_end = time.monotonic() + 150.0
        while True:  # the three processes come up (torch imports take seconds)
            assert all(pr.poll() is None for pr in procs), [pr.poll() for pr in procs]
            try:
                status, _, body = await _http(port, "POST", "/v1/chat/completions", chat)
                if status == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < t_end, "the gateway did not come up"
            await asyncio.sleep(0.2)
        assert json.loads(body)["choices"][0]["message"]["content"] == direct
        msg = await nc.request("lmstudio.route.chat_model", json.dumps(chat).encode(),
                               timeout=30.0)
        assert _text(json.loads(msg.payload)) == direct
        while True:
            try:
                prom = (await nc.request("lmstudio.cluster.metrics.prom", b"",
                                         timeout=2.0)).payload.decode()
                if re.search(r"^lmstudio_cluster_workers 1", prom, re.M) \
                        and "lmstudio_mfu{" in prom:
                    break
            except asyncio.TimeoutError:
                pass
            assert time.monotonic() < t_end, "the aggregator did not scrape the worker"
            await asyncio.sleep(0.2)
    finally:
        for pr in procs:
            pr.terminate()
        for pr, cmd, log in zip(procs, cmds, logs):
            try:
                rc = pr.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pr.kill()
                rc = pr.wait()
            log.close()
            assert rc == 0, (tmp_path / f"{cmd}.log").read_text()[-2000:]
        await nc.close()
        await worker.drain()
        await reg.close()
        await broker.stop()
