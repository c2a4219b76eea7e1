"""The port's observability surfaces against the JAX package, on the CPU.

* Pure-Python copies, equal outputs on the same inputs: ``Trace.report``
  (with an injected monotonic clock), ``PromRenderer`` text, and the
  ``FlightRecorder``'s frames and dump document.
* ``metrics.prom``: the same greedy chats, a deadline shed and a tenant's
  chat through a JAX ``LocalRegistry`` and a ``TorchRegistry(device=
  "cpu")`` on the same tiny GGUF, rendered by each package's ``Worker``:
  the port's exposition holds every family the JAX worker renders except
  the named families of features not ported yet, and its lines parse as
  Prometheus text.
* The torch ``Worker`` over NATS: ``X-Priority`` and ``X-Tenant`` are
  served (tenant rows in the exposition) while ``X-KV-Prefill-Worker`` is
  still refused by name; a chat's ``stats.trace`` holds its stages in
  order under the envelope's ``trace_id`` and a ``worker.serve`` span
  lands on ``obs.spans``; ``X-Deadline-Ms`` already past is shed
  retryably; ``health`` carries ``engines``; ``events``, ``metrics``
  (devices), ``profile`` (a Chrome trace file), ``debug.snapshot`` (slot
  table refcounts equal to the pool's) and ``debug.dump`` (a file under
  ``OBS_DUMP_DIR``) answer, and a worker without ``DEBUG_SUBJECTS`` has no
  debug subjects.
"""

import asyncio
import json
import os
import re
import time

import pytest

from conftest import async_test
from nats_llm_studio_tpu.config import WorkerConfig as JWorkerConfig
from nats_llm_studio_tpu.obs import prom as jprom
from nats_llm_studio_tpu.obs import recorder as jrecorder
from nats_llm_studio_tpu.obs import trace as jtrace
from nats_llm_studio_tpu.obs.histogram import LogHistogram as JHist
from nats_llm_studio_tpu.serve.registry import LocalRegistry
from nats_llm_studio_tpu.serve.worker import Worker as JWorker
from nats_llm_studio_tpu.store import ModelStore as JModelStore
from nats_llm_studio_tpu_torch.config import WorkerConfig
from nats_llm_studio_tpu_torch.obs import prom as tprom
from nats_llm_studio_tpu_torch.obs import recorder as trecorder
from nats_llm_studio_tpu_torch.obs import trace as ttrace
from nats_llm_studio_tpu_torch.obs.histogram import LogHistogram as THist
from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
from nats_llm_studio_tpu_torch.serve.worker import Worker
from nats_llm_studio_tpu_torch.store import JetStreamStoreModule, ModelStore
from nats_llm_studio_tpu_torch.transport import EmbeddedBroker, connect
from nats_llm_studio_tpu_torch.transport.envelope import deadline_header_value
from test_torch_serve import MID, _export

# families the JAX worker renders for features the port does not have yet,
# each with the ROADMAP Queue A item it waits for
NOT_PORTED = {
    # item 3: disaggregated prefill (roles, KV transfer, warm handoff); item
    # 7: the legacy ring
    "lmstudio_worker_role", "lmstudio_kv_transfer_bytes_total",
    "lmstudio_kv_transfer_ms_total", "lmstudio_kv_transfer_failures_total",
    "lmstudio_warm_handoff_sent_total", "lmstudio_warm_handoff_received_total",
    "lmstudio_batcher_ring_compactions_total",
    # item 6: the serving mesh
    "lmstudio_mesh_tp", "lmstudio_mesh_dp", "lmstudio_mesh_ep", "lmstudio_mesh_sp",
    # item 5: XLA's compile cache and recompiles, and its kernel choice
    # (the port has one decode kernel and no compile cache yet)
    "lmstudio_compile_cache_hits_total", "lmstudio_compile_cache_misses_total",
    "lmstudio_decode_recompiles_total", "lmstudio_batcher_decode_recompiles_total",
    "lmstudio_decode_kernel_pallas",
}

_PROM_LINE = re.compile(
    r'^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+'
    r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*",?)*\})? '
    r'[-+]?([0-9.]+([eE][-+]?[0-9]+)?|Inf|NaN))$')


def families(text: str) -> set[str]:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def assert_parses(text: str) -> None:
    bad = [line for line in text.splitlines() if line and not _PROM_LINE.match(line)]
    assert not bad, bad[:5]


# -- pure-Python copies -------------------------------------------------------


@pytest.mark.parametrize("stages", [
    ("recv", "enqueue", "admit", "prefill", "first_token", "decode_done", "publish"),
    ("recv", "publish"),
    ("enqueue", "admit", "custom_b", "first_token", "custom_a"),
])
def test_trace_report_equals_jax(stages):
    """The same marks at the same monotonic times (a stage marked twice
    keeps its first), with attempt and parent span: equal reports."""
    j = jtrace.Trace("abc123", attempt=2, parent_span_id="p1")
    t = ttrace.Trace("abc123", attempt=2, parent_span_id="p1")
    t.span_id = j.span_id
    for i, stage in enumerate(stages):
        for tr in (j, t):
            tr.mark(stage, 1000.0 + 0.0123 * i * i)
            tr.mark(stage, 5000.0)
    assert t.report() == j.report()
    for v in ("00-abc-def-01", "bad", None, "00--x-01"):
        assert ttrace.parse_span_context(v) == jtrace.parse_span_context(v)
    assert ttrace.span_context_value("a", "b") == jtrace.span_context_value("a", "b")


@pytest.mark.parametrize("values", [[], [0.5, 3.0, 3.0, 1e3], [7.25] * 5 + [1e8]])
def test_prom_renderer_text_equals_jax(values):
    out = []
    for prom, hist in ((jprom, JHist), (tprom, THist)):
        r = prom.PromRenderer(default_labels={"worker_id": "w-1"})
        h = hist()
        for v in values:
            h.record(v)
        r.counter("lmstudio_requests_total", 3, help="NATS requests")
        r.gauge("lmstudio_brownout_level", 1, labels={"model": 'a/"b"\n'})
        r.histogram("lmstudio_ttft_ms", h.snapshot(), labels={"model": "m"}, help="ttft")
        r.histogram("lmstudio_ttft_ms", h.snapshot(), labels={"model": "n"})
        r.gauge("lmstudio_uptime_seconds", 1.5)
        out.append(r.render())
    assert out[1] == out[0]
    assert_parses(out[1])


@pytest.mark.parametrize("n_frames", [0, 3, 700])
def test_flight_recorder_frames_and_dump_equal_jax(tmp_path, n_frames):
    """The same frames sampled at the same clock into both recorders: equal
    rings, tails and dumps (wall-clock stamps aside)."""
    docs = []
    for mod, d in ((jrecorder, tmp_path / "j"), (trecorder, tmp_path / "t")):
        rec = mod.FlightRecorder(capacity=600, interval_ms=10.0, dump_dir=str(d),
                                 engine="e", worker_id="w", counter_fns={"c": lambda: 7})
        assert rec.due(1.0)
        for i in range(n_frames):
            rec.sample({"queue_depth": i % 5, "active_slots": i % 3}, now=1.0 + 0.01 * i)
        frames = [{k: v for k, v in f.items() if k != "ts"} for f in rec.frames(last_s=2.0)]
        tail = [{k: v for k, v in f.items() if k != "ts"} for f in rec.tail(4)]
        path = rec.dump("debug_request", extra={"model": "m"}, force=True)
        assert rec.dump("again") is None  # rate-limited
        doc = json.loads(open(path).read())
        assert os.path.basename(path).startswith("flight-") and path.endswith("-debug_request.json")
        doc = {k: v for k, v in doc.items() if k not in ("ts", "mono", "events")}
        doc["frames"] = [{k: v for k, v in f.items() if k != "ts"} for f in doc["frames"]]
        docs.append((rec.frames_sampled, frames, tail, doc))
    assert docs[1] == docs[0]


# -- metrics.prom against the JAX worker ----------------------------------------


async def _traffic(registry, deadline_ok: bool):
    """Two greedy chats, a deadline already past (shed), a tenant's chat."""
    eng = await registry.get_engine(MID)
    msgs = [{"role": "user", "content": "hello there"}]
    for _ in range(2):
        await eng.chat({"model": MID, "messages": list(msgs), "temperature": 0, "max_tokens": 4})
    with pytest.raises(Exception, match="deadline already expired at submit"):
        await eng.chat({"model": MID, "messages": list(msgs), "max_tokens": 4,
                        "_deadline": time.monotonic() - 1.0})
    await eng.chat({"model": MID, "messages": list(msgs), "temperature": 0, "max_tokens": 4,
                    "_tenant": "acme", "_priority": "premium"})


@async_test
async def test_prometheus_families_cover_the_jax_worker(tmp_path, monkeypatch):
    monkeypatch.setenv("KV_PAGED", "1")
    models = tmp_path / "models"
    _export(models)
    jreg = LocalRegistry(JModelStore(models), dtype="float32", max_seq_len=512,
                         max_batch_slots=2, prefix_cache_blocks=8, spec_decode_k=0)
    treg = TorchRegistry(ModelStore(models), device="cpu", max_seq_len=512,
                         max_batch_slots=2, prefix_cache_blocks=8, spec_decode_k=0)
    try:
        await _traffic(jreg, True)
        await _traffic(treg, True)
        want = JWorker(JWorkerConfig(), jreg).render_prometheus()
        got = Worker(WorkerConfig(), treg).render_prometheus()
    finally:
        for eng in list(jreg.loaded_engines().values()):
            await eng.unload()
        await treg.close()
    assert_parses(got)
    missing = families(want) - families(got) - NOT_PORTED
    assert not missing, sorted(missing)
    extra = families(got) - families(want)
    assert not extra, sorted(extra)
    assert NOT_PORTED & families(want)  # the list names real families
    for line in ('lmstudio_deadline_shed_total{model="test/tiny"', 'tenant="acme"',
                 'lmstudio_brownout_level{model="test/tiny"'):
        assert line in got
    assert re.search(r'^lmstudio_batcher_shed_by_cause_total\{cause="deadline",'
                     r'model="test/tiny",worker_id="[^"]+"\} 1$', got, re.M)


# -- the torch worker over NATS ---------------------------------------------------


@async_test
async def test_worker_subjects_headers_and_trace(tmp_path):
    models = tmp_path / "models"
    _export(models)
    dumps = tmp_path / "dumps"
    broker = await EmbeddedBroker().start()
    JetStreamStoreModule(broker).install()  # the profiles bucket
    registry = TorchRegistry(ModelStore(models), device="cpu", max_seq_len=512,
                             obs_dump_dir=str(dumps), obs_recorder_interval_ms=1.0)
    worker = Worker(WorkerConfig(nats_url=broker.url, debug_subjects=True), registry)
    await worker.start()
    nc = await connect(broker.url)
    plain = None
    try:
        async def req(subject, body=b"", headers=None, timeout=15.0):
            msg = await nc.request(subject, body if isinstance(body, bytes)
                                   else json.dumps(body).encode(), timeout=timeout,
                                   headers=headers)
            return msg

        spans = []
        sub = await nc.subscribe("lmstudio.obs.spans")
        body = {"model": MID, "messages": [{"role": "user", "content": "hi there"}],
                "temperature": 0, "max_tokens": 5}
        hdrs = {"X-Priority": "premium", "X-Tenant": "acme", "X-Trace-Id": "t-123"}
        env = json.loads((await req("lmstudio.chat_model", body, hdrs)).payload)
        assert env["ok"], env
        assert env["trace_id"] == "t-123"
        tr = env["data"]["response"]["stats"]["trace"]
        assert tr["trace_id"] == "t-123"
        order = ["recv", "enqueue", "admit", "prefill", "first_token", "decode_done", "publish"]
        assert list(tr["marks_ms"]) == order
        assert [tr["marks_ms"][s] for s in order] == sorted(tr["marks_ms"].values())
        assert set(tr["spans_ms"]) >= {"queue_ms", "prefill_ms", "first_token_ms",
                                       "decode_ms", "publish_ms", "total_ms"}
        span_msg = await sub.next_msg(timeout=5.0)
        spans = json.loads(span_msg.payload)["spans"]
        assert spans[0]["trace_id"] == "t-123" and spans[0]["stage"] == "worker.serve"
        assert spans[0]["attrs"]["outcome"] == "ok"

        env = json.loads((await req("lmstudio.chat_model", body,
                                    {"X-KV-Prefill-Worker": "w-other"})).payload)
        assert not env["ok"] and "unsupported header 'X-KV-Prefill-Worker'" in env["error"]
        env = json.loads((await req("lmstudio.chat_model", body,
                                    {"X-Deadline-Ms": deadline_header_value(-1.0)})).payload)
        assert not env["ok"] and env.get("retryable") is True
        assert "deadline already expired at submit (shed_cause=deadline)" in env["error"]

        health = json.loads((await req("lmstudio.health")).payload)["data"]
        e = health["engines"][MID]
        assert e["alive"] and e["ready"] and e["crashed"] is None
        assert e["brownout_level"] == 0 and e["heartbeat_age_s"] >= 0
        assert "poisoned" not in health

        metrics = json.loads((await req("lmstudio.metrics")).payload)["data"]
        assert metrics["devices"] == [{"id": 0, "platform": "cpu", "kind": "cpu"}]
        assert metrics["engines"][MID]["shed_causes"] == {"deadline": 1}

        text = (await req("lmstudio.metrics.prom")).payload.decode()
        assert_parses(text)
        assert re.search(r'^lmstudio_tenant_served_total\{model="test/tiny",tenant="acme",'
                         r'worker_id="[^"]+"\} 1$', text, re.M)

        ev = json.loads((await req("lmstudio.events", {"kind": "shed"})).payload)["data"]
        assert ev["events"] and ev["events"][-1]["cause"] == "deadline"
        ev = json.loads((await req("lmstudio.events", {"limit": 500})).payload)["data"]
        assert {"engine_load", "kernel_build"} & {x["kind"] for x in ev["events"]} \
            == {"engine_load"}  # the CPU builds no kernels

        # debug.snapshot while a stream holds a slot (its bursts slowed down
        # to 20 ms): its table's refcounts are the pool's
        b = (await registry.get_engine(MID)).batcher
        for name in ("_decode_pos_pallas", "_spec_verify_pallas"):
            def slow(*a, _f=getattr(b, name)):
                time.sleep(0.02)
                return _f(*a)

            setattr(b, name, slow)
        stream = dict(body, max_tokens=200, stream=True)
        agen = nc.request_stream("lmstudio.chat_model", json.dumps(stream).encode(),
                                 timeout=30.0)
        await agen.__anext__()
        t_end = time.monotonic() + 10.0
        while not b._slot_view:  # published once per owner-loop pass
            assert time.monotonic() < t_end
            await asyncio.sleep(0.005)
        snap = json.loads((await req("lmstudio.debug.snapshot", {"model": MID})).payload)
        eng_snap = snap["data"]["engines"][MID]
        slots = eng_snap["slots"]
        assert slots, eng_snap
        for ent in slots.values():
            assert ent["block_refcounts"] == [b._pool.refcount(x) for x in ent["blocks"]]
            assert all(r >= 1 for r in ent["block_refcounts"])
        assert eng_snap["pool"]["blocks_total"] == b.pool_stats()["blocks_total"]
        assert eng_snap["recorder_frames_sampled"] > 0

        prof = json.loads((await req("lmstudio.profile", {"seconds": 0.2},
                                     timeout=30.0)).payload)
        assert prof["ok"], prof
        assert os.path.getsize(prof["data"]["trace_file"]) > 0
        assert prof["data"]["bucket"] == "profiles" and prof["data"]["bytes"] > 0
        await agen.aclose()

        dump = json.loads((await req("lmstudio.debug.dump", {})).payload)
        path = dump["data"]["dumps"][MID]
        assert path.startswith(str(dumps))
        doc = json.loads(open(path).read())
        assert doc["reason"] == "debug_request"
        assert doc["frames"] and all("queue_depth" in f for f in doc["frames"])

        # a worker without DEBUG_SUBJECTS: no debug subjects at all
        plain_broker = await EmbeddedBroker().start()
        plain = (plain_broker, Worker(WorkerConfig(nats_url=plain_broker.url), registry))
        await plain[1].start()
        pnc = await connect(plain_broker.url)
        try:
            with pytest.raises(Exception):
                await pnc.request("lmstudio.debug.snapshot", b"{}", timeout=0.5)
            env = json.loads((await pnc.request("lmstudio.health", b"", timeout=5)).payload)
            assert env["ok"]
        finally:
            await pnc.close()
    finally:
        await nc.close()
        await worker.drain()
        if plain is not None:
            await plain[1].drain()
            await plain[0].stop()
        await registry.close()
        await broker.stop()
