"""The port's model lifecycle on the CPU, held against the reference:
``store/`` (ModelStore, the object-store module) and ``transport/jetstream``
as the JAX package's tests drive them, objects and store directories moving
between the two packages, the worker's pull / delete / sync subjects, a
full lifecycle over NATS whose greedy tokens equal a JAX greedy loop,
device-memory admission under ``TPU_HBM_BUDGET_BYTES``, the estimator
against the reference's, and ``ContinuousBatcher.stop`` releasing the
pool. Tiny models: 2 layers, 2 slots.
"""

import asyncio
import gc
import hashlib
import json
import weakref

import jax
import pytest

from conftest import async_test
from nats_llm_studio_tpu.models.config import ModelConfig as JConfig
from nats_llm_studio_tpu.models.export import export_params_to_gguf
from nats_llm_studio_tpu.models.llama import init_params
from nats_llm_studio_tpu.parallel import memory as jmemory
from nats_llm_studio_tpu.store import JetStreamStoreModule as JStoreModule
from nats_llm_studio_tpu.store import ModelStore as JModelStore
from nats_llm_studio_tpu.store.manager import split_model_id as j_split_model_id
from nats_llm_studio_tpu.transport import EmbeddedBroker as JBroker
from nats_llm_studio_tpu.transport import connect as jconnect
from nats_llm_studio_tpu.transport.jetstream import ObjectStore as JObjectStore
from nats_llm_studio_tpu_torch.config import WorkerConfig
from nats_llm_studio_tpu_torch.models.config import ModelConfig as TConfig
from nats_llm_studio_tpu_torch.parallel import memory as tmemory
from nats_llm_studio_tpu_torch.serve.api import EngineError
from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry, _prefix_cache_blocks_env
from nats_llm_studio_tpu_torch.serve.worker import Worker
from nats_llm_studio_tpu_torch.store import JetStreamStoreModule, ModelStore
from nats_llm_studio_tpu_torch.store.manager import StoreError, split_model_id
from nats_llm_studio_tpu_torch.transport import EmbeddedBroker, connect
from nats_llm_studio_tpu_torch.transport.jetstream import ObjectStore
from test_serve_e2e import byte_level_tokenizer_md
from test_torch_serve import MID, _export, _jax_greedy

PACKAGES = {
    "jax": (JBroker, JStoreModule, jconnect, JObjectStore, JModelStore),
    "torch": (EmbeddedBroker, JetStreamStoreModule, connect, ObjectStore, ModelStore),
}


class Js:
    """An embedded broker with the object-store module, and a client, of
    one package."""

    def __init__(self, pkg: str = "torch", store_dir=None):
        self.pkg = pkg
        self.store_dir = store_dir

    async def __aenter__(self):
        broker_cls, module_cls, conn, objstore_cls, _ = PACKAGES[self.pkg]
        self.broker = await broker_cls().start()
        module_cls(self.broker, store_dir=self.store_dir).install()
        self.nc = await conn(self.broker.url)
        self.os = objstore_cls(self.nc, timeout=5.0)
        return self

    async def __aexit__(self, *exc):
        await self.nc.close()
        await self.broker.stop()

    async def req(self, op: str, payload, timeout: float = 30.0) -> dict:
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        msg = await self.nc.request(f"lmstudio.{op}", body, timeout=timeout)
        return json.loads(msg.payload)


def _sha(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


# -- store/manager.py -----------------------------------------------------------


@pytest.mark.parametrize("model_id", [
    "meta/llama-3-8b", "bare-model", "/p/m/", "pub/llama3.", "../../etc", "a/b c", "pub/x y ",
])
def test_split_model_id_matches_the_reference(model_id):
    for strict in (True, False):
        try:
            want = j_split_model_id(model_id, strict=strict)
        except Exception as e:  # noqa: BLE001 — the port must raise alike
            with pytest.raises(StoreError, match="unsafe model id component"):
                split_model_id(model_id, strict=strict)
            assert "unsafe model id component" in str(e)
        else:
            assert split_model_id(model_id, strict=strict) == want


def test_local_cache_lifecycle(tmp_path):
    ms = ModelStore(tmp_path / "models")
    src = tmp_path / "w.gguf"
    src.write_bytes(b"GGUFDATA")
    dest = ms.import_file(src, "pub/mymodel")
    assert dest.read_bytes() == b"GGUFDATA"
    assert [c.model_id for c in ms.cached()] == ["pub/mymodel"]
    assert ms.lookup("pub/mymodel").gguf_path == dest
    deleted = ms.delete_local("pub/mymodel")
    assert "pub" in deleted and "mymodel" in deleted
    assert ms.cached() == []
    with pytest.raises(StoreError) as ei:
        ms.delete_local("pub/mymodel")
    assert ei.value.dir is not None  # the attempted dir, for the envelope


@async_test
async def test_publish_pull_and_model_id_override(tmp_path):
    async with Js() as h:
        ms_a = ModelStore(tmp_path / "worker_a", objstore=h.os)
        ms_b = ModelStore(tmp_path / "worker_b", objstore=h.os)
        src = tmp_path / "model.gguf"
        src.write_bytes(b"WEIGHTS" * 50000)  # 3 chunks
        ms_a.import_file(src, "acme/granite-tiny")
        assert await ms_a.publish_model("acme/granite-tiny") == "acme/granite-tiny/model.gguf"
        path, transcript = await ms_b.pull("acme/granite-tiny")  # by model id
        assert path.read_bytes() == src.read_bytes()
        assert "resolved to 1 object(s)" in transcript
        path2, _ = await ms_b.pull("acme/granite-tiny/model.gguf")  # by object name
        assert path2 == path
        path3, _ = await ms_b.pull("acme/granite-tiny/model.gguf", model_id="other/renamed")
        assert ms_b.lookup("other/renamed") is not None
        assert path3.read_bytes() == src.read_bytes()
        with pytest.raises(StoreError):
            await ms_b.pull("ghost/model")


def test_pull_requires_objstore(tmp_path):
    with pytest.raises(StoreError, match="object store not configured"):
        asyncio.run(ModelStore(tmp_path / "m").pull("a/b"))


@async_test
async def test_pull_from_file_url(tmp_path):
    src = tmp_path / "src" / "mini.gguf"
    src.parent.mkdir()
    src.write_bytes(b"GGUF-mini-bytes" * 100)
    ms = ModelStore(tmp_path / "models")
    dest, _ = await ms.pull(src.as_uri())
    assert dest.read_bytes() == src.read_bytes()
    assert "downloads/mini" in str(dest)
    dest2, _ = await ms.pull(src.as_uri(), model_id="acme/mini")
    assert "acme/mini" in str(dest2)
    with pytest.raises(StoreError):
        await ms.pull("file:///nonexistent/nope.gguf")
    with pytest.raises(StoreError):
        await ms.pull("https://example.invalid/not-a-gguf.bin")
    with pytest.raises(StoreError, match="not allowed"):
        await ModelStore(tmp_path / "m2", url_schemes=("https",)).pull(src.as_uri())


# -- interchange between the packages --------------------------------------------


@pytest.mark.parametrize("put_pkg,pull_pkg", [("jax", "torch"), ("torch", "jax")])
@async_test
async def test_objects_cross_between_packages_over_the_wire(tmp_path, put_pkg, pull_pkg):
    """An object published by one package's ModelStore through its own
    broker module is pulled by the other package's ModelStore."""
    src = tmp_path / "w.gguf"
    src.write_bytes(bytes(range(256)) * 1500)  # 3 chunks
    async with Js(put_pkg) as h:
        puller_nc = await PACKAGES[pull_pkg][2](h.broker.url)
        try:
            pub = PACKAGES[put_pkg][4](tmp_path / "pub", objstore=h.os)
            pub.import_file(src, "acme/x")
            await pub.publish_model("acme/x")
            ms = PACKAGES[pull_pkg][4](tmp_path / "worker",
                                       objstore=PACKAGES[pull_pkg][3](puller_nc, timeout=5.0))
            path, _ = await ms.pull("acme/x")
        finally:
            await puller_nc.close()
    assert _sha(path) == _sha(src)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
@async_test
async def test_store_dir_opens_in_the_other_package(tmp_path, writer, reader):
    store_dir = tmp_path / "js"
    src = tmp_path / "w.gguf"
    src.write_bytes(b"\x07GGUF" * 60000)
    async with Js(writer, store_dir) as h:
        pub = PACKAGES[writer][4](tmp_path / "pub", objstore=h.os)
        pub.import_file(src, "acme/y")
        await pub.publish_model("acme/y")
    async with Js(reader, store_dir) as h:
        ms = PACKAGES[reader][4](tmp_path / "worker", objstore=h.os)
        path, _ = await ms.pull("acme/y/w.gguf")
    assert _sha(path) == _sha(src)


# -- the worker's lifecycle subjects ---------------------------------------------


class WorkerHarness(Js):
    """A torch Worker over a TorchRegistry(device="cpu") whose ModelStore
    reaches the harness's bucket."""

    def __init__(self, models_dir, **reg):
        super().__init__("torch")
        self.models_dir = models_dir
        self.reg = reg

    async def __aenter__(self):
        await super().__aenter__()
        self.store = ModelStore(self.models_dir, objstore=self.os)
        self.registry = TorchRegistry(self.store, device="cpu", **self.reg)
        self.worker = Worker(WorkerConfig(nats_url=self.broker.url), self.registry)
        await self.worker.start()
        return self

    async def __aexit__(self, *exc):
        await self.worker.drain()
        await self.registry.close()
        await super().__aexit__(*exc)


async def _publish_bytes(h, tmp_path, model_id: str, data: bytes, fname="file.gguf"):
    src = tmp_path / "src" / fname
    src.parent.mkdir(exist_ok=True)
    src.write_bytes(data)
    pub = ModelStore(tmp_path / "pub", objstore=h.os)
    pub.import_file(src, model_id)
    await pub.publish_model(model_id)


@async_test
async def test_pull_model_validation_and_success(tmp_path):
    async with WorkerHarness(tmp_path / "models") as h:
        resp = await h.req("pull_model", {})
        assert resp["ok"] is False and resp["error"] == "'identifier' is required"
        resp = await h.req("pull_model", b"{not json")
        assert resp["ok"] is False and resp["error"].startswith("invalid JSON in PullModel")
        resp = await h.req("pull_model", {"identifier": "pub/new-model"})
        assert resp["ok"] is False and resp["error"].startswith("error pulling model: ")
        assert resp["data"]["model"] == "pub/new-model" and "output" in resp["data"]

        await _publish_bytes(h, tmp_path, "pub/new-model", b"W" * 1000)
        resp = await h.req("pull_model", {"identifier": "pub/new-model"})
        assert resp["ok"] is True, resp
        assert resp["data"]["model"] == "pub/new-model"
        assert "wrote 1000 bytes" in resp["data"]["output"]
        assert h.store.lookup("pub/new-model") is not None


@async_test
async def test_delete_model_validation_success_and_missing_dir(tmp_path):
    async with WorkerHarness(tmp_path / "models") as h:
        src = tmp_path / "m.gguf"
        src.write_bytes(b"GGUF")
        h.store.import_file(src, "pub/m1")
        resp = await h.req("delete_model", {})
        assert resp["ok"] is False and resp["error"] == "'model_id' is required"
        resp = await h.req("delete_model", b"[1]")
        assert resp["ok"] is False and resp["error"].startswith("invalid JSON in DeleteModel")

        resp = await h.req("delete_model", {"model_id": "pub/m1"})
        assert resp["ok"] is True
        assert resp["data"]["model"] == "pub/m1"
        assert resp["data"]["deleted_dir"].endswith("pub/m1")

        # missing model: the error carries the attempted dir
        resp = await h.req("delete_model", {"model_id": "pub/ghost"})
        assert resp["ok"] is False
        assert "model directory not found" in resp["error"]
        assert resp["data"]["dir"].endswith("pub/ghost")


@async_test
async def test_sync_model_from_bucket_subject(tmp_path):
    async with WorkerHarness(tmp_path / "models") as h:
        resp = await h.req("sync_model_from_bucket", {})
        assert resp["ok"] is False and resp["error"] == "'object_name' is required"
        resp = await h.req("sync_model_from_bucket", {"object_name": "pub/model/file.gguf"})
        assert resp["ok"] is False and resp["error"].startswith("error syncing model: ")
        assert resp["data"] == {"object": "pub/model/file.gguf"}

        await _publish_bytes(h, tmp_path, "pub/model", b"S" * 300000)
        resp = await h.req("sync_model_from_bucket", {"object_name": "pub/model/file.gguf"})
        assert resp["ok"] is True, resp
        assert resp["data"]["object"] == "pub/model/file.gguf"
        assert resp["data"]["local_path"].endswith("pub/model/file.gguf")
        resp = await h.req("sync_model_from_bucket",
                           {"object_name": "pub/model/file.gguf", "model_id": "acme/copy"})
        assert resp["data"]["local_path"].endswith("acme/copy/file.gguf")


@async_test
async def test_full_model_lifecycle_over_nats(tmp_path):
    """publish -> pull_model -> list_models -> chat_model (greedy tokens equal
    to a JAX greedy loop on the same GGUF; then streamed) -> health ->
    delete_model -> the chat is refused."""
    src = _export(tmp_path / "pub")
    async with WorkerHarness(tmp_path / "worker") as h:
        await ModelStore(tmp_path / "pub", objstore=h.os).publish_model(MID)

        resp = await h.req("pull_model", {"identifier": MID})
        assert resp["ok"], resp
        assert "m.gguf" in resp["data"]["output"]
        entries = (await h.req("list_models", {}))["data"]["models"]["data"]
        assert [e["id"] for e in entries] == [MID] and entries[0]["state"] == "not-loaded"

        messages = [{"role": "user", "content": "hi there"}]
        body = {"model": MID, "messages": messages, "max_tokens": 6, "temperature": 0.0}
        resp = await h.req("chat_model", body)
        assert resp["ok"], resp
        got = resp["data"]["response"]
        text, n_prompt, n_out = _jax_greedy(src, messages, 6)
        assert got["choices"][0]["message"]["content"] == text
        assert (got["usage"]["prompt_tokens"], got["usage"]["completion_tokens"]) == (
            n_prompt, n_out)
        entries = (await h.req("list_models", {}))["data"]["models"]["data"]
        assert entries[0]["state"] == "loaded"

        chunks, final = [], None
        async for msg in h.nc.request_stream(
                "lmstudio.chat_model", json.dumps({**body, "stream": True}).encode(),
                timeout=30.0):
            env = json.loads(msg.payload)
            if (msg.headers or {}).get("Nats-Stream-Done"):
                final = env
                break
            chunks.append(env["data"]["chunk"]["choices"][0]["delta"]["content"])
        assert final["ok"] and final["data"]["response"]["choices"][0]["message"][
            "content"] == "".join(chunks) == text

        health = (await h.req("health", {}))["data"]
        assert health["models_loaded"] == 1 and health["hbm_committed_bytes"] == 0

        resp = await h.req("delete_model", {"model_id": MID})
        assert resp["ok"], resp
        assert resp["data"]["deleted_dir"].endswith(MID)
        assert (await h.req("list_models", {}))["data"]["models"]["data"] == []
        resp = await h.req("chat_model", body)
        assert not resp["ok"] and "model not found" in resp["error"]


# -- device-memory admission -------------------------------------------------------

ADMIT_SEQ = 128


def _publish_tiny(models_dir, model_id: str, seed: int):
    cfg = JConfig.tiny(n_layers=2, max_seq_len=ADMIT_SEQ)
    d = models_dir / model_id
    d.mkdir(parents=True)
    export_params_to_gguf(d / "m.gguf", init_params(cfg, jax.random.PRNGKey(seed)), cfg,
                          name=model_id, tokenizer_md=byte_level_tokenizer_md(cfg.vocab_size))


def _one_engine_bytes() -> int:
    """What the registry commits for one engine: the estimate at its
    settings, the prefix-cache budget included."""
    cfg = TConfig.tiny(n_layers=2, max_seq_len=ADMIT_SEQ)
    return tmemory.estimate_load_bytes(
        cfg, 2, ADMIT_SEQ, prefix_cache_blocks=_prefix_cache_blocks_env())["total"]


def _admit_registry(tmp_path, monkeypatch, budget_engines: float | None):
    models = tmp_path / "models"
    _publish_tiny(models, "acme/a", 1)
    _publish_tiny(models, "acme/b", 2)
    if budget_engines is None:
        monkeypatch.delenv("TPU_HBM_BUDGET_BYTES", raising=False)
    else:
        monkeypatch.setenv("TPU_HBM_BUDGET_BYTES",
                           str(int(_one_engine_bytes() * budget_engines)))
    return TorchRegistry(ModelStore(models), device="cpu", max_batch_slots=2,
                         max_seq_len=ADMIT_SEQ)


def _chat(content: str, n: int) -> dict:
    return {"messages": [{"role": "user", "content": content}], "max_tokens": n,
            "temperature": 0.0}


@async_test
async def test_over_budget_load_refused_while_busy_first_engine_serves(tmp_path, monkeypatch):
    reg = _admit_registry(tmp_path, monkeypatch, 1.5)  # room for one engine
    try:
        eng_a = await reg.get_engine("acme/a")
        hold = asyncio.Event()

        async def occupy():
            out = []
            async for chunk in eng_a.chat_stream(_chat("hi", 100)):
                hold.set()
                out.append(chunk)
            return out

        task = asyncio.create_task(occupy())
        await hold.wait()
        with pytest.raises(EngineError, match="insufficient device memory"):
            await reg.get_engine("acme/b")
        chunks = await task  # the refusal left A's stream intact
        assert chunks[-1]["object"] == "chat.completion"
        out = await eng_a.chat(_chat("again", 3))
        assert out["usage"]["completion_tokens"] == 3
        assert reg.stats()["models_loaded"] == 1
        # before refusing, the load dropped A's prefix cache: A's commitment
        # lost that cache's bytes outside the pool
        assert eng_a.batcher.prefix_cache.blocks == 0
        cfg = TConfig.tiny(n_layers=2, max_seq_len=ADMIT_SEQ)
        prefix = tmemory.estimate_load_bytes(
            cfg, 2, ADMIT_SEQ, prefix_cache_blocks=_prefix_cache_blocks_env())["prefix"]
        assert reg.stats()["hbm_committed_bytes"] == _one_engine_bytes() - prefix
    finally:
        await reg.close()


@async_test
async def test_idle_engine_evicted_to_fit(tmp_path, monkeypatch):
    reg = _admit_registry(tmp_path, monkeypatch, 1.5)
    reg.evict_grace_s = 0.0
    try:
        eng_a = await reg.get_engine("acme/a")
        assert (await eng_a.chat(_chat("hi", 2)))["usage"]["completion_tokens"] == 2
        eng_b = await reg.get_engine("acme/b")  # A idle: evicted, not refused
        assert set(reg.loaded_engines()) == {"acme/b"}
        assert eng_a.batcher.params is None  # its device tensors went with it
        assert (await eng_b.chat(_chat("yo", 2)))["usage"]["completion_tokens"] == 2
        await reg.get_engine("acme/a")  # and back, evicting idle B
        assert set(reg.loaded_engines()) == {"acme/a"}
    finally:
        await reg.close()


@async_test
async def test_recently_used_idle_engine_not_evicted(tmp_path, monkeypatch):
    reg = _admit_registry(tmp_path, monkeypatch, 1.5)
    reg.evict_grace_s = 60.0  # nothing here is ever past the grace
    try:
        await reg.get_engine("acme/a")  # idle but freshly targeted
        with pytest.raises(EngineError, match="insufficient device memory"):
            await reg.get_engine("acme/b")
        assert set(reg.loaded_engines()) == {"acme/a"}
    finally:
        await reg.close()


@async_test
async def test_failed_load_releases_hbm_reservation(tmp_path, monkeypatch):
    reg = _admit_registry(tmp_path, monkeypatch, 3)
    try:
        await reg.get_engine("acme/a")
        committed = reg.stats()["hbm_committed_bytes"]
        assert committed > 0

        def boom(*a, **k):
            raise RuntimeError("simulated device OOM during load")

        monkeypatch.setattr(reg, "_load", boom)
        with pytest.raises(RuntimeError, match="simulated"):
            await reg.get_engine("acme/b")
        assert reg.stats()["hbm_committed_bytes"] == committed  # no phantom bytes
    finally:
        monkeypatch.undo()
        await reg.close()


@async_test
async def test_no_budget_known_means_no_check(tmp_path, monkeypatch):
    """On the CPU with no override there is no budget: loads are not
    priced."""
    reg = _admit_registry(tmp_path, monkeypatch, None)
    try:
        assert reg.budget_bytes() is None
        await reg.get_engine("acme/a")
        await reg.get_engine("acme/b")
        assert set(reg.loaded_engines()) == {"acme/a", "acme/b"}
        assert reg.stats()["hbm_committed_bytes"] == 0
    finally:
        await reg.close()


# -- the estimator -------------------------------------------------------------------

LLAMA3_8B = dict(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                 head_dim=128, d_ff=14336, max_seq_len=8192)
TINY = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, max_seq_len=128)


@pytest.mark.parametrize("widths", [TINY, LLAMA3_8B], ids=["tiny", "llama3-8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_estimator_matches_the_reference(widths, dtype, quant):
    jcfg, tcfg = JConfig(**widths, dtype=dtype), TConfig(**widths, dtype=dtype)
    for cache_bytes in (None, 1):
        kw = dict(quant=quant, batch=8, seq_len=4096, cache_dtype_bytes=cache_bytes)
        assert tmemory.estimate_device_bytes(tcfg, {}, **kw) == \
            jmemory.estimate_device_bytes(jcfg, {}, **kw)
    for kv in ("none", "int8"):
        for t in (8, 16):
            assert tmemory.kv_pool_block_bytes(tcfg, t, kv_quant=kv) == \
                jmemory.kv_pool_block_bytes(jcfg, t, kv_quant=kv)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@async_test
async def test_pool_term_is_the_batchers_pool_and_stop_releases_it(tmp_path, kv_quant):
    """The estimate's pool term equals the bytes the batcher allocated, and
    after delete nothing holds the pool (its tensor is collected) even
    while the engine object is still referenced."""
    models = tmp_path / "models"
    _publish_tiny(models, "acme/a", 1)
    reg = TorchRegistry(ModelStore(models), device="cpu", max_batch_slots=2,
                        max_seq_len=ADMIT_SEQ, kv_quant=kv_quant)
    try:
        eng = await reg.get_engine("acme/a")
        cfg = TConfig.tiny(n_layers=2, max_seq_len=ADMIT_SEQ, kv_quant=kv_quant)
        est = tmemory.estimate_load_bytes(cfg, 2, ADMIT_SEQ,
                                          prefix_cache_blocks=reg.prefix_cache_blocks)
        assert reg.prefix_cache_blocks > 0  # the pool holds the prefix budget too
        assert est["kv_pool"] == eng.batcher.pool_stats()["bytes"]
        kp = eng.batcher._kv[0]
        ref = weakref.ref(kp.q if kv_quant == "int8" else kp)
        del kp
        await reg.delete("acme/a")
        gc.collect()
        assert ref() is None
        assert eng.batcher.params is None
    finally:
        await reg.close()
