"""NATS worker for the port: list_models, pull_model, delete_model,
sync_model_from_bucket, chat_model (unary and streamed) and health.

Slim port of ``nats_llm_studio_tpu/serve/worker.py``: the same subjects,
queue group, ``{ok, error?, data?}`` envelopes, validation strings and
``data`` fields, and streaming contract
(OpenAI-style chunks on the reply inbox, then the aggregate completion with
a ``Nats-Stream-Done`` header), so the JAX worker's clients talk to this one
unchanged. A chat carrying a header for a feature this worker does not
serve (QoS priority, disaggregated prefill) gets an error envelope naming
the header.

Not ported yet: metrics and Prometheus, traces and spans, events, profiling, debug subjects, cluster adverts and drain,
supervision, KV export/import, deadline propagation.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import time

from ..config import WorkerConfig
from ..transport.client import Msg, NatsClient, connect
from ..transport.envelope import envelope_error, envelope_ok
from ..transport.protocol import (
    KV_PREFILL_HEADER,
    PRIORITY_HEADER,
    STREAM_CANCEL_SUFFIX,
    WORKER_HEADER,
)
from .api import EngineError, ModelNotFound, Registry

log = logging.getLogger(__name__)

# headers of features this worker does not serve; a chat carrying one is
# answered with an error naming it
UNSUPPORTED_HEADERS = (PRIORITY_HEADER, KV_PREFILL_HEADER)


class Worker:
    """One serving process: NATS subscriptions + an in-process registry."""

    def __init__(self, config: WorkerConfig, registry: Registry):
        self.config = config
        self.registry = registry
        self.worker_id = config.worker_id
        self.nc: NatsClient | None = None
        self._requests_total = 0
        self._tokens_total = 0
        self._streams_cancelled = 0
        self._t0 = time.monotonic()

    async def start(self) -> None:
        cfg = self.config
        self.nc = await connect(
            cfg.nats_url,
            name=f"torch-worker-{self.worker_id}",
            max_reconnects=cfg.max_reconnects,
            reconnect_wait_s=cfg.reconnect_wait_s,
            reconnect_max_wait_s=cfg.reconnect_max_wait_s,
            ping_interval_s=cfg.ping_interval_s,
        )
        subs = {
            cfg.subject("list_models"): self.on_list_models,
            cfg.subject("pull_model"): self.on_pull_model,
            cfg.subject("delete_model"): self.on_delete_model,
            cfg.subject("sync_model_from_bucket"): self.on_sync_model_from_bucket,
            cfg.subject("chat_model"): self.on_chat_model,
            cfg.subject("health"): self.on_health,
        }
        for subject, handler in subs.items():
            await self.nc.subscribe(subject, queue=cfg.queue_group, cb=self._guarded(handler))
        wid_prefix = f"{cfg.subject_prefix}.worker.{self.worker_id}"
        for op, handler in (("chat_model", self.on_chat_model), ("health", self.on_health)):
            await self.nc.subscribe(f"{wid_prefix}.{op}", cb=self._guarded(handler))
        await self.nc.flush()
        log.info("worker %s serving %s.* (queue=%s)", self.worker_id,
                 cfg.subject_prefix, cfg.queue_group)

    async def drain(self) -> None:
        if self.nc is not None:
            await self.nc.drain()

    def _guarded(self, handler):
        """An exception escaping a handler still gets an error envelope."""

        async def run(msg: Msg) -> None:
            try:
                await handler(msg)
            except Exception as e:  # noqa: BLE001 — deliberate catch-all seam
                log.exception("handler for %s failed", msg.subject)
                await self._respond_error(msg, f"internal error: {e}")

        return run

    async def _respond_json(self, msg: Msg, payload: bytes, headers=None) -> None:
        headers = dict(headers) if headers else {}
        headers.setdefault(WORKER_HEADER, self.worker_id)
        try:
            await msg.respond(payload, headers=headers)
        except (ConnectionError, ValueError):
            log.warning("failed to respond on %s", msg.subject)

    async def _respond_ok(self, msg: Msg, data=None) -> None:
        await self._respond_json(msg, envelope_ok(data))

    async def _respond_error(self, msg: Msg, error: str, data=None, headers=None) -> None:
        await self._respond_json(msg, envelope_error(error, data), headers=headers)

    async def on_list_models(self, msg: Msg) -> None:
        """list_models -> ``data.models`` + ``data.http_status``."""
        self._requests_total += 1
        try:
            async with asyncio.timeout(self.config.list_timeout_s):
                models = await self.registry.list_models()
        except asyncio.TimeoutError:
            await self._respond_error(msg, "timeout listing models")
            return
        except EngineError as e:
            await self._respond_error(msg, f"error listing models: {e}")
            return
        await self._respond_ok(msg, {"models": models, "http_status": 200})

    @staticmethod
    def _request_object(payload: bytes) -> dict:
        req = json.loads(payload or b"{}")
        if not isinstance(req, dict):
            raise ValueError("payload must be a JSON object")
        return req

    async def on_pull_model(self, msg: Msg) -> None:
        """pull_model {identifier}; on failure ``data`` still carries
        {model, output}."""
        self._requests_total += 1
        try:
            req = self._request_object(msg.payload)
        except ValueError as e:
            await self._respond_error(msg, f"invalid JSON in PullModel: {e}")
            return
        identifier = (req.get("identifier") or "").strip()
        if not identifier:
            await self._respond_error(msg, "'identifier' is required")
            return
        try:
            async with asyncio.timeout(self.config.pull_timeout_s):
                output = await self.registry.pull(identifier)
        except asyncio.TimeoutError:
            await self._respond_error(
                msg, "error pulling model: deadline exceeded", {"model": identifier})
            return
        except EngineError as e:
            await self._respond_error(
                msg, f"error pulling model: {e}", {"model": identifier, "output": str(e)})
            return
        await self._respond_ok(msg, {"model": identifier, "output": output})

    async def on_delete_model(self, msg: Msg) -> None:
        """delete_model {model_id}: unloads, then removes the cache dir;
        success returns ``deleted_dir``, an error the attempted ``dir``."""
        self._requests_total += 1
        try:
            req = self._request_object(msg.payload)
        except ValueError as e:
            await self._respond_error(msg, f"invalid JSON in DeleteModel: {e}")
            return
        model_id = (req.get("model_id") or "").strip()
        if not model_id:
            await self._respond_error(msg, "'model_id' is required")
            return
        try:
            async with asyncio.timeout(self.config.delete_timeout_s):
                deleted_dir = await self.registry.delete(model_id)
        except asyncio.TimeoutError:
            await self._respond_error(
                msg, "error deleting model: deadline exceeded", {"model": model_id})
            return
        except EngineError as e:
            data = {"model": model_id}
            attempted = getattr(e, "dir", None)
            if attempted:
                data["dir"] = str(attempted)
            await self._respond_error(msg, f"error deleting model: {e}", data)
            return
        await self._respond_ok(msg, {"model": model_id, "deleted_dir": deleted_dir})

    async def on_sync_model_from_bucket(self, msg: Msg) -> None:
        """sync_model_from_bucket {object_name, model_id?}: object store ->
        local model cache, responds {object, local_path}."""
        self._requests_total += 1
        try:
            req = self._request_object(msg.payload)
        except ValueError as e:
            await self._respond_error(msg, f"invalid JSON in SyncModelFromBucket: {e}")
            return
        name = (req.get("object_name") or req.get("name") or "").strip()
        if not name:
            await self._respond_error(msg, "'object_name' is required")
            return
        try:
            async with asyncio.timeout(self.config.pull_timeout_s):
                local_path = await self.registry.sync_from_bucket(name, req.get("model_id"))
        except asyncio.TimeoutError:
            await self._respond_error(
                msg, "error syncing model: deadline exceeded", {"object": name})
            return
        except EngineError as e:
            await self._respond_error(msg, f"error syncing model: {e}", {"object": name})
            return
        await self._respond_ok(msg, {"object": name, "local_path": str(local_path)})

    async def on_chat_model(self, msg: Msg) -> None:
        """chat_model: the OpenAI-style body goes to the engine verbatim;
        success wraps {http_status, response}."""
        self._requests_total += 1
        hdrs = msg.headers or {}
        if not msg.payload:
            await self._respond_error(msg, "empty payload in ChatModel")
            return
        try:
            payload = json.loads(msg.payload)
            if not isinstance(payload, dict):
                raise ValueError("payload must be a JSON object")
        except ValueError as e:
            await self._respond_error(msg, f"invalid JSON in ChatModel: {e}")
            return
        model_id = (payload.get("model") or "").strip()
        if not model_id:
            await self._respond_error(msg, "'model' is required in ChatModel")
            return
        if payload.get("stream") and not msg.reply:
            return  # fire-and-forget stream request: nowhere to send tokens
        streaming = bool(payload.get("stream"))
        for h in UNSUPPORTED_HEADERS:
            if hdrs.get(h):
                await self._error_terminal(
                    msg, f"error in chat: unsupported header {h!r}: not served by "
                    f"this worker", {"model": model_id}, streaming)
                return
        try:
            async with asyncio.timeout(self.config.chat_timeout_s):
                engine = await self.registry.get_engine(model_id)
                if streaming:
                    await self._chat_streaming(msg, engine, payload)
                else:
                    response = await engine.chat(payload)
                    usage = response.get("usage") or {}
                    self._tokens_total += usage.get("completion_tokens", 0)
                    await self._respond_json(
                        msg, envelope_ok({"http_status": 200, "response": response}))
        except asyncio.TimeoutError:
            await self._error_terminal(
                msg, "error in chat: deadline exceeded", {"model": model_id}, streaming)
        except ModelNotFound as e:
            await self._error_terminal(
                msg, f"model not found: {e}", {"model": model_id}, streaming)
        except EngineError as e:
            await self._error_terminal(
                msg, f"error in chat: {e}", {"model": model_id}, streaming)
        except Exception as e:  # noqa: BLE001 — a mid-stream crash still ends the stream
            log.exception("chat handler failed for %s", model_id)
            await self._error_terminal(
                msg, f"internal error: {e}", {"model": model_id}, streaming)

    async def _error_terminal(self, msg: Msg, error: str, data, streaming: bool) -> None:
        """Error reply that, mid-stream, still carries ``Nats-Stream-Done``."""
        headers = {"Nats-Stream-Done": "1"} if streaming else None
        await self._respond_error(msg, error, data, headers=headers)

    async def _chat_streaming(self, msg: Msg, engine, payload: dict) -> None:
        assert self.nc is not None
        final: dict | None = None
        seq = 0
        # consumer-gone watcher: request_stream publishes to <inbox>.cancel
        # when its consumer abandons the stream; the engine stream is then
        # closed, which frees the batcher slot
        cancel_sub = await self.nc.subscribe(msg.reply + STREAM_CANCEL_SUFFIX)
        cancel_task = asyncio.ensure_future(cancel_sub.next_msg(timeout=None))
        gen = engine.chat_stream(payload)
        cancelled = False
        try:
            while True:
                step = asyncio.ensure_future(gen.__anext__())
                await asyncio.wait({step, cancel_task}, return_when=asyncio.FIRST_COMPLETED)
                if cancel_task.done() and not step.done():
                    step.cancel()
                    with contextlib.suppress(BaseException):
                        await step
                    cancelled = True
                    break
                try:
                    chunk = await step
                except StopAsyncIteration:
                    break
                if chunk.get("object") == "chat.completion":
                    final = chunk  # engines yield the aggregate last
                    continue
                await self.nc.publish(
                    msg.reply,
                    json.dumps({"ok": True, "data": {"chunk": chunk}},
                               separators=(",", ":")).encode(),
                    headers={"X-Seq": str(seq)},
                )
                seq += 1
        finally:
            cancel_task.cancel()
            with contextlib.suppress(BaseException):
                await cancel_task
            with contextlib.suppress(Exception):
                await cancel_sub.unsubscribe()
            if cancelled:
                with contextlib.suppress(BaseException):
                    await gen.aclose()
        if cancelled:
            self._streams_cancelled += 1
            return
        if final is None:
            raise EngineError("engine stream ended without a chat.completion aggregate")
        usage = final.get("usage") or {}
        self._tokens_total += usage.get("completion_tokens", 0)
        await self.nc.publish(
            msg.reply,
            envelope_ok({"http_status": 200, "response": final}),
            headers={"Nats-Stream-Done": "1", "X-Seq": str(seq),
                     WORKER_HEADER: self.worker_id},
        )

    async def on_health(self, msg: Msg) -> None:
        data = {
            "status": "ok",
            "worker_id": self.worker_id,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "requests_total": self._requests_total,
            "tokens_total": self._tokens_total,
            "streams_cancelled": self._streams_cancelled,
            "queue_group": self.config.queue_group,
            "reconnects": getattr(self.nc, "reconnects", 0),
        }
        data.update(self.registry.stats())
        health_fn = getattr(self.registry, "engine_health", None)
        if health_fn is not None:
            engines = health_fn()
            if engines:
                data["engines"] = engines
        await self._respond_ok(msg, data)
