"""NATS worker for the port: list_models, pull_model, delete_model,
sync_model_from_bucket, chat_model (unary and streamed), health, metrics,
metrics.prom, events, profile, and with ``DEBUG_SUBJECTS=1`` debug.snapshot
and debug.dump; the cluster's directed ``lmstudio.worker.<id>.*`` subjects
(chat_model, health, metrics.prom, kv_export) and ``admin.drain``.

Port of ``nats_llm_studio_tpu/serve/worker.py``: the same subjects,
queue group, ``{ok, error?, data?}`` envelopes, validation strings and
``data`` fields, and streaming contract
(OpenAI-style chunks on the reply inbox, then the aggregate completion with
a ``Nats-Stream-Done`` header), so the JAX worker's clients talk to this one
unchanged. A chat's ``X-Deadline-Ms`` becomes the batcher's deadline (capped
by ``chat_timeout_s``; ``DEADLINE_PROPAGATION=0`` turns it off),
``X-Tenant`` / ``X-Priority`` place it in the fair-share admission, and
``X-Trace-Id`` / ``Traceparent`` name its trace: the response's
``stats.trace`` holds the stage marks, the envelopes carry ``trace_id``,
and a ``worker.serve`` span goes to ``<prefix>.obs.spans``. The supervisor
task (every ``SUPERVISE_INTERVAL_S``) hands a crashed or hung engine to
the registry's ``restart_engine``. ``metrics.prom`` renders the reference's
families for every feature the port has; ``profile`` captures a
``torch.profiler`` trace (CPU ranges and, on the card, every kernel) into
a worker-chosen directory, exported as a Chrome trace and zipped into the
``profiles`` bucket. A chat carrying ``X-KV-Prefill-Worker`` (disaggregated
prefill, not served here) gets an error envelope naming the header.

Cluster membership, as the reference's: every ``CLUSTER_ADVERT_INTERVAL_S``
an advert on ``lmstudio.cluster.adverts`` (``build_advert``: load, slots,
brownout, the admission ledger's headroom, models, the draining flag and
the head hashes of recent prompts) feeds the router (``serve/router.py``)
and the fleet aggregator (``obs/aggregator.py``), which steer and scrape
through the directed subjects. ``kv_export`` answers ``no_export`` (this
worker exports no KV), so a peer falls back to a local prefill.
``admin.drain`` (``begin_drain``) drops the queue subscriptions, advertises
``draining``, waits for in-flight work up to the deadline and stops the
batchers, which end what is left with the retryable "worker draining"
envelope; a chat that names this worker in ``X-Excluded-Workers``, or that
reaches it while it drains, is bounced retryably. ``metrics.prom`` carries
the efficiency plane (MFU/MBU, program flops and bytes, the device-time
ledger, the HBM ledger) unless ``EFFICIENCY=0``.

Swap-don't-shed: the worker binds the registry's ``kv_spill_factory`` to
an Object Store spill over its own connection (``_ObjectStoreSpill``,
bucket ``kv-tier``; ``KV_SPILL_OBJSTORE=0`` keeps the host tier alone),
renders the ``lmstudio_kv_tier_*`` families and advertises its host-tier
depth; the batchers' ``slot_suspend`` and ``slot_resume`` events land on
``lmstudio.events``.

Not ported yet: the drain's suspend-harvest and warm handoff
(``handoff_to``), KV export/import (``kv_import``, ``kv_handoff``) and the
disaggregated roles.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import logging
import math
import os
import tempfile
import time

from ..config import WorkerConfig
from ..obs import EVENTS, PromRenderer, Trace, new_trace_id, parse_span_context
from ..obs.roofline import efficiency_enabled
from ..transport.client import Msg, NatsClient, connect
from ..transport.envelope import deadline_remaining_s, envelope_error, envelope_ok
from ..transport.protocol import (
    ATTEMPT_HEADER,
    DEADLINE_HEADER,
    EXCLUDED_WORKERS_HEADER,
    KV_PREFILL_HEADER,
    PRIORITY_HEADER,
    STREAM_CANCEL_SUFFIX,
    TENANT_HEADER,
    TRACE_HEADER,
    TRACEPARENT_HEADER,
    WORKER_HEADER,
    parse_worker_list,
)
from .api import EngineError, ModelNotFound, Registry
from .batcher import DRAIN_ERROR
from .router import ADVERT_SUBJECT, RecentHeads, prompt_head_hash

log = logging.getLogger(__name__)

# headers of features this worker does not serve; a chat carrying one is
# answered with an error naming it
UNSUPPORTED_HEADERS = (KV_PREFILL_HEADER,)


class _ObjectStoreSpill:
    """Sync ``SpillStore`` over the worker's JetStream Object Store (bucket
    ``kv-tier``) for serve/kv_tiers.py: the tier manager's spill thread
    calls put/get/delete, each marshalled onto the worker's asyncio loop
    with ``run_coroutine_threadsafe``. The bucket is the cold KV tier that
    survives process death.

    An availability probe starts at construction and is never awaited on
    the hot path: the broker has no no-responders signalling, so a broker
    without the object-store module would otherwise stall the full timeout
    on every call. One short ``ensure_bucket``, latched both ways: ready,
    or dead for the process (the host tier stays, the cold tier is off)."""

    _PROBE_TIMEOUT_S = 2.0

    def __init__(self, nc, loop, timeout: float = 10.0):
        from ..transport.jetstream import ObjectStore

        self._store = ObjectStore(nc, timeout=timeout)
        self._loop = loop
        self._timeout = timeout
        self._bucket = "kv-tier"
        probe = ObjectStore(nc, timeout=min(self._PROBE_TIMEOUT_S, timeout))

        async def _probe_once() -> bool:
            try:
                await probe.ensure_bucket(self._bucket)
                return True
            except Exception as e:  # noqa: BLE001 — any failure = no tier
                log.warning("kv-tier object store unreachable (%s); cold KV spill "
                            "disabled for this process", type(e).__name__)
                return False

        self._probe_fut = asyncio.run_coroutine_threadsafe(_probe_once(), loop)

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(self._timeout + 5.0)

    def _alive(self, wait: bool) -> bool:
        """The probe's verdict. ``wait=False`` (reads: promotion fetches)
        treats an unresolved probe as dead for now, so lookups are instant
        misses; ``wait=True`` (the spill thread) blocks for it."""
        try:
            if wait:
                return bool(self._probe_fut.result(self._PROBE_TIMEOUT_S + 5.0))
            return self._probe_fut.done() and bool(self._probe_fut.result(0))
        except Exception:  # noqa: BLE001 — a cancelled or timed-out probe = dead
            return False

    def put(self, name: str, data: bytes) -> None:
        from ..transport.jetstream import ObjectStoreError

        if not self._alive(wait=True):
            raise ObjectStoreError("kv-tier object store unavailable")
        self._run(self._store.put(self._bucket, name, data))

    def get(self, name: str) -> bytes | None:
        from ..transport.jetstream import ObjectNotFound

        if not self._alive(wait=False):
            return None  # no (confirmed) cold tier: same as a miss
        try:
            return self._run(self._store.get(self._bucket, name))
        except ObjectNotFound:
            return None  # never spilled, or pruned: a clean miss

    def delete(self, name: str) -> None:
        if not self._alive(wait=False):
            return
        with contextlib.suppress(Exception):
            self._run(self._store.delete(self._bucket, name))


def _zip_dir(path: str) -> bytes:
    """Zip a directory tree (relative paths) into an in-memory archive; runs
    in a thread from on_profile."""
    import io
    import zipfile

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                full = os.path.join(root, f)
                zf.write(full, os.path.relpath(full, path))
    return buf.getvalue()


def _profiler_activities() -> list:
    import torch
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available()
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


def _init_profiler() -> None:
    """An empty profile, to initialize the profiler's tracing library on
    the thread that calls it. The library accepts its first initialization
    only on the thread that registered it (the one that imported torch);
    a first capture from another thread records no kernel."""
    from torch.profiler import profile

    with profile(activities=_profiler_activities()):
        pass


def _capture_profile(trace_dir: str, seconds: float, name: str) -> str:
    """Run ``torch.profiler`` for ``seconds`` (CPU ranges, and on the card
    every kernel any thread launches: CUPTI traces the whole process) and
    export a Chrome trace into ``trace_dir``. Starts and stops in this one
    thread, off the event loop (after ``_init_profiler`` has run once on
    the importing thread)."""
    import torch
    from torch.profiler import profile

    cuda = torch.cuda.is_available()
    with profile(activities=_profiler_activities()) as prof:
        time.sleep(seconds)
        if cuda:
            torch.cuda.synchronize()  # what was queued in the window lands in it
    path = os.path.join(trace_dir, f"{name}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


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
        self._profiling = False
        self._profiler_ready = False
        self._supervisor_task: asyncio.Task | None = None
        self._t0 = time.monotonic()
        # chat requests slower than this end to end land in the event ring
        # and a flight dump (0 disables)
        self._slow_request_ms = float(os.environ.get("OBS_SLOW_REQUEST_MS", "5000").strip() or 0)
        # spans emitted in one event-loop tick go out as one publish on
        # {prefix}.obs.spans; OBS_SPANS=0 turns emission off
        self._span_buf: list[dict] = []
        self._span_flush_task: asyncio.Task | None = None
        self._spans_emitted_total = 0
        # -- cluster state (serve/router.py) ---------------------------------
        self.draining = False
        self._queue_subs: list = []  # dropped on drain; directed subs stay
        self._advert_task: asyncio.Task | None = None
        self._advert_seq = 0
        self._recent_heads = RecentHeads()
        self._excluded_bounce_total = 0  # X-Excluded-Workers self-matches
        self._drain_bounce_total = 0  # chats bounced while draining

    async def start(self) -> None:
        cfg = self.config
        self.nc = await connect(
            cfg.nats_url,
            # the reference's CONNECT name: the chaos harness's worker-scoped
            # sever rule (faults.FaultPlan.sever_worker) keys on it
            name=f"tpu-worker-{self.worker_id}",
            max_reconnects=cfg.max_reconnects,
            reconnect_wait_s=cfg.reconnect_wait_s,
            reconnect_max_wait_s=cfg.reconnect_max_wait_s,
            ping_interval_s=cfg.ping_interval_s,
        )
        # the cold KV tier: hand the registry a spill factory over this
        # connection (late-bound: the registry exists before the connection)
        if (cfg.kv_spill_objstore
                and getattr(self.registry, "kv_host_pool_bytes", 0) > 0
                and getattr(self.registry, "kv_spill_factory", False) is None):
            loop = asyncio.get_running_loop()
            nc, spill_t = self.nc, cfg.kv_transfer_timeout_s
            self.registry.kv_spill_factory = (
                lambda: _ObjectStoreSpill(nc, loop, timeout=spill_t))
        subs = {
            cfg.subject("list_models"): self.on_list_models,
            cfg.subject("pull_model"): self.on_pull_model,
            cfg.subject("delete_model"): self.on_delete_model,
            cfg.subject("sync_model_from_bucket"): self.on_sync_model_from_bucket,
            cfg.subject("chat_model"): self.on_chat_model,
            cfg.subject("health"): self.on_health,
            cfg.subject("metrics"): self.on_metrics,
            cfg.subject("metrics.prom"): self.on_metrics_prom,
            cfg.subject("events"): self.on_events,
            cfg.subject("profile"): self.on_profile,
        }
        if cfg.debug_subjects:
            # slot tables and forced disk writes: only when asked for
            subs[cfg.subject("debug.snapshot")] = self.on_debug_snapshot
            subs[cfg.subject("debug.dump")] = self.on_debug_dump
        counters = getattr(self.registry, "recorder_counters", None)
        if counters is not None:
            # worker counters on every engine's recorder frames
            counters["reconnects"] = lambda: getattr(self.nc, "reconnects", 0)
            counters["requests_total"] = lambda: self._requests_total
            counters["excluded_bounces"] = lambda: self._excluded_bounce_total
            counters["drain_bounces"] = lambda: self._drain_bounce_total
        for subject, handler in subs.items():
            sub = await self.nc.subscribe(subject, queue=cfg.queue_group,
                                          cb=self._guarded(handler))
            self._queue_subs.append(sub)
        # directed per-worker subjects (plain subscriptions, not the queue
        # group): the router steers at .chat_model, the aggregator scrapes
        # .metrics.prom; they stay up through a drain
        wid_prefix = f"{cfg.subject_prefix}.worker.{self.worker_id}"
        for op, handler in (("chat_model", self.on_chat_model), ("health", self.on_health),
                            ("metrics.prom", self.on_metrics_prom),
                            ("kv_export", self.on_kv_export)):
            await self.nc.subscribe(f"{wid_prefix}.{op}", cb=self._guarded(handler))
        # drain control: a broadcast subject, each worker matches the payload
        await self.nc.subscribe(cfg.subject("admin.drain"),
                                cb=self._guarded(self.on_admin_drain))
        await self.nc.flush()
        if cfg.supervise_interval_s > 0:
            self._supervisor_task = asyncio.ensure_future(self._supervise())
        if cfg.cluster_advert_interval_s > 0:
            self._advert_task = asyncio.ensure_future(self._advert_loop())
        log.info("worker %s serving %s.* (queue=%s)", self.worker_id,
                 cfg.subject_prefix, cfg.queue_group)

    async def drain(self) -> None:
        for task in (self._supervisor_task, self._advert_task):
            if task is not None:
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await task
        self._supervisor_task = self._advert_task = None
        if self.nc is not None:
            await self.nc.drain()

    # -- cluster adverts and graceful drain ---------------------------------

    def build_advert(self) -> dict:
        """The compact membership advert ``{prefix}.cluster.adverts``
        carries: identity, load (queue depth summed over engines, the worst
        brownout level, the headroom of the admission budget), capacity
        (``slots`` summed over engines), loaded models, the draining flag
        and the head hashes of recently served prompts (the router's
        prefix-locality signal) and ``kv_tier_depth``, the host-tier entries
        of its engines (a warmer tier serves repeat prefixes without
        recompute: the router's tiebreak at equal load). Host state only: no
        CUDA call. The port has no mesh and no roles, so ``mesh`` is {} and
        ``role`` ""."""
        depth = slots = brownout = tier_depth = 0
        for eng in self.registry.loaded_engines().values():
            b = getattr(eng, "batcher", None)
            if b is None:
                continue
            depth += int(getattr(b, "queue_depth", 0) or 0)
            slots += int(getattr(b, "max_slots", 0) or 0)
            brownout = max(brownout, int(getattr(b, "brownout_level", 0) or 0))
            tier_fn = getattr(b, "tier_stats", None)
            ts = tier_fn() if tier_fn is not None else None
            if ts:
                tier_depth += int(ts.get("host_entries", 0) or 0)
        headroom_fn = getattr(self.registry, "_hbm_headroom_frac", None)
        try:
            headroom = float(headroom_fn()) if headroom_fn is not None else 1.0
        except Exception:  # noqa: BLE001 — an advert must never crash the loop
            headroom = 1.0
        return {
            "worker_id": self.worker_id,
            "role": "",
            "queue_depth": depth,
            "slots": slots,
            "brownout": brownout,
            "hbm_headroom": round(headroom, 4),
            "mesh": {},
            "models": sorted(self.registry.loaded_engines()),
            "kv_tier_depth": tier_depth,
            "draining": self.draining,
            "heads": self._recent_heads.snapshot(),
            "seq": self._advert_seq,
        }

    async def _publish_advert(self) -> None:
        if self.nc is None:
            return
        self._advert_seq += 1
        try:
            await self.nc.publish(
                self.config.subject(ADVERT_SUBJECT),
                json.dumps(self.build_advert(), separators=(",", ":")).encode(),
            )
        except (ConnectionError, ValueError):
            pass  # reconnect in flight; the next tick advertises again

    async def _advert_loop(self) -> None:
        try:
            while True:
                await self._publish_advert()
                await asyncio.sleep(self.config.cluster_advert_interval_s)
        except asyncio.CancelledError:
            return

    async def on_admin_drain(self, msg: Msg) -> None:
        """admin.drain {worker_id, deadline_s?, handoff_to?}: puts the named
        worker (or every worker, with ``"*"``) into draining mode. A
        broadcast subject: every worker hears it, only addressees act and
        reply."""
        try:
            req = self._request_object(msg.payload)
        except ValueError as e:
            await self._respond_error(msg, f"invalid JSON in Drain: {e}")
            return
        target = (req.get("worker_id") or "").strip()
        if not target:
            await self._respond_error(msg, "'worker_id' is required ('*' drains every worker)")
            return
        if target not in ("*", self.worker_id):
            return  # addressed to a peer; its reply is the reply
        try:
            deadline_s = float(req.get("deadline_s", self.config.drain_deadline_s))
        except (TypeError, ValueError):
            await self._respond_error(msg, "'deadline_s' must be a number")
            return
        handoff_to = (req.get("handoff_to") or "").strip() or None
        result = await self.begin_drain(deadline_s, handoff_to=handoff_to)
        await self._respond_ok(msg, result)

    async def begin_drain(self, deadline_s: float | None = None,
                          handoff_to: str | None = None) -> dict:
        """Graceful removal from service: drop the queue subscriptions (the
        broker routes around this worker at once), advertise the draining
        flag, let in-flight work finish up to the deadline, then stop the
        batchers, which end the remainder with the retryable "worker
        draining, retry on another worker" envelope so the client's
        RetryPolicy lands it on a peer. The directed subjects stay up: a
        draining worker still answers health and bounces chats. The warm
        handoff of hot prefixes (``handoff_to``) needs KV export, which
        this worker does not have: such a drain runs without it and says
        so (``handoff: {"ran": false}``)."""
        if deadline_s is None:
            deadline_s = self.config.drain_deadline_s
        if self.draining:
            return {"worker_id": self.worker_id, "draining": True,
                    "already_draining": True}
        self.draining = True
        # no engine restart for the whole teardown: a supervisor restart
        # sleeping out its backoff must not revive an engine being stopped
        set_drain = getattr(self.registry, "set_draining", None)
        if set_drain is not None:
            set_drain(True)
        EVENTS.emit("worker_drain", worker_id=self.worker_id,
                    deadline_s=deadline_s, handoff_to=handoff_to or "")
        log.info("worker %s draining (deadline %.1fs)", self.worker_id, deadline_s)
        for sub in self._queue_subs:
            await sub.unsubscribe()
        self._queue_subs.clear()
        await self._publish_advert()  # peers and routers see draining now
        deadline = time.monotonic() + max(0.0, deadline_s)
        finished_in_time = True
        while True:
            busy = [mid for mid, eng in self.registry.loaded_engines().items()
                    if getattr(getattr(eng, "batcher", None), "alive", False)
                    and not getattr(eng.batcher, "idle", True)]
            if not busy:
                break
            if time.monotonic() >= deadline:
                finished_in_time = False
                log.warning("worker %s drain deadline: %s still busy; failing the "
                            "remainder retryably", self.worker_id, busy)
                break
            await asyncio.sleep(0.05)
        stopped = []
        for mid, eng in list(self.registry.loaded_engines().items()):
            b = getattr(eng, "batcher", None)
            if b is not None and getattr(b, "alive", False) and hasattr(b, "stop"):
                # stop() fails in-flight requests with the draining error
                # and joins the owner thread: keep the event loop breathing
                await asyncio.to_thread(b.stop, DRAIN_ERROR)
                stopped.append(mid)
        await self._publish_advert()
        result = {
            "worker_id": self.worker_id,
            "draining": True,
            "finished_in_time": finished_in_time,
            "stopped_engines": stopped,
            "deadline_s": deadline_s,
        }
        if handoff_to and handoff_to != self.worker_id:
            result["handoff"] = {"to": handoff_to, "ran": False,
                                 "reason": "this worker exports no KV"}
        return result

    async def _supervise(self) -> None:
        """Engine watchdog: every ``supervise_interval_s`` check each loaded
        batcher's owner thread, crashed (its requests were already failed
        retryably) or hung (heartbeat stale while not idle: an idle owner
        blocks on its inbox and stops stamping), and hand it to the
        registry's restart path. The watchdog itself never dies: every
        engine's action is guarded."""
        cfg = self.config
        hb_timeout = cfg.engine_heartbeat_timeout_s
        restart = getattr(self.registry, "restart_engine", None)
        try:
            while True:
                await asyncio.sleep(cfg.supervise_interval_s)
                if self.draining:
                    continue  # the drain stops batchers on purpose
                for mid, eng in list(self.registry.loaded_engines().items()):
                    b = getattr(eng, "batcher", None)
                    if b is None or not hasattr(b, "alive"):
                        continue  # engines without an owner loop
                    try:
                        dead = not b.alive
                        hung = (not dead and hb_timeout > 0 and not b.idle
                                and b.heartbeat_age_s() > hb_timeout)
                        if not dead and not hung:
                            continue
                        why = "crashed" if dead else (
                            f"hung (heartbeat {b.heartbeat_age_s():.1f}s stale)")
                        log.warning("supervisor: engine %s %s", mid, why)
                        EVENTS.emit("engine_supervisor", model=mid, state=why)
                        if restart is not None:
                            outcome = await restart(mid, reason=why)
                            log.info("supervisor: engine %s -> %s", mid, outcome)
                    except Exception:  # noqa: BLE001 — the watchdog must survive
                        log.exception("supervisor action for %s failed", mid)
        except asyncio.CancelledError:
            return

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

    async def _respond_error(self, msg: Msg, error: str, data=None, headers=None,
                             trace_id=None) -> None:
        await self._respond_json(msg, envelope_error(error, data, trace_id=trace_id),
                                 headers=headers)

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
        success wraps {http_status, response}. The trace (the client's
        ``X-Trace-Id``, or a new id) is stamped by the batcher at its stage
        transitions; the final envelope carries ``trace_id`` and the
        response ``stats.trace`` the waterfall."""
        self._requests_total += 1
        hdrs = msg.headers or {}
        try:
            attempt = int(hdrs[ATTEMPT_HEADER]) if ATTEMPT_HEADER in hdrs else None
        except (TypeError, ValueError):
            attempt = None
        parent = parse_span_context(hdrs.get(TRACEPARENT_HEADER))
        trace = Trace(hdrs.get(TRACE_HEADER) or new_trace_id(), attempt=attempt,
                      parent_span_id=parent[1] if parent else "")
        trace.mark("recv")
        if self.worker_id in parse_worker_list(hdrs.get(EXCLUDED_WORKERS_HEADER)):
            # a queue-group redelivery landed the retry back on the worker
            # that just shed or failed it: bounce retryably so the next hop
            # (with this worker in the header) reaches a peer
            self._excluded_bounce_total += 1
            await self._respond_error(
                msg, "worker excluded by this request's retry history, "
                "retry on another worker",
                # a one-shot deflection: the client drops this worker from
                # the exclusion list after it, so a single-worker group can
                # still serve the next attempt
                {"worker_id": self.worker_id, "excluded_bounce": True},
                trace_id=trace.trace_id)
            self._emit_span(trace.to_span("worker.serve", self.worker_id,
                                          attrs={"outcome": "excluded_bounce"}))
            return
        if self.draining:
            self._drain_bounce_total += 1
            await self._respond_error(msg, "worker draining, retry on another worker",
                                      {"worker_id": self.worker_id}, trace_id=trace.trace_id)
            self._emit_span(trace.to_span("worker.serve", self.worker_id,
                                          attrs={"outcome": "drain_bounce"}))
            return
        if not msg.payload:
            await self._respond_error(msg, "empty payload in ChatModel", trace_id=trace.trace_id)
            return
        try:
            payload = json.loads(msg.payload)
            if not isinstance(payload, dict):
                raise ValueError("payload must be a JSON object")
        except ValueError as e:
            await self._respond_error(msg, f"invalid JSON in ChatModel: {e}",
                                      trace_id=trace.trace_id)
            return
        model_id = (payload.get("model") or "").strip()
        if not model_id:
            await self._respond_error(msg, "'model' is required in ChatModel",
                                      trace_id=trace.trace_id)
            return
        if payload.get("stream") and not msg.reply:
            return  # fire-and-forget stream request: nowhere to send tokens
        streaming = bool(payload.get("stream"))
        if self.config.router_prefix_head_chars > 0:
            # this prompt's head: the advert's ``heads`` set is the router's
            # prefix-cache locality signal (the same hash on both sides)
            self._recent_heads.add(prompt_head_hash(
                model_id, payload.get("messages"), self.config.router_prefix_head_chars))
        for h in UNSUPPORTED_HEADERS:
            if hdrs.get(h):
                await self._error_terminal(
                    msg, f"error in chat: unsupported header {h!r}: not served by "
                    f"this worker", {"model": model_id}, streaming, trace)
                return
        payload["_trace"] = trace  # engines pop it
        # tenant identity and priority class from the bus headers; callers
        # that set neither serve as the anonymous standard tenant
        if hdrs.get(TENANT_HEADER):
            payload["_tenant"] = str(hdrs[TENANT_HEADER])
        if hdrs.get(PRIORITY_HEADER):
            payload["_priority"] = str(hdrs[PRIORITY_HEADER])
        if self.config.deadline_propagation:
            # the client's budget (X-Deadline-Ms, wall ms) as a monotonic
            # deadline capped by the per-op timeout; an expired budget still
            # flows through and is shed retryably at submit
            remaining = deadline_remaining_s(hdrs.get(DEADLINE_HEADER))
            if remaining is not None:
                payload["_deadline"] = time.monotonic() + min(remaining,
                                                              self.config.chat_timeout_s)
        try:
            async with asyncio.timeout(self.config.chat_timeout_s):
                engine = await self.registry.get_engine(model_id)
                if streaming:
                    await self._chat_streaming(msg, engine, payload, trace)
                else:
                    response = await engine.chat(payload)
                    usage = response.get("usage") or {}
                    self._tokens_total += usage.get("completion_tokens", 0)
                    trace.mark("publish")
                    self._finish_trace(trace, model_id, response)
                    await self._respond_json(
                        msg, envelope_ok({"http_status": 200, "response": response},
                                         trace_id=trace.trace_id))
        except asyncio.TimeoutError:
            await self._error_terminal(
                msg, "error in chat: deadline exceeded", {"model": model_id}, streaming, trace)
        except ModelNotFound as e:
            await self._error_terminal(
                msg, f"model not found: {e}", {"model": model_id}, streaming, trace)
        except EngineError as e:
            await self._error_terminal(
                msg, f"error in chat: {e}", {"model": model_id}, streaming, trace)
        except Exception as e:  # noqa: BLE001 — a mid-stream crash still ends the stream
            log.exception("chat handler failed for %s", model_id)
            await self._error_terminal(
                msg, f"internal error: {e}", {"model": model_id}, streaming, trace)

    def _finish_trace(self, trace: Trace, model_id: str, response) -> None:
        """Put the stage waterfall into the response's stats block, emit the
        serve span, and record a slow request in the event ring and a
        flight dump."""
        report = trace.report()
        if isinstance(response, dict):
            response.setdefault("stats", {})["trace"] = report
        total_ms = report["spans_ms"].get("total_ms", 0.0)
        self._emit_span(trace.to_span("worker.serve", self.worker_id,
                                      attrs={"model": model_id, "outcome": "ok",
                                             "role": "monolithic"}))
        if self._slow_request_ms and total_ms > self._slow_request_ms:
            EVENTS.emit("slow_request", model=model_id, trace_id=trace.trace_id,
                        total_ms=total_ms, spans_ms=report["spans_ms"])
            eng = self.registry.loaded_engines().get(model_id)
            recorder = getattr(getattr(eng, "batcher", None), "recorder", None)
            if recorder is not None:
                recorder.dump("slow_request", trace=report,
                              extra={"model": model_id, "total_ms": round(total_ms, 1)})

    async def _error_terminal(self, msg: Msg, error: str, data, streaming: bool,
                              trace: Trace | None = None) -> None:
        """Error reply that, mid-stream, still carries ``Nats-Stream-Done``."""
        headers = {"Nats-Stream-Done": "1"} if streaming else None
        await self._respond_error(msg, error, data, headers=headers,
                                  trace_id=trace.trace_id if trace is not None else None)
        if trace is not None:
            self._emit_span(trace.to_span("worker.serve", self.worker_id,
                                          attrs={"outcome": "error", "error": error[:160]}))

    def _emit_span(self, span: dict) -> None:
        """Buffer one span for a fire-and-forget batch publish on
        ``{prefix}.obs.spans`` (spans of one event-loop tick share it)."""
        if self.nc is None or not self.config.obs_spans:
            return
        self._span_buf.append(span)
        self._spans_emitted_total += 1
        if self._span_flush_task is None or self._span_flush_task.done():
            self._span_flush_task = asyncio.ensure_future(self._flush_spans())

    async def _flush_spans(self) -> None:
        await asyncio.sleep(0)  # let same-tick spans join this batch
        batch, self._span_buf = self._span_buf, []
        if not batch or self.nc is None:
            return
        try:
            await self.nc.publish(self.config.subject("obs.spans"),
                                  json.dumps({"spans": batch}, separators=(",", ":")).encode())
        except (ConnectionError, ValueError):
            pass  # spans are diagnostics: lost on a reconnect, by design

    async def _chat_streaming(self, msg: Msg, engine, payload: dict, trace: Trace) -> None:
        assert self.nc is not None
        final: dict | None = None
        seq = 0
        model_id = payload.get("model", "")
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
            trace.mark("publish")
            self._emit_span(trace.to_span("worker.serve", self.worker_id,
                                          attrs={"model": model_id, "outcome": "cancelled"}))
            return
        if final is None:
            raise EngineError("engine stream ended without a chat.completion aggregate")
        usage = final.get("usage") or {}
        self._tokens_total += usage.get("completion_tokens", 0)
        trace.mark("publish")
        self._finish_trace(trace, model_id, final)
        await self.nc.publish(
            msg.reply,
            envelope_ok({"http_status": 200, "response": final}, trace_id=trace.trace_id),
            headers={"Nats-Stream-Done": "1", "X-Seq": str(seq),
                     WORKER_HEADER: self.worker_id},
        )

    async def on_kv_export(self, msg: Msg) -> None:
        """kv_export (directed only): this worker exports no KV, so it gives
        the reply of a reference engine that cannot export, ``{no_export:
        true}`` as the stream's terminal message: a peer that asks (a stale
        role map) prefills locally instead of waiting out its timeout."""
        self._requests_total += 1
        if not msg.reply:
            return  # nowhere to answer
        try:
            payload = self._request_object(msg.payload)
        except ValueError as e:
            await self._error_terminal(msg, f"invalid JSON in KvExport: {e}", None, True)
            return
        if not (payload.get("model") or "").strip():
            await self._error_terminal(msg, "'model' is required in KvExport", None, True)
            return
        await self._respond_json(msg, envelope_ok({"no_export": True}),
                                 headers={"Nats-Stream-Done": "1"})

    async def on_health(self, msg: Msg) -> None:
        """health: counters, the registry's stats, each engine's liveness
        (``engines``) and the poisoned models (``poisoned``)."""
        data = {
            "status": "draining" if self.draining else "ok",
            "worker_id": self.worker_id,
            "role": "",
            "draining": self.draining,
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
        poisoned_fn = getattr(self.registry, "poisoned_models", None)
        if poisoned_fn is not None:
            poisoned = poisoned_fn()
            if poisoned:
                data["poisoned"] = sorted(poisoned)
                # why each is refused (the crash count, or the CUDA error
                # that killed the context): the names alone replace the
                # registry's reasons under "poisoned"
                data["poisoned_reasons"] = poisoned
        await self._respond_ok(msg, data)

    async def on_metrics(self, msg: Msg) -> None:
        """metrics: worker totals, the registry's stats, each engine's
        batcher stats and the devices (from ``torch.cuda``: index,
        ``"platform": "gpu"``, the card's name)."""
        import torch

        engines = {}
        for mid, eng in self.registry.loaded_engines().items():
            batcher = getattr(eng, "batcher", None)
            if batcher is not None and hasattr(batcher, "stats"):
                engines[mid] = batcher.stats.snapshot()
        if torch.cuda.is_available():
            devices = [{"id": i, "platform": "gpu", "kind": torch.cuda.get_device_name(i)}
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [{"id": 0, "platform": "cpu", "kind": "cpu"}]
        await self._respond_ok(msg, {
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "requests_total": self._requests_total,
            "tokens_total": self._tokens_total,
            "queue_group": self.config.queue_group,
            "registry": self.registry.stats(),
            "engines": engines,
            "devices": devices,
        })

    def render_prometheus(self) -> str:
        """Worker totals, registry gauges and each engine's batcher
        counters and histograms as Prometheus text, under the reference's
        family names, labels and help strings. Families of features the
        port does not have yet (KV transfer, the mesh, XLA's compile cache
        and recompiles, the legacy ring) are left out."""
        eff = efficiency_enabled()
        r = PromRenderer(default_labels={"worker_id": self.worker_id})
        r.gauge("lmstudio_uptime_seconds", round(time.monotonic() - self._t0, 3))
        r.gauge("lmstudio_draining", 1 if self.draining else 0,
                help="1 while this worker is in graceful drain")
        r.counter("lmstudio_excluded_bounce_total", self._excluded_bounce_total,
                  help="chat requests bounced retryably because this worker "
                       "appeared in their X-Excluded-Workers header")
        r.counter("lmstudio_drain_bounce_total", self._drain_bounce_total,
                  help="chat requests bounced retryably while draining")
        r.counter("lmstudio_spans_emitted_total", self._spans_emitted_total,
                  help="trace spans published on the obs.spans subject")
        r.counter("lmstudio_requests_total", self._requests_total,
                  help="NATS requests handled by this worker")
        r.counter("lmstudio_tokens_total", self._tokens_total,
                  help="completion tokens generated")
        r.counter("lmstudio_streams_cancelled_total", self._streams_cancelled,
                  help="streaming chats aborted because the consumer vanished")
        reg = self.registry.stats()
        for key in ("models_cached", "models_loaded", "engine_requests",
                    "hbm_committed_bytes"):
            v = reg.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                r.gauge(f"lmstudio_registry_{key}", v)
        # the HBM ledger (ticked by the flight recorder): priced components
        # against the allocator's bytes (zeros on the CPU)
        hbm = reg.get("hbm_ledger")
        if eff and isinstance(hbm, dict) and hbm:
            r.gauge("lmstudio_hbm_bytes_in_use", hbm.get("bytes_in_use", 0),
                    help="allocator bytes_in_use at the last ledger tick "
                         "(0 on backends without memory_stats)")
            r.gauge("lmstudio_hbm_priced_bytes", hbm.get("priced_bytes", 0),
                    help="sum of priced HBM components (weights+pool, "
                         "prefix cache, workspace slack)")
            r.gauge("lmstudio_hbm_unexplained_bytes", hbm.get("unexplained_bytes", 0),
                    help="bytes_in_use minus priced components")
            r.gauge("lmstudio_hbm_drift_bytes", hbm.get("drift_bytes", 0),
                    help="unexplained-bytes growth above the ledger baseline")
        ledger = getattr(self.registry, "hbm_ledger", None)
        if eff and ledger is not None:
            r.counter("lmstudio_hbm_drift_events_total", getattr(ledger, "drift_events", 0),
                      help="hbm_drift events fired (unexplained bytes grew "
                           "monotonically past the threshold)")
        r.gauge("lmstudio_events_emitted_total", EVENTS.emitted)
        r.counter("lmstudio_reconnects_total", getattr(self.nc, "reconnects", 0),
                  help="NATS connection re-establishments by this worker")
        r.counter("lmstudio_engine_restarts_total",
                  getattr(self.registry, "engine_restarts_total", 0),
                  help="supervisor-driven engine restarts")
        engines = self.registry.loaded_engines()
        inflight_failed = getattr(self.registry, "inflight_failed_retryable", 0)
        for eng in engines.values():
            stats = getattr(getattr(eng, "batcher", None), "stats", None)
            # live batchers' counts; crashed ones were taken into the
            # registry's total at restart, so none is counted twice
            inflight_failed += getattr(stats, "inflight_failed_retryable", 0)
        r.counter("lmstudio_inflight_failed_retryable_total", inflight_failed,
                  help="in-flight requests failed with a retryable envelope "
                       "by an engine crash")
        poisoned_fn = getattr(self.registry, "poisoned_models", None)
        if poisoned_fn is not None:
            r.gauge("lmstudio_engines_poisoned", len(poisoned_fn()))
        restart_hist = getattr(self.registry, "restart_latency_ms", None)
        if restart_hist is not None:
            r.histogram("lmstudio_engine_restart_ms", restart_hist.snapshot())
        for mid, eng in engines.items():
            rb = getattr(eng, "batcher", None)
            stats = getattr(rb, "stats", None)
            if stats is None or not hasattr(stats, "histograms"):
                continue
            labels = {"model": mid}
            for name, v in stats.counters().items():
                r.counter(f"lmstudio_batcher_{name}_total", v, labels=labels)
            r.gauge("lmstudio_batcher_peak_active_slots", stats.peak_active, labels=labels)
            causes = stats.shed_cause_counts()
            for cause, v in causes.items():
                r.counter("lmstudio_batcher_shed_by_cause_total", v,
                          labels={**labels, "cause": cause})
            # per-tenant serving counters under a capped ``tenant`` label:
            # the top-K tenants by volume keep their rows, the rest roll up
            # into tenant="other"
            tstats = getattr(rb, "tenant_stats", None)
            if tstats is not None:
                for tenant, row in sorted(tstats.snapshot(self.config.qos_tenant_topk).items()):
                    tl = {**labels, "tenant": tenant}
                    for key, fam in (
                        ("requests", "lmstudio_tenant_requests_total"),
                        ("served", "lmstudio_tenant_served_total"),
                        ("shed", "lmstudio_tenant_shed_total"),
                        ("preempted", "lmstudio_tenant_preempted_total"),
                        ("tokens", "lmstudio_tenant_tokens_total"),
                    ):
                        r.counter(fam, row.get(key, 0), labels=tl)
                    r.counter("lmstudio_tenant_queue_age_ms_total",
                              round(row.get("queue_age_ms_sum", 0.0), 3), labels=tl,
                              help="summed enqueue->admit wait ms of served "
                                   "requests, by tenant (the fairness "
                                   "signal: divide by served for the mean)")
            # deadline and brownout families: always present, zero when quiet
            r.counter("lmstudio_deadline_shed_total", causes.get("deadline", 0), labels=labels,
                      help="requests shed because the client deadline "
                           "expired or became infeasible before prefill")
            r.counter("lmstudio_deadline_aborted_total",
                      stats.cancel_causes.get("deadline", 0), labels=labels,
                      help="mid-decode slots aborted past the client deadline")
            r.gauge("lmstudio_brownout_level", getattr(rb, "brownout_level", 0), labels=labels,
                    help="0=normal 1=brownout 2=shed-only")
            for name, v in stats.spec_counters().items():
                r.counter(f"lmstudio_spec_{name}_total", v, labels=labels)
            tier_fn = getattr(rb, "tier_stats", None)
            tier = tier_fn() if tier_fn is not None else None
            if tier:
                # the host KV tier and slot suspend/resume: gauges for the
                # host tier's occupancy, counters for the chunk traffic
                # between tiers and the swap-don't-shed slot movements
                for name in ("host_entries", "host_bytes", "host_budget_bytes",
                             "spill_pending"):
                    if name in tier:
                        r.gauge(f"lmstudio_kv_tier_{name}", tier[name], labels=labels)
                r.gauge("lmstudio_kv_tier_suspended_slots", tier.get("suspended", 0),
                        labels=labels,
                        help="slots currently swapped out to the host tier "
                             "awaiting resume")
                for name in ("demoted_chunks", "promoted_chunks", "demote_failures",
                             "host_hits", "host_misses", "spilled_blobs", "fetched_blobs",
                             "spill_failures", "fetch_failures", "demoted_blocks",
                             "suspended_total", "resumed_total", "suspend_failures",
                             "suspended_deadline_expired"):
                    if name in tier:
                        # keys like suspended_total carry the suffix already
                        base = name[:-6] if name.endswith("_total") else name
                        r.counter(f"lmstudio_kv_tier_{base}_total", tier[name],
                                  labels=labels)
            for name, h in stats.histograms().items():
                r.histogram(f"lmstudio_{name}", h.snapshot(), labels=labels)
            # per-program host dispatch time, one labeled histogram family
            for name, h in sorted(stats.program_histograms().items()):
                r.histogram("lmstudio_program_ms", h.snapshot(),
                            labels={**labels, "program": name})
            for name, h in sorted(stats.program_token_histograms().items()):
                r.histogram("lmstudio_program_tokens", h.snapshot(),
                            labels={**labels, "program": name})
            if eff and hasattr(stats, "cost_counters"):
                # the efficiency plane (obs/roofline.py): per-program
                # analytic flops and bytes, rolling MFU/MBU by class, and the
                # device-time ledger
                flops, bytes_ = stats.cost_counters()
                for name, v in sorted(flops.items()):
                    r.counter("lmstudio_program_flops_total", v,
                              labels={**labels, "program": name},
                              help="flops dispatched, by program (analytic "
                                   "count from the dispatch's shapes)")
                for name, v in sorted(bytes_.items()):
                    r.counter("lmstudio_program_bytes_total", v,
                              labels={**labels, "program": name},
                              help="bytes accessed, by program (analytic "
                                   "count from the dispatch's shapes)")
                util = stats.utilization()
                for cls in ("prefill", "decode"):
                    cl = {**labels, "class": cls}
                    r.gauge("lmstudio_mfu", round(util[cls]["mfu"], 6), labels=cl,
                            help="achieved / peak FLOP rate over a rolling "
                                 "window, by program class")
                    r.gauge("lmstudio_mbu", round(util[cls]["mbu"], 6), labels=cl,
                            help="achieved / peak HBM bandwidth over a "
                                 "rolling window, by program class")
                dt = stats.device_time_snapshot()
                for cat in sorted(dt["ms"]):
                    cl = {**labels, "category": cat}
                    r.counter("lmstudio_device_ms_total", round(dt["ms"][cat], 3), labels=cl,
                              help="device-dispatch milliseconds attributed "
                                   "to a request outcome category")
                    r.counter("lmstudio_device_tokens_total", dt["tokens"].get(cat, 0),
                              labels=cl,
                              help="tokens delivered, by outcome category "
                                   "of the device time that produced them")
                r.gauge("lmstudio_goodput_tokens_per_device_s",
                        round(stats.goodput_tokens_per_device_s(), 3), labels=labels,
                        help="served tokens per device-second across ALL "
                             "attributed device time (waste included in "
                             "the denominator)")
            pool_stats_fn = getattr(rb, "pool_stats", None)
            pool = pool_stats_fn() if pool_stats_fn is not None else None
            if pool is not None:
                for name in ("blocks_total", "blocks_free", "blocks_shared"):
                    r.gauge(f"lmstudio_kv_pool_{name}", pool[name], labels=labels)
                r.counter("lmstudio_kv_pool_cow_copies_total", pool["cow_copies"],
                          labels=labels,
                          help="copy-on-write block duplications (a shared "
                               "block written by a live slot)")
            pcache = getattr(rb, "prefix_cache", None)
            if pcache is not None:
                for name, v in pcache.counters().items():
                    r.counter(f"lmstudio_prefix_cache_{name}_total", v, labels=labels)
                r.gauge("lmstudio_prefix_cache_blocks", pcache.blocks, labels=labels)
                r.gauge("lmstudio_prefix_cache_bytes", pcache.bytes, labels=labels)
                r.histogram("lmstudio_prefix_hit_tokens", pcache.hit_tokens_hist.snapshot(),
                            labels=labels)
        return r.render()

    async def on_metrics_prom(self, msg: Msg) -> None:
        """metrics.prom: the Prometheus text itself, not an envelope."""
        await self._respond_json(msg, self.render_prometheus().encode())

    @staticmethod
    def _optional_object(payload: bytes) -> dict:
        req = json.loads(payload) if payload and payload.strip() else {}
        if not isinstance(req, dict):
            raise ValueError("payload must be a JSON object")
        return req

    async def on_events(self, msg: Msg) -> None:
        """events: the event ring (sheds, cancels, brownout transitions,
        engine crash/restart/poison, loads and unloads, slow requests).
        Payload (optional) ``{kind?, limit?}`` (default 100, newest)."""
        if not msg.reply:
            return  # a broadcast on <prefix>.events: nothing to answer
        try:
            req = self._optional_object(msg.payload)
        except ValueError as e:
            await self._respond_error(msg, f"invalid JSON in Events: {e}")
            return
        try:
            limit = int(req.get("limit", 100))
        except (TypeError, ValueError):
            await self._respond_error(msg, "'limit' must be an integer")
            return
        await self._respond_ok(msg, {
            "events": EVENTS.snapshot(kind=req.get("kind"), limit=limit),
            "emitted_total": EVENTS.emitted,
            "dropped": EVENTS.dropped,
            "capacity": EVENTS.capacity,
        })

    async def on_profile(self, msg: Msg) -> None:
        """profile: capture a ``torch.profiler`` trace for ``seconds``
        (default 2, at most 60) into a worker-chosen directory (a client
        path would be a directory-write primitive), one capture at a time,
        and reply with its path; the zipped trace also goes to the
        ``profiles`` bucket when the broker has the object store."""
        try:
            req = json.loads(msg.payload) if msg.payload.strip() else {}
        except ValueError as e:
            await self._respond_error(msg, f"invalid JSON in Profile: {e}")
            return
        seconds = float(req.get("seconds", 2.0))
        if not math.isfinite(seconds):
            await self._respond_error(msg, "'seconds' must be finite")
            return
        seconds = max(0.0, min(seconds, 60.0))
        if self._profiling:
            await self._respond_error(msg, "a profile capture is already running")
            return
        self._profiling = True
        trace_dir = tempfile.mkdtemp(prefix="torch_trace_")
        try:
            if not self._profiler_ready:
                # once a process, here: the event loop runs on the thread
                # that imported torch (the profiler's first initialization
                # must); it blocks the loop for the library's start-up
                _init_profiler()
                self._profiler_ready = True
            trace_file = await asyncio.to_thread(_capture_profile, trace_dir, seconds,
                                                 self.worker_id)
        finally:
            self._profiling = False
        reply: dict = {"trace_dir": trace_dir, "trace_file": trace_file, "seconds": seconds}
        try:
            blob = await asyncio.to_thread(_zip_dir, trace_dir)
            digest = hashlib.sha256(blob).hexdigest()
            from ..transport.jetstream import ObjectStore

            assert self.nc is not None
            # a short API timeout: a broker without the object store never
            # answers, and the reply must not wait the window out
            store = ObjectStore(self.nc, timeout=5.0)
            bucket = "profiles"
            obj = f"{self.worker_id}-{digest[:16]}.zip"
            await store.ensure_bucket(bucket)
            await store.put(bucket, obj, blob)
            reply.update(bucket=bucket, object=obj, sha256=digest, bytes=len(blob))
        except Exception as e:  # noqa: BLE001 — the upload is an extra
            log.warning("profile upload failed (%s: %s); trace stays local at %s",
                        type(e).__name__, e, trace_dir)
        await self._respond_ok(msg, reply)

    async def on_debug_snapshot(self, msg: Msg) -> None:
        """debug.snapshot: each loaded engine's batcher internals (slot
        tables with block refcounts, pool, prefix cache, brownout, the
        recorder's tail). Payload (optional) ``{model?}``."""
        try:
            req = self._optional_object(msg.payload)
        except ValueError as e:
            await self._respond_error(msg, f"invalid JSON in DebugSnapshot: {e}")
            return
        want = (req.get("model") or "").strip() or None
        engines = {}
        for mid, eng in self.registry.loaded_engines().items():
            if want is not None and mid != want:
                continue
            snap_fn = getattr(getattr(eng, "batcher", None), "debug_snapshot", None)
            if snap_fn is not None:
                engines[mid] = snap_fn()
        if want is not None and not engines:
            await self._respond_error(msg, f"model not loaded: {want}")
            return
        await self._respond_ok(msg, {"worker_id": self.worker_id, "role": "",
                                     "engines": engines})

    async def on_debug_dump(self, msg: Msg) -> None:
        """debug.dump: force a flight-recorder dump of every loaded engine
        (or ``{model?}``) into the worker's OBS_DUMP_DIR and reply with the
        paths."""
        try:
            req = self._optional_object(msg.payload)
        except ValueError as e:
            await self._respond_error(msg, f"invalid JSON in DebugDump: {e}")
            return
        want = (req.get("model") or "").strip() or None
        paths = {}
        for mid, eng in self.registry.loaded_engines().items():
            if want is not None and mid != want:
                continue
            recorder = getattr(getattr(eng, "batcher", None), "recorder", None)
            if recorder is not None:
                path = recorder.dump("debug_request", force=True, extra={"model": mid})
                if path:
                    paths[mid] = path
        if not paths:
            await self._respond_error(
                msg, "no dump written (recorder disabled, OBS_DUMP_DIR unset, "
                "or no engine loaded)")
            return
        await self._respond_ok(msg, {"dumps": paths})
