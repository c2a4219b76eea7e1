"""Cluster membership + failover routing (queue-group scale-out made
fault-tolerant).

Copy of ``nats_llm_studio_tpu/serve/router.py`` (pure Python, no change of
behaviour), so the port's workers, its ``route`` command and its gateway
steer without the JAX package; both packages' routers ingest both
packages' adverts.

Every worker periodically publishes a compact advert on
``{prefix}.cluster.adverts`` — worker id, queue depth, brownout level, HBM
headroom, loaded models, draining flag, and the head hashes of recently
served prompts. A :class:`ClusterRouter` subscribes, keeps a live member
table, and steers chat requests at the *directed* per-worker subject
(``{prefix}.worker.<id>.chat_model``) by advertised load and prefix-cache
locality, falling back to the plain queue-group subject when no advert is
live (a router with an empty table degrades to exactly the pre-cluster
behavior — random queue-group delivery — never to an outage).

Usable two ways:

* **in-process**: attach to a ``NatsClient`` and call
  :meth:`ClusterRouter.request_chat` instead of ``nc.request`` — the retry
  loop re-picks a different worker per attempt and carries the
  ``X-Excluded-Workers`` header so a shed/crashed worker is never retried
  immediately.
* **standalone**: :class:`RouterProcess` (``python -m nats_llm_studio_tpu_torch
  route``) forwards ``{prefix}.route.chat_model`` requests to the picked
  worker and relays the reply — a thin L7 balancer for clients that want
  steering without importing this package.

Prefix-cache locality is approximated with a *text* head hash
(:func:`prompt_head_hash`): the server-side radix cache keys on token-id
chunks, but the router has no tokenizer — hashing the first N chars of the
prompt is cheap, tokenizer-free, and identical on both sides. Equal text
heads tokenize equally, so a head-hash hit implies real prefix-cache reuse
on the sticky worker; a miss merely loses the locality bonus.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from dataclasses import dataclass, field
from hashlib import blake2b

from ..obs import (
    Span,
    new_span_id,
    new_trace_id,
    parse_span_context,
    span_context_value,
)
from ..transport import ConnectionClosedError, Msg, NatsClient, RetryPolicy
from ..transport import protocol as p
from ..transport.envelope import (
    deadline_header_value,
    deadline_remaining_s,
    is_retryable_envelope,
)

log = logging.getLogger(__name__)

ADVERT_SUBJECT = "cluster.adverts"  # published under the subject prefix
ROUTE_SUBJECT = "route.chat_model"  # RouterProcess's forwarding subject
DEFAULT_HEAD_CHARS = 256
# seq-ordering guard bounds (ingest): a backward seq step within
# SEQ_REORDER_WINDOW is a stale/reordered packet and is dropped; a jump
# further back than that — or an advert numbered within SEQ_RESTART_MAX
# while we hold a higher seq — is a RESPAWNED worker whose counter
# restarted at 1, and must replace the dead incarnation's advert NOW
# instead of being ignored until staleness ages it out.
SEQ_REORDER_WINDOW = 64
SEQ_RESTART_MAX = 3


class RouterExhausted(asyncio.TimeoutError):
    """Retry budget exhausted without a served reply.

    Subclasses :class:`asyncio.TimeoutError` so existing ``except
    asyncio.TimeoutError`` handlers keep working, but carries structure an
    HTTP front end needs to render an honest 503: the final *retryable*
    envelope (if one was received), the last worker that shed the request,
    and a retry-after hint derived from the retry policy's backoff — instead
    of flattening all of that into a bare exception string.
    """

    def __init__(
        self,
        message: str,
        *,
        envelope: dict | None = None,
        worker_id: str | None = None,
        retry_after_s: float = 1.0,
    ):
        super().__init__(message)
        self.envelope = envelope if isinstance(envelope, dict) else None
        self.worker_id = worker_id
        self.retry_after_s = max(0.0, float(retry_after_s))

    def detail(self) -> str:
        """The most specific human-readable cause available."""
        if self.envelope is not None:
            err = self.envelope.get("error")
            if isinstance(err, str) and err:
                return err
        return str(self) or "retry budget exhausted"


def prompt_head_hash(model: str, messages, chars: int = DEFAULT_HEAD_CHARS) -> str:
    """Hash of the prompt head, for prefix-cache locality steering.

    Computed identically by the worker (recording heads it served) and the
    router (steering new requests): blake2b-64 over the model name and the
    first ``chars`` characters of the concatenated message contents. Role
    and content are length-delimited so ("ab","c") can't collide with
    ("a","bc") across message boundaries.
    """
    h = blake2b(digest_size=8)
    h.update(model.encode())
    budget = max(0, chars)
    for m in messages if isinstance(messages, list) else []:
        if budget <= 0:
            break
        if not isinstance(m, dict):
            continue
        role = str(m.get("role", ""))
        content = str(m.get("content", ""))[:budget]
        budget -= len(content)
        h.update(f"\x1f{len(role)}:{role}\x1f{len(content)}:".encode())
        h.update(content.encode())
    return h.hexdigest()


class RecentHeads:
    """Bounded LRU of recently served prompt-head hashes. The worker records
    a head per admitted chat and adverts the set; the router treats a match
    as prefix-cache locality. Plain dict insertion order is the LRU."""

    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._heads: dict[str, None] = {}

    def add(self, head: str) -> None:
        self._heads.pop(head, None)
        self._heads[head] = None
        while len(self._heads) > self.capacity:
            del self._heads[next(iter(self._heads))]

    def snapshot(self) -> list[str]:
        return list(self._heads)


# coarse chars-per-token for the router's long-prompt heuristic: it has no
# tokenizer (tokenization happens on the worker), so ring-prefill preference
# keys off character length
_CHARS_PER_TOKEN = 4


def _ring_min_tokens() -> int:
    """The reference's ``parallel.ring_attention.ring_prefill_min_tokens``
    threshold (the router is pure control plane)."""
    try:
        return int(os.environ.get("RING_PREFILL_MIN_TOKENS", "4096"))
    except ValueError:
        return 4096


def _prompt_chars(messages) -> int:
    n = 0
    try:
        for m in messages or ():
            c = m.get("content") if isinstance(m, dict) else None
            if isinstance(c, str):
                n += len(c)
    except TypeError:
        return 0
    return n


@dataclass
class WorkerAdvert:
    """One worker's most recent cluster advert, as the router sees it."""

    worker_id: str
    role: str = ""  # "" monolithic / "prefill" / "decode"
    queue_depth: int = 0
    slots: int = 0  # advertised concurrent-stream capacity (dp x per-replica)
    brownout: int = 0  # 0 NORMAL / 1 BROWNOUT / 2 SHED_ONLY
    hbm_headroom: float = 1.0
    mesh: dict = field(default_factory=dict)  # named axis factoring, e.g. {"dp": 2, "tp": 2}
    models: tuple[str, ...] = ()
    kv_tier_depth: int = 0  # host-tier KV entries (warm-cache tiebreak)
    draining: bool = False
    heads: frozenset[str] = frozenset()
    seq: int = 0
    mono: float = 0.0  # ingest time (router clock; staleness = now - mono)

    @property
    def load(self) -> float:
        """Queue depth normalized by advertised slot capacity: a dp=2
        worker with 8 slots and depth 2 is LESS loaded than a dp=1 worker
        with 4 slots and depth 2. Raw depth when capacity is unknown
        (pre-multi-axis adverts)."""
        if self.slots > 0:
            return self.queue_depth / self.slots
        return float(self.queue_depth)

    @property
    def sp_degree(self) -> int:
        """Ring-attention sequence-parallel width from the advertised mesh
        (1 = no sp axis — long prefills run dense on one chip's lane)."""
        try:
            return int(self.mesh.get("sp", 1) or 1)
        except (TypeError, ValueError):
            return 1

    @classmethod
    def from_dict(cls, d: dict) -> "WorkerAdvert | None":
        wid = d.get("worker_id")
        if not isinstance(wid, str) or not wid:
            return None
        role = d.get("role")
        mesh = d.get("mesh")
        return cls(
            worker_id=wid,
            role=role if isinstance(role, str) else "",
            queue_depth=int(d.get("queue_depth") or 0),
            slots=int(d.get("slots") or 0),
            brownout=int(d.get("brownout") or 0),
            hbm_headroom=float(d.get("hbm_headroom", 1.0)),
            mesh=dict(mesh) if isinstance(mesh, dict) else {},
            models=tuple(m for m in d.get("models") or () if isinstance(m, str)),
            kv_tier_depth=int(d.get("kv_tier_depth") or 0),
            draining=bool(d.get("draining")),
            heads=frozenset(h for h in d.get("heads") or () if isinstance(h, str)),
            seq=int(d.get("seq") or 0),
            mono=time.monotonic(),
        )


@dataclass
class RouterStats:
    routed_total: int = 0  # requests steered at a directed subject
    fallback_total: int = 0  # no live member: plain queue-group subject
    locality_total: int = 0  # picks won by a prefix-head match
    dead_marked_total: int = 0  # members dropped after a timeout/sever
    two_hop_total: int = 0  # picks that paired a prefill-role worker

    def as_dict(self) -> dict:
        return {
            "routed_total": self.routed_total,
            "fallback_total": self.fallback_total,
            "locality_total": self.locality_total,
            "dead_marked_total": self.dead_marked_total,
            "two_hop_total": self.two_hop_total,
        }


class ClusterRouter:
    """Live member table + steering. One per client (or per RouterProcess).

    ``start()`` subscribes to the advert subject; until the first advert
    lands every pick falls back to the queue-group subject, so attaching a
    router is always safe — it only ever *adds* steering.
    """

    def __init__(
        self,
        nc: NatsClient,
        *,
        prefix: str = "lmstudio",
        stale_after_s: float = 5.0,
        prefix_head_chars: int = DEFAULT_HEAD_CHARS,
        queue_group_fallback: bool = True,
        obs_spans: bool | None = None,
        ident: str = "router",
    ):
        self.nc = nc
        self.prefix = prefix
        self.stale_after_s = stale_after_s
        self.prefix_head_chars = prefix_head_chars
        self.queue_group_fallback = queue_group_fallback
        # per-attempt steering spans on {prefix}.obs.spans; None defers to
        # the OBS_SPANS env kill switch so bare ClusterRouter(nc) callers
        # (tests, bench) inherit the fleet-wide setting
        if obs_spans is None:
            obs_spans = os.environ.get(
                "OBS_SPANS", "1"
            ).strip().lower() not in ("0", "false", "off")
        self.obs_spans = obs_spans
        self.ident = ident  # worker_id stamped on this router's spans
        self.stats = RouterStats()
        self._members: dict[str, WorkerAdvert] = {}
        self._sub = None
        # router-local (worker_id, tenant) -> steered requests in flight:
        # the pick tie-breaker that spreads ONE tenant's burst across
        # workers instead of stacking it behind itself on the best-ranked
        # one (other tenants' picks ignore it entirely)
        self._tenant_inflight: dict[tuple[str, str], int] = {}

    def _tenant_track(self, worker_id: str | None, tenant: str | None, d: int) -> None:
        if not worker_id or not tenant:
            return
        k = (worker_id, tenant)
        n = self._tenant_inflight.get(k, 0) + d
        if n > 0:
            self._tenant_inflight[k] = n
        else:
            self._tenant_inflight.pop(k, None)

    # -- membership ----------------------------------------------------------

    async def start(self) -> "ClusterRouter":
        self._sub = await self.nc.subscribe(
            f"{self.prefix}.{ADVERT_SUBJECT}", cb=self._on_advert
        )
        return self

    async def stop(self) -> None:
        if self._sub is not None:
            await self._sub.unsubscribe()
            self._sub = None

    async def _on_advert(self, msg: Msg) -> None:
        try:
            d = msg.json()
        except ValueError:
            return
        if isinstance(d, dict):
            self.ingest(d)

    def ingest(self, d: dict) -> None:
        """Feed one advert dict (the sub callback does this; tests and the
        bench can inject directly). Out-of-order adverts from one worker are
        dropped by seq — but a drained-then-respawned worker reusing the
        same WORKER_ID restarts its counter at 1, and its fresh adverts must
        not be mistaken for reorders of the dead incarnation's stream."""
        adv = WorkerAdvert.from_dict(d)
        if adv is None:
            return
        cur = self._members.get(adv.worker_id)
        if cur is not None and adv.seq and adv.seq < cur.seq:
            restarted = (
                adv.seq <= SEQ_RESTART_MAX
                or cur.seq - adv.seq > SEQ_REORDER_WINDOW
            )
            if not restarted:
                return
        self._members[adv.worker_id] = adv

    def mark_dead(self, worker_id: str) -> None:
        """Drop a member NOW (observed timeout/sever) instead of waiting out
        the staleness window — the next pick must not re-steer at it."""
        if self._members.pop(worker_id, None) is not None:
            self.stats.dead_marked_total += 1
            log.info("router: marked worker %s dead", worker_id)

    def members(self, *, live_only: bool = True) -> list[WorkerAdvert]:
        """Live serving members. Gateway adverts (metrics-only, no chat
        subjects) are excluded — they must not count as workers in healthz
        or become steering candidates."""
        if not live_only:
            return list(self._members.values())
        cutoff = time.monotonic() - self.stale_after_s
        return [m for m in self._members.values()
                if m.mono >= cutoff and m.role != "gateway"]

    # -- steering ------------------------------------------------------------

    def worker_subject(self, worker_id: str, op: str = "chat_model") -> str:
        """The directed (non-queue-group) subject one worker listens on."""
        return f"{self.prefix}.worker.{worker_id}.{op}"

    def pick(
        self,
        model: str | None = None,
        messages=None,
        excluded: tuple[str, ...] | list[str] = (),
        tenant: str | None = None,
    ) -> str | None:
        """Best live worker id, or None (caller falls back to the queue
        group). Role-aware: see :meth:`pick_pair` (this is its first half)."""
        return self.pick_pair(
            model=model, messages=messages, excluded=excluded, tenant=tenant
        )[0]

    def pick_pair(
        self,
        model: str | None = None,
        messages=None,
        excluded: tuple[str, ...] | list[str] = (),
        tenant: str | None = None,
    ) -> tuple[str | None, str | None]:
        """Role-aware pick: ``(serving_worker_id, prefill_worker_id)``.

        Serving candidates exclude prefill-role workers whenever any
        non-prefill member is live — a prefill worker's pool churns through
        transient prefill blocks and must not also hold long decodes. With
        no live members at all the caller falls back to the queue group;
        with ONLY prefill-role members live they serve (degraded but up).
        Ranking within candidates is unchanged: prefix-head locality first
        (a sticky worker replays the cached prefill), then brownout level,
        then model-loaded, then queue depth. Draining and excluded workers
        never win.

        The second element is the best live prefill-role worker, returned
        only when the serving pick is decode-role — the caller stamps it in
        ``X-KV-Prefill-Worker`` so the decode worker pulls the prompt's KV
        blocks from it (the disaggregated two-hop). Monolithic picks never
        pair: they prefill locally anyway."""
        head = None
        if model and messages and self.prefix_head_chars > 0:
            head = prompt_head_hash(model, messages, self.prefix_head_chars)
        # ring-capable preference: a prompt long enough to take the sp
        # ring-prefill path (chars/4 >= RING_PREFILL_MIN_TOKENS) prefers a
        # worker whose advertised mesh has sp > 1 — there the prefill runs
        # sequence-parallel instead of serializing on one chip's lane
        long_prompt = (
            messages is not None
            and _prompt_chars(messages) >= _CHARS_PER_TOKEN * _ring_min_tokens()
        )
        candidates = [
            m for m in self.members()
            if not m.draining and m.worker_id not in excluded
        ]
        serving = [m for m in candidates if m.role != "prefill"] or candidates
        best: tuple | None = None
        best_id: str | None = None
        best_local = False
        best_role = ""
        for m in serving:
            local = head is not None and head in m.heads and m.brownout < 2
            key = (
                0 if local else 1,
                m.brownout,
                0 if (model and model in m.models) else 1,
                0 if (not long_prompt or m.sp_degree > 1) else 1,
                m.load,  # depth per advertised slot: dp replicas count
                m.queue_depth,
                -m.kv_tier_depth,  # equal load: prefer the warmer KV tier
                # tenant-aware tie-break: among equally loaded workers,
                # steer away from the ones this SAME tenant already has
                # steered requests in flight on — its burst spreads across
                # the fleet instead of stacking behind itself
                (self._tenant_inflight.get((m.worker_id, tenant), 0)
                 if tenant else 0),
                m.worker_id,  # total order: deterministic under ties
            )
            if best is None or key < best:
                best, best_id, best_local, best_role = key, m.worker_id, local, m.role
        if best_id is not None and best_local:
            self.stats.locality_total += 1
        prefill_id: str | None = None
        if best_id is not None and best_role == "decode":
            pbest: tuple | None = None
            for m in candidates:
                if m.role != "prefill" or m.brownout >= 2:
                    continue
                pkey = (
                    m.brownout,
                    0 if (model and model in m.models) else 1,
                    0 if (not long_prompt or m.sp_degree > 1) else 1,
                    m.load,
                    m.queue_depth,
                    -m.kv_tier_depth,
                    m.worker_id,
                )
                if pbest is None or pkey < pbest:
                    pbest, prefill_id = pkey, m.worker_id
        if prefill_id is not None:
            self.stats.two_hop_total += 1
        return best_id, prefill_id

    # -- steered request-reply ----------------------------------------------

    async def _emit_span(self, span: dict) -> None:
        """Fire-and-forget publish of one steering span. Spans are
        diagnostics, never load-bearing: a dropped connection loses the
        span, not the request."""
        if not self.obs_spans:
            return
        try:
            await self.nc.publish(
                f"{self.prefix}.obs.spans",
                json.dumps({"spans": [span]}, separators=(",", ":")).encode(),
            )
        except (ConnectionError, ValueError):
            pass

    async def request_chat(
        self,
        payload: dict | bytes,
        timeout: float = 120.0,
        headers: dict[str, str] | None = None,
        retry: RetryPolicy | None = None,
        raise_on_exhausted: bool = False,
    ) -> Msg:
        """Steered chat request: like ``nc.request(chat_subject, ...)`` with
        a retry policy, but every attempt re-picks a worker from the live
        member table, excluded workers accumulate across hops (header AND
        pick filter), and a worker that times out is marked dead so
        unrelated requests stop steering at it too.

        With ``raise_on_exhausted`` a spent retry budget raises
        :class:`RouterExhausted` (carrying the final retryable envelope and a
        retry-after hint) instead of returning the raw retryable reply —
        HTTP front ends use this to render a structured 503."""
        retry = retry or RetryPolicy()
        if isinstance(payload, bytes):
            body = payload
            try:
                obj = json.loads(payload or b"{}")
            except ValueError:
                obj = {}
        else:
            obj = payload
            body = json.dumps(payload).encode()
        model = obj.get("model") if isinstance(obj, dict) else None
        messages = obj.get("messages") if isinstance(obj, dict) else None
        headers = dict(headers) if headers else {}
        headers.setdefault(p.TRACE_HEADER, new_trace_id())
        headers.setdefault(p.DEADLINE_HEADER, deadline_header_value(timeout))
        deadline_hdr = headers[p.DEADLINE_HEADER]
        trace_id = headers[p.TRACE_HEADER]
        # the caller's span (gateway root, typically) parents every attempt
        inbound = parse_span_context(headers.get(p.TRACEPARENT_HEADER))
        parent_span_id = inbound[1] if inbound else ""
        excluded = p.parse_worker_list(headers.get(p.EXCLUDED_WORKERS_HEADER))
        # gateway-stamped tenant identity: feeds the pick tie-breaker and
        # the per-(worker, tenant) in-flight tracking below
        tenant = headers.get(p.TENANT_HEADER) or None
        fallback = f"{self.prefix}.chat_model"
        last_exc: BaseException | None = None
        last_msg: Msg | None = None
        for attempt in range(1, retry.max_attempts + 1):
            remaining = deadline_remaining_s(deadline_hdr)
            attempt_timeout = timeout if remaining is None else min(timeout, remaining)
            if attempt_timeout <= 0:
                break
            headers[p.ATTEMPT_HEADER] = str(attempt)
            if excluded:
                headers[p.EXCLUDED_WORKERS_HEADER] = p.format_worker_list(excluded)
            wid, prefill_wid = self.pick_pair(
                model=model, messages=messages, excluded=excluded,
                tenant=tenant,
            )
            if prefill_wid is not None and prefill_wid != wid:
                # disaggregated two-hop: name the prefill-role worker the
                # decode target should pull KV blocks from. Re-stamped (or
                # dropped) per attempt — the prefill peer may die mid-retry.
                headers[p.KV_PREFILL_HEADER] = prefill_wid
            else:
                headers.pop(p.KV_PREFILL_HEADER, None)
            if wid is not None:
                subject = self.worker_subject(wid)
                self.stats.routed_total += 1
            elif self.queue_group_fallback:
                subject = fallback
                self.stats.fallback_total += 1
            else:
                raise ConnectionClosedError("no live cluster members")
            # each attempt is its own span; the worker parses this header and
            # parents its serve span under the attempt that reached it, so
            # retries and excluded-worker hops stay causally separate
            span_id = new_span_id()
            span_t0 = time.time()
            headers[p.TRACEPARENT_HEADER] = span_context_value(trace_id, span_id)
            attrs: dict = {"attempt": attempt,
                           "worker": wid or "queue-group", "outcome": "ok"}
            if headers.get(p.KV_PREFILL_HEADER):
                attrs["prefill_worker"] = headers[p.KV_PREFILL_HEADER]
            self._tenant_track(wid, tenant, +1)
            try:
                try:
                    msg = await self.nc.request(
                        subject, body, timeout=attempt_timeout, headers=headers
                    )
                except ConnectionClosedError as e:
                    attrs["outcome"] = "conn_error"
                    last_exc, last_msg = e, None
                except asyncio.TimeoutError as e:
                    attrs["outcome"] = "timeout"
                    if not retry.retry_on_timeout:
                        raise
                    last_exc, last_msg = e, None
                    if wid is not None:
                        # a directed request that never answered: the worker is
                        # likely dead (adverts will confirm); steer away now
                        self.mark_dead(wid)
                        if wid not in excluded:
                            excluded.append(wid)
                else:
                    if self._retryable(msg):
                        # a retryable reply on the FINAL attempt still lands in
                        # last_msg so the exhaustion site below decides whether
                        # to return it raw or raise RouterExhausted
                        attrs["outcome"] = "retryable"
                        last_exc, last_msg = None, msg
                        if attempt >= retry.max_attempts:
                            break
                        shed_by = NatsClient._reply_worker_id(msg) or wid
                        if shed_by and NatsClient._is_excluded_bounce(msg):
                            # one-shot exclusion consumed (see client.request)
                            if shed_by in excluded:
                                excluded.remove(shed_by)
                        elif shed_by and shed_by not in excluded:
                            excluded.append(shed_by)
                        if not excluded:
                            headers.pop(p.EXCLUDED_WORKERS_HEADER, None)
                        if not await NatsClient._backoff_within_budget(
                            retry.delay_s(attempt), deadline_hdr
                        ):
                            break
                        continue
                    return msg
            finally:
                self._tenant_track(wid, tenant, -1)
                await self._emit_span(Span(
                    trace_id=trace_id, span_id=span_id, stage="router.attempt",
                    worker_id=self.ident, parent_span_id=parent_span_id,
                    t0=span_t0, t1=time.time(), attrs=attrs,
                ).to_dict())
            if attempt >= retry.max_attempts:
                break
            if not await NatsClient._backoff_within_budget(
                retry.delay_s(attempt), deadline_hdr
            ):
                break
        if last_msg is not None:
            if raise_on_exhausted:
                raise RouterExhausted(
                    "retry budget exhausted: every worker shed this request",
                    envelope=self._envelope_of(last_msg),
                    worker_id=NatsClient._reply_worker_id(last_msg),
                    retry_after_s=retry.delay_s(1),
                )
            return last_msg
        if last_exc is not None:
            if raise_on_exhausted:
                raise RouterExhausted(
                    f"retry budget exhausted: {last_exc}",
                    retry_after_s=retry.delay_s(1),
                ) from last_exc
            raise last_exc
        raise RouterExhausted(
            "deadline budget exhausted before steered chat request",
            retry_after_s=retry.delay_s(1),
        )

    async def request_chat_stream(
        self,
        payload: dict | bytes,
        timeout: float = 120.0,
        idle_timeout: float = 30.0,
        headers: dict[str, str] | None = None,
        retry: RetryPolicy | None = None,
        raise_on_exhausted: bool = False,
    ):
        """Steered *streaming* chat request: per-attempt worker pick like
        :meth:`request_chat`, yielding every reply message (chunks, then the
        ``Nats-Stream-Done`` terminal) from the winning attempt.

        Retries happen only BEFORE the first chunk reaches the caller — a
        retryable terminal or a timeout with nothing yielded re-picks a
        worker; once a chunk is out, failure surfaces honestly (a retry
        would replay tokens the caller already consumed). Closing this
        generator early propagates the consumer-gone cancel down the
        transport so the serving worker frees its batcher slot."""
        retry = retry or RetryPolicy()
        if isinstance(payload, bytes):
            body = payload
            try:
                obj = json.loads(payload or b"{}")
            except ValueError:
                obj = {}
        else:
            obj = payload
            body = json.dumps(payload).encode()
        model = obj.get("model") if isinstance(obj, dict) else None
        messages = obj.get("messages") if isinstance(obj, dict) else None
        headers = dict(headers) if headers else {}
        headers.setdefault(p.TRACE_HEADER, new_trace_id())
        headers.setdefault(p.DEADLINE_HEADER, deadline_header_value(timeout))
        deadline_hdr = headers[p.DEADLINE_HEADER]
        trace_id = headers[p.TRACE_HEADER]
        inbound = parse_span_context(headers.get(p.TRACEPARENT_HEADER))
        parent_span_id = inbound[1] if inbound else ""
        excluded = p.parse_worker_list(headers.get(p.EXCLUDED_WORKERS_HEADER))
        tenant = headers.get(p.TENANT_HEADER) or None
        fallback = f"{self.prefix}.chat_model"
        last_exc: BaseException | None = None
        last_msg: Msg | None = None
        for attempt in range(1, retry.max_attempts + 1):
            remaining = deadline_remaining_s(deadline_hdr)
            attempt_timeout = timeout if remaining is None else min(timeout, remaining)
            if attempt_timeout <= 0:
                break
            headers[p.ATTEMPT_HEADER] = str(attempt)
            if excluded:
                headers[p.EXCLUDED_WORKERS_HEADER] = p.format_worker_list(excluded)
            wid, prefill_wid = self.pick_pair(
                model=model, messages=messages, excluded=excluded,
                tenant=tenant,
            )
            if prefill_wid is not None and prefill_wid != wid:
                headers[p.KV_PREFILL_HEADER] = prefill_wid
            else:
                headers.pop(p.KV_PREFILL_HEADER, None)
            if wid is not None:
                subject = self.worker_subject(wid)
                self.stats.routed_total += 1
            elif self.queue_group_fallback:
                subject = fallback
                self.stats.fallback_total += 1
            else:
                raise ConnectionClosedError("no live cluster members")
            span_id = new_span_id()
            span_t0 = time.time()
            headers[p.TRACEPARENT_HEADER] = span_context_value(trace_id, span_id)
            attrs: dict = {"attempt": attempt,
                           "worker": wid or "queue-group", "outcome": "ok"}
            if headers.get(p.KV_PREFILL_HEADER):
                attrs["prefill_worker"] = headers[p.KV_PREFILL_HEADER]
            yielded = False
            retry_msg: Msg | None = None
            stream = self.nc.request_stream(
                subject, body, timeout=attempt_timeout,
                idle_timeout=idle_timeout, headers=headers,
            )
            self._tenant_track(wid, tenant, +1)
            try:
                async for msg in stream:
                    terminal = bool(msg.headers and "Nats-Stream-Done" in msg.headers)
                    if not yielded and terminal and self._retryable(msg):
                        # held back even on the final attempt: the
                        # exhaustion site decides raw-yield vs raise
                        retry_msg = msg
                        break
                    yielded = True
                    yield msg
                    if terminal:
                        return
            except ConnectionClosedError as e:
                attrs["outcome"] = "conn_error"
                if yielded:
                    raise
                last_exc, last_msg = e, None
            except asyncio.TimeoutError as e:
                attrs["outcome"] = "timeout"
                if yielded or not retry.retry_on_timeout:
                    raise
                last_exc, last_msg = e, None
                if wid is not None:
                    self.mark_dead(wid)
                    if wid not in excluded:
                        excluded.append(wid)
            else:
                if retry_msg is None:
                    return  # stream ended cleanly (terminal already yielded)
                attrs["outcome"] = "retryable"
                last_exc, last_msg = None, retry_msg
                shed_by = NatsClient._reply_worker_id(retry_msg) or wid
                if shed_by and NatsClient._is_excluded_bounce(retry_msg):
                    if shed_by in excluded:
                        excluded.remove(shed_by)
                elif shed_by and shed_by not in excluded:
                    excluded.append(shed_by)
                if not excluded:
                    headers.pop(p.EXCLUDED_WORKERS_HEADER, None)
            finally:
                self._tenant_track(wid, tenant, -1)
                # broke out (or the caller closed us): close the transport
                # stream so its consumer-gone cancel reaches the worker
                await stream.aclose()
                await self._emit_span(Span(
                    trace_id=trace_id, span_id=span_id, stage="router.attempt",
                    worker_id=self.ident, parent_span_id=parent_span_id,
                    t0=span_t0, t1=time.time(), attrs=attrs,
                ).to_dict())
            if attempt >= retry.max_attempts:
                break
            if not await NatsClient._backoff_within_budget(
                retry.delay_s(attempt), deadline_hdr
            ):
                break
        if last_msg is not None:
            if raise_on_exhausted:
                raise RouterExhausted(
                    "retry budget exhausted: every worker shed this request",
                    envelope=self._envelope_of(last_msg),
                    worker_id=NatsClient._reply_worker_id(last_msg),
                    retry_after_s=retry.delay_s(1),
                )
            yield last_msg
            return
        if last_exc is not None:
            if raise_on_exhausted:
                raise RouterExhausted(
                    f"retry budget exhausted: {last_exc}",
                    retry_after_s=retry.delay_s(1),
                ) from last_exc
            raise last_exc
        raise RouterExhausted(
            "deadline budget exhausted before steered chat stream",
            retry_after_s=retry.delay_s(1),
        )

    @staticmethod
    def _envelope_of(msg: Msg) -> dict | None:
        try:
            env = json.loads(msg.payload or b"null")
        except ValueError:
            return None
        return env if isinstance(env, dict) else None

    @staticmethod
    def _retryable(msg: Msg) -> bool:
        try:
            env = json.loads(msg.payload or b"null")
        except ValueError:
            return False
        return is_retryable_envelope(env)


class RouterProcess:
    """Thin standalone router: forwards ``{prefix}.route.chat_model``
    requests to the steered worker and relays the reply verbatim. Runs in a
    queue group so N router replicas split the forwarding load. Clients that
    can import this package should prefer the in-process ClusterRouter (one
    fewer hop); this process exists for everyone else."""

    def __init__(
        self,
        nc: NatsClient,
        *,
        prefix: str = "lmstudio",
        stale_after_s: float = 5.0,
        prefix_head_chars: int = DEFAULT_HEAD_CHARS,
        chat_timeout_s: float = 120.0,
        retry: RetryPolicy | None = None,
    ):
        self.nc = nc
        self.prefix = prefix
        self.chat_timeout_s = chat_timeout_s
        self.retry = retry or RetryPolicy(max_attempts=3, retry_on_timeout=True)
        self.router = ClusterRouter(
            nc,
            prefix=prefix,
            stale_after_s=stale_after_s,
            prefix_head_chars=prefix_head_chars,
        )
        self._sub = None
        self._inflight: set[asyncio.Task] = set()

    async def start(self) -> "RouterProcess":
        await self.router.start()
        self._sub = await self.nc.subscribe(
            f"{self.prefix}.{ROUTE_SUBJECT}",
            queue="lmstudio-routers",
            cb=self._on_chat,
        )
        log.info(
            "router process forwarding %s.%s -> %s.worker.<id>.chat_model",
            self.prefix, ROUTE_SUBJECT, self.prefix,
        )
        return self

    async def stop(self) -> None:
        if self._sub is not None:
            await self._sub.unsubscribe()
            self._sub = None
        await self.router.stop()
        for t in list(self._inflight):
            t.cancel()

    async def _on_chat(self, msg: Msg) -> None:
        if not msg.reply:
            return
        task = asyncio.ensure_future(self._forward(msg))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _forward(self, msg: Msg) -> None:
        headers = dict(msg.headers or {})
        remaining = deadline_remaining_s(headers.get(p.DEADLINE_HEADER))
        timeout = self.chat_timeout_s if remaining is None else remaining
        if timeout <= 0:
            return  # the caller already gave up; a reply would be unread
        try:
            resp = await self.router.request_chat(
                msg.payload, timeout=timeout, headers=headers, retry=self.retry
            )
        except (ConnectionClosedError, asyncio.TimeoutError) as e:
            from ..transport.envelope import envelope_error

            await msg.respond(envelope_error(
                f"router: no worker answered, retry on another worker ({e})"
            ))
            return
        await msg.respond(resp.payload, headers=resp.headers)
