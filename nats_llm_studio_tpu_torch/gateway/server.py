"""OpenAI-compatible HTTP/SSE front door over the NATS serving bus.

``python -m nats_llm_studio_tpu_torch gateway`` binds a plain asyncio HTTP/1.1
server (no web framework — the container ships none) and translates:

    POST /v1/chat/completions   -> ClusterRouter.request_chat[_stream]
    GET  /v1/models             -> {prefix}.list_models
    GET  /healthz               -> gateway + cluster-membership liveness
    GET  /metrics               -> Prometheus exposition (HTTP-edge view)

so any unmodified OpenAI client (``openai`` SDK, curl, LangChain) can talk
to a worker cluster without importing this package. Streaming responses are
Server-Sent Events framed exactly like api.openai.com: one ``data: {chunk}``
per delta, a final chunk carrying ``finish_reason``, then ``data: [DONE]``,
with ``Connection: close`` delimiting the body.

The gateway stays honest about the bus underneath it:

* every request rides the steered router, so excluded-worker retry hops and
  prefix-cache locality work exactly as for native NATS clients;
* the caller's ``X-Deadline-Ms``/``X-Trace-Id`` headers pass through (and
  are minted when absent), so budgets and traces span the HTTP hop;
* a spent retry budget surfaces as a structured ``503`` with ``Retry-After``
  (:class:`~..serve.router.RouterExhausted`), never a bare string;
* a client that disconnects mid-stream tears the whole chain down: the SSE
  writer aborts, the router stream closes, the transport publishes the
  consumer-gone cancel, and the worker frees its batcher slot.

``response_format`` is validated structurally HERE, before any bus traffic:
a garbled value costs one JSON parse, not a worker round-trip.

Copy of ``nats_llm_studio_tpu/gateway/server.py`` with its imports pointed
at the port's ``obs``, ``serve.constrain``, ``serve.qos``, ``serve.router``
and ``transport``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Any

from ..obs import (
    LogHistogram,
    PromRenderer,
    Span,
    new_span_id,
    new_trace_id,
    span_context_value,
)
from ..serve.constrain import validate_response_format
from ..serve.qos import (
    ANON_TENANT,
    ApiKeySpec,
    TenantUsage,
    TokenBucket,
    cap_tenant_rows,
    format_priority_header,
    parse_api_keys,
)
from ..serve.router import ClusterRouter, RouterExhausted
from ..transport import ConnectionClosedError, NatsClient, RetryPolicy
from ..transport import protocol as p
from ..transport.envelope import error_is_retryable, shed_cause_of

log = logging.getLogger(__name__)

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 10 * 1024 * 1024

_REASONS = {
    200: "OK",
    400: "Bad Request",
    401: "Unauthorized",
    404: "Not Found",
    405: "Method Not Allowed",
    408: "Request Timeout",
    411: "Length Required",
    413: "Payload Too Large",
    429: "Too Many Requests",
    500: "Internal Server Error",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}

# OpenAI chat params the gateway forwards to the engine; everything else in
# the request body is ignored (SDKs send fields this backend has no use
# for — dropping them beats failing them)
_FORWARDED_FIELDS = (
    "model",
    "messages",
    "max_tokens",
    "temperature",
    "top_p",
    "top_k",
    "seed",
    "stop",
    "n",
    "logprobs",
    "top_logprobs",
    "response_format",
)


class BadRequest(ValueError):
    """Client-side payload error: rendered as HTTP 400 before any bus hop."""


def translate_chat_payload(body: Any) -> tuple[dict, bool]:
    """OpenAI ``/v1/chat/completions`` body -> (chat envelope, stream?).

    Structural validation only — semantic limits (n vs slot count, schema
    compilability against the tokenizer) belong to the serving worker.
    Unknown fields are dropped; a missing ``max_tokens`` defers to the
    engine default. Raises :class:`BadRequest` with a client-facing message.
    """
    if not isinstance(body, dict):
        raise BadRequest("request body must be a JSON object")
    model = body.get("model")
    if not isinstance(model, str) or not model:
        raise BadRequest("'model' must be a non-empty string")
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise BadRequest("'messages' must be a non-empty array")
    for i, m in enumerate(messages):
        if not isinstance(m, dict) or not isinstance(m.get("role"), str):
            raise BadRequest(f"messages[{i}] must be an object with a 'role'")
    # a garbled response_format must never reach the batcher: validate the
    # structure here (the worker re-validates and also compiles the schema)
    try:
        validate_response_format(body.get("response_format"))
    except ValueError as e:
        raise BadRequest(str(e)) from e
    for name in ("max_tokens", "max_completion_tokens", "n", "top_logprobs"):
        v = body.get(name)
        if v is not None and (isinstance(v, bool) or not isinstance(v, int)):
            raise BadRequest(f"'{name}' must be an integer")
    for name in ("temperature", "top_p"):
        v = body.get(name)
        if v is not None and (
            isinstance(v, bool) or not isinstance(v, (int, float))
        ):
            raise BadRequest(f"'{name}' must be a number")
    payload = {k: body[k] for k in _FORWARDED_FIELDS if body.get(k) is not None}
    if "max_tokens" not in payload and body.get("max_completion_tokens") is not None:
        payload["max_tokens"] = body["max_completion_tokens"]
    stream = bool(body.get("stream"))
    return payload, stream


def _error_body(message: str, etype: str, code: str | None = None) -> dict:
    return {
        "error": {
            "message": message,
            "type": etype,
            "param": None,
            "code": code,
        }
    }


def _status_for_error(err: str) -> tuple[int, str, str | None]:
    """Map a worker error-envelope string to (status, type, code)."""
    low = err.lower()
    if "model not found" in low:
        return 404, "invalid_request_error", "model_not_found"
    if "invalid " in low:
        return 400, "invalid_request_error", None
    if "deadline exceeded" in low:
        return 504, "timeout_error", "deadline_exceeded"
    # cause-aware sheds (transport/envelope.py SHED_CAUSES): quota and
    # fair_share are the CALLER's budget — 429, because retrying the same
    # request elsewhere cannot help; the remaining causes are worker-local
    # pressure and fall through to the generic retryable 503 below
    cause = shed_cause_of(err)
    if cause in ("quota", "fair_share"):
        return 429, "rate_limit_error", cause
    if error_is_retryable(err):
        return 503, "overloaded_error", "worker_unavailable"
    return 500, "api_error", None


def _envelope_error_response(err: str) -> tuple[int, dict, dict | None]:
    """(status, OpenAI error body, extra headers) for a worker error
    envelope — the body carries the machine-readable shed cause when the
    error text embeds one, so clients can branch on quota-vs-pressure
    without parsing prose."""
    status, etype, code = _status_for_error(err)
    body = _error_body(err, etype, code)
    cause = shed_cause_of(err)
    if cause:
        body["error"]["cause"] = cause
    extra = {"Retry-After": "1"} if status in (429, 503) else None
    return status, body, extra


class Gateway:
    """One HTTP front door. Owns (or borrows) a :class:`ClusterRouter`.

    ``port=0`` binds an ephemeral port (tests); the bound port is available
    as ``self.port`` after :meth:`start`.
    """

    def __init__(
        self,
        nc: NatsClient,
        *,
        prefix: str = "lmstudio",
        host: str = "127.0.0.1",
        port: int = 8080,
        max_conn: int = 256,
        chat_timeout_s: float = 120.0,
        retry: RetryPolicy | None = None,
        router: ClusterRouter | None = None,
        stale_after_s: float = 5.0,
        prefix_head_chars: int = 256,
        obs_spans: bool | None = None,
        ident: str = "gateway",
        api_keys: str = "",
        tenant_topk: int = 8,
    ):
        self.nc = nc
        self.prefix = prefix
        self.host = host
        self.port = port
        self.chat_timeout_s = chat_timeout_s
        self.retry = retry or RetryPolicy(max_attempts=3, retry_on_timeout=True)
        self._own_router = router is None
        self.router = router or ClusterRouter(
            nc,
            prefix=prefix,
            stale_after_s=stale_after_s,
            prefix_head_chars=prefix_head_chars,
        )
        if obs_spans is None:
            obs_spans = os.environ.get(
                "OBS_SPANS", "1"
            ).strip().lower() not in ("0", "false", "off")
        self.obs_spans = obs_spans
        self.ident = ident  # worker_id stamped on this gateway's spans
        # cluster advert cadence (0 disables): the aggregator scrapes every
        # advert member's directed metrics.prom subject, so advertising is
        # what folds lmstudio_gateway_* into the cluster exposition. The
        # role marks the advert metrics-only — the router must never route
        # a chat at the gateway (serve/router.py filters role "gateway").
        self.advert_interval_s = float(
            os.environ.get("GATEWAY_ADVERT_INTERVAL_S", "1.0") or 0
        )
        self._advert_seq = 0
        self._advert_task: asyncio.Task | None = None
        self._metrics_sub = None
        self._sem = asyncio.Semaphore(max(1, max_conn))
        self._server: asyncio.base_events.Server | None = None
        self.requests_total = 0
        self.streams_total = 0
        self.client_disconnects = 0
        self.retry_hops_total = 0  # extra attempts behind served replies
        self.sse_open = 0  # SSE streams currently being written
        self._responses_by_status: dict[int, int] = {}
        # TTFT as the HTTP client experiences it: request-line read to
        # first response byte (full reply for non-streaming, SSE preamble
        # for streams) — the edge-side counterpart of the workers'
        # lmstudio_ttft_ms, including routing, retries, and queueing
        self._ttft_ms = LogHistogram()
        # multi-tenant QoS front door (serve/qos.py): the API_KEYS table
        # maps bearer keys to (tenant, priority class, weight, rate,
        # monthly quota). Empty = auth off, everyone is the anonymous
        # standard tenant — exactly the pre-QoS behavior. parse_api_keys
        # raises on a malformed spec: fail at boot, not at first request.
        self.api_keys = parse_api_keys(api_keys)
        self.tenant_topk = int(tenant_topk)
        self._buckets: dict[str, TokenBucket] = {
            k: TokenBucket(s.rps) for k, s in self.api_keys.items() if s.rps > 0
        }
        self._usage = TenantUsage()
        self._tenant_requests: dict[str, int] = {}
        # 401/429 refusals by tenant ("unknown" for bad/missing keys)
        self._tenant_rejected: dict[str, int] = {}

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "Gateway":
        if self._own_router:
            await self.router.start()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        # directed scrape surface (same shape as the workers'): the fleet
        # aggregator requests {prefix}.worker.<id>.metrics.prom for every
        # advert member, so this sub + the advert loop below are all it
        # takes for the HTTP-edge families to join the cluster exposition
        self._metrics_sub = await self.nc.subscribe(
            f"{self.prefix}.worker.{self.ident}.metrics.prom",
            cb=self._on_metrics_prom,
        )
        if self.advert_interval_s > 0:
            self._advert_task = asyncio.ensure_future(self._advert_loop())
        log.info("gateway on http://%s:%d -> %s.*", self.host, self.port, self.prefix)
        return self

    async def stop(self) -> None:
        if self._advert_task is not None:
            self._advert_task.cancel()
            self._advert_task = None
        if self._metrics_sub is not None:
            try:
                await self._metrics_sub.unsubscribe()
            except (ConnectionError, ValueError):
                pass
            self._metrics_sub = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._own_router:
            await self.router.stop()

    async def _on_metrics_prom(self, msg) -> None:
        """Directed metrics.prom — raw Prometheus text, exactly like the
        workers' subject (scrapers want the body, not a JSON envelope)."""
        if msg.reply:
            try:
                await self.nc.publish(msg.reply, self.render_prometheus().encode())
            except (ConnectionError, ValueError):
                pass

    def build_advert(self) -> dict:
        """Minimal membership advert: identity + role "gateway". Serves no
        chat (the router filters the role out of its candidates); exists so
        the aggregator discovers and scrapes this process like a worker."""
        return {
            "worker_id": self.ident,
            "role": "gateway",
            "queue_depth": 0,
            "brownout": 0,
            "hbm_headroom": 1.0,
            "models": [],
            "draining": False,
            "heads": [],
            "seq": self._advert_seq,
        }

    async def _advert_loop(self) -> None:
        try:
            while True:
                self._advert_seq += 1
                try:
                    await self.nc.publish(
                        f"{self.prefix}.cluster.adverts",
                        json.dumps(self.build_advert(),
                                   separators=(",", ":")).encode(),
                    )
                except (ConnectionError, ValueError):
                    pass  # reconnect in flight; the next tick re-advertises
                await asyncio.sleep(self.advert_interval_s)
        except asyncio.CancelledError:
            return

    # -- HTTP plumbing -------------------------------------------------------

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            if self._sem.locked():
                await self._respond(
                    writer, 503,
                    _error_body("gateway connection limit reached",
                                "overloaded_error", "gateway_overloaded"),
                    extra={"Retry-After": "1"},
                )
                return
            async with self._sem:
                await self._handle_one(reader, writer)
        except (ConnectionResetError, BrokenPipeError):
            self.client_disconnects += 1
        except Exception:  # noqa: BLE001 — one bad conn must not kill the server
            log.exception("gateway: connection handler failed")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass

    async def _handle_one(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self.requests_total += 1
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return  # client went away before sending a request
        except asyncio.LimitOverrunError:
            await self._respond(
                writer, 413, _error_body("headers too large", "invalid_request_error")
            )
            return
        if len(head) > MAX_HEADER_BYTES:
            await self._respond(
                writer, 413, _error_body("headers too large", "invalid_request_error")
            )
            return
        try:
            request_line, headers = _parse_head(head)
            method, target = request_line
        except ValueError:
            await self._respond(
                writer, 400, _error_body("malformed HTTP request", "invalid_request_error")
            )
            return
        path = target.split("?", 1)[0]

        if method == "GET" and path == "/healthz":
            await self._respond(writer, 200, {
                "status": "ok",
                "cluster_members": len(self.router.members()),
                "requests_total": self.requests_total,
            })
            return
        if method == "GET" and path == "/metrics":
            await self._respond_text(writer, 200, self.render_prometheus())
            return
        if method == "GET" and path == "/v1/models":
            # key validity is enforced (the model list is tenant surface),
            # but listing consumes no rate-bucket tokens or quota
            _, auth_err = self._resolve_key(headers)
            if auth_err is not None:
                await self._respond(writer, auth_err[0], auth_err[1])
                return
            await self._get_models(writer)
            return
        if path == "/v1/chat/completions":
            if method != "POST":
                await self._respond(
                    writer, 405,
                    _error_body("use POST", "invalid_request_error"),
                    extra={"Allow": "POST"},
                )
                return
            spec, auth_err = self._resolve_key(headers)
            if auth_err is not None:
                await self._respond(writer, auth_err[0], auth_err[1])
                return
            admit_err = self._admit(spec)
            if admit_err is not None:
                await self._respond(
                    writer, admit_err[0], admit_err[1], extra=admit_err[2]
                )
                return
            body = await self._read_body(reader, writer, headers)
            if body is None:
                return
            await self._chat(reader, writer, headers, body, spec)
            return
        await self._respond(
            writer, 404,
            _error_body(f"no route for {method} {path}", "invalid_request_error"),
        )

    async def _read_body(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        headers: dict[str, str],
    ) -> bytes | None:
        """POST body via Content-Length (chunked uploads are refused — no
        client this gateway targets sends them for JSON)."""
        if "chunked" in headers.get("transfer-encoding", "").lower():
            await self._respond(
                writer, 411,
                _error_body("chunked request bodies are not supported; "
                            "send Content-Length", "invalid_request_error"),
            )
            return None
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            length = -1
        if length < 0:
            await self._respond(
                writer, 400, _error_body("bad Content-Length", "invalid_request_error")
            )
            return None
        if length > MAX_BODY_BYTES:
            await self._respond(
                writer, 413, _error_body("request body too large", "invalid_request_error")
            )
            return None
        try:
            return await reader.readexactly(length)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return None

    async def _respond(
        self,
        writer: asyncio.StreamWriter,
        status: int,
        body: dict,
        extra: dict[str, str] | None = None,
    ) -> int:
        raw = json.dumps(body, separators=(",", ":")).encode()
        await self._write_response(
            writer, status, "application/json", raw, extra
        )
        return status

    async def _respond_text(
        self, writer: asyncio.StreamWriter, status: int, text: str
    ) -> int:
        await self._write_response(
            writer, status, "text/plain; version=0.0.4; charset=utf-8",
            text.encode(),
        )
        return status

    async def _write_response(
        self,
        writer: asyncio.StreamWriter,
        status: int,
        content_type: str,
        raw: bytes,
        extra: dict[str, str] | None = None,
    ) -> None:
        self._responses_by_status[status] = (
            self._responses_by_status.get(status, 0) + 1
        )
        lines = [
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(raw)}",
            "Connection: close",
        ]
        for k, v in (extra or {}).items():
            lines.append(f"{k}: {v}")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode() + raw)
        await writer.drain()

    def render_prometheus(self) -> str:
        """HTTP-edge metrics: statuses, streams, retry hops behind served
        replies, and TTFT as the *client* saw it (routing + retries
        included) — the complement of the workers' engine-side families."""
        r = PromRenderer(default_labels={"gateway": self.ident})
        r.counter("lmstudio_gateway_requests_total", self.requests_total,
                  help="HTTP requests accepted (any route)")
        for status in sorted(self._responses_by_status):
            r.counter("lmstudio_gateway_responses_total",
                      self._responses_by_status[status],
                      labels={"status": str(status)},
                      help="HTTP responses by status code")
        r.counter("lmstudio_gateway_streams_total", self.streams_total,
                  help="SSE chat streams started")
        r.gauge("lmstudio_gateway_sse_open", self.sse_open,
                help="SSE streams currently being written")
        r.counter("lmstudio_gateway_client_disconnects_total",
                  self.client_disconnects,
                  help="clients gone before their response completed")
        r.counter("lmstudio_gateway_retry_hops_total", self.retry_hops_total,
                  help="extra routed attempts behind served chat replies")
        r.histogram("lmstudio_gateway_ttft_ms", self._ttft_ms.snapshot(),
                    help="request-line read to first response byte, ms")
        # per-tenant edge families under the same top-K + "other" cardinality
        # cap as the workers' lmstudio_tenant_* families (serve/qos.py)
        for tenant, v in sorted(cap_tenant_rows(
            self._tenant_requests, self.tenant_topk
        ).items()):
            r.counter("lmstudio_gateway_tenant_requests_total", v,
                      labels={"tenant": tenant},
                      help="chat requests accepted past auth, by tenant")
        for tenant, v in sorted(cap_tenant_rows(
            self._tenant_rejected, self.tenant_topk
        ).items()):
            r.counter("lmstudio_gateway_tenant_rejected_total", v,
                      labels={"tenant": tenant},
                      help="401/429 refusals (bad key, rate limit, monthly "
                           "quota), by tenant; 'unknown' = unauthenticated")
        usage_rows = {
            t: row["tokens"] for t, row in self._usage.snapshot().items()
        }
        for tenant, v in sorted(cap_tenant_rows(
            usage_rows, self.tenant_topk
        ).items()):
            r.counter("lmstudio_gateway_tenant_tokens_total", v,
                      labels={"tenant": tenant},
                      help="completion tokens charged this month, by tenant")
        return r.render()

    # -- multi-tenant QoS front door -----------------------------------------

    def _resolve_key(
        self, http_headers: dict[str, str]
    ) -> tuple[ApiKeySpec | None, tuple[int, dict] | None]:
        """Authenticate the request: (key spec, None) on success, (None,
        (status, body)) on refusal. With no API_KEYS configured every
        caller passes as the anonymous standard tenant (spec None)."""
        if not self.api_keys:
            return None, None
        auth = http_headers.get("authorization", "")
        scheme, _, key = auth.partition(" ")
        key = key.strip()
        if not auth or scheme.lower() != "bearer" or not key:
            self._tenant_rejected["unknown"] = (
                self._tenant_rejected.get("unknown", 0) + 1
            )
            return None, (401, _error_body(
                "missing API key: pass 'Authorization: Bearer <key>'",
                "authentication_error", "invalid_api_key",
            ))
        spec = self.api_keys.get(key)
        if spec is None:
            self._tenant_rejected["unknown"] = (
                self._tenant_rejected.get("unknown", 0) + 1
            )
            return None, (401, _error_body(
                "invalid API key", "authentication_error", "invalid_api_key",
            ))
        return spec, None

    def _admit(
        self, spec: ApiKeySpec | None
    ) -> tuple[int, dict, dict[str, str]] | None:
        """Rate-limit + monthly-quota gate for an authenticated chat:
        None = admitted, else (status, body, extra headers) for the 429."""
        if spec is None:
            return None
        bucket = self._buckets.get(spec.key)
        if bucket is not None and not bucket.take():
            self._tenant_rejected[spec.tenant] = (
                self._tenant_rejected.get(spec.tenant, 0) + 1
            )
            retry_after = max(1, int(bucket.retry_after_s() + 0.999))
            body = _error_body(
                f"rate limit exceeded for tenant {spec.tenant}: "
                f"{spec.rps:g} requests/s (shed_cause=quota)",
                "rate_limit_error", "rate_limit_exceeded",
            )
            body["error"]["cause"] = "quota"
            return 429, body, {"Retry-After": str(retry_after)}
        if spec.monthly_tokens > 0 and self._usage.over_quota(
            spec.tenant, spec.monthly_tokens
        ):
            self._tenant_rejected[spec.tenant] = (
                self._tenant_rejected.get(spec.tenant, 0) + 1
            )
            body = _error_body(
                f"monthly token quota exhausted for tenant {spec.tenant}: "
                f"{self._usage.tokens_used(spec.tenant)} of "
                f"{spec.monthly_tokens} tokens used (shed_cause=quota)",
                "rate_limit_error", "insufficient_quota",
            )
            body["error"]["cause"] = "quota"
            # a monthly quota resets at the month boundary, not in seconds;
            # 3600 keeps well-behaved clients from hammering the refusal
            return 429, body, {"Retry-After": "3600"}
        return None

    def _charge_usage(self, spec: ApiKeySpec | None, response: dict) -> None:
        """Book a served chat's completion tokens against the tenant's
        month (anonymous traffic is tracked too — it shows in /metrics)."""
        usage = response.get("usage") or {}
        tokens = usage.get("completion_tokens") or 0
        tenant = spec.tenant if spec is not None else ANON_TENANT
        try:
            self._usage.charge(tenant, int(tokens))
        except (TypeError, ValueError):
            self._usage.charge(tenant, 0)

    # -- routes --------------------------------------------------------------

    async def _get_models(self, writer: asyncio.StreamWriter) -> None:
        try:
            msg = await self.nc.request(
                f"{self.prefix}.list_models", b"{}", timeout=30.0
            )
            env = json.loads(msg.payload or b"{}")
        except (asyncio.TimeoutError, ConnectionClosedError, ValueError) as e:
            await self._respond(
                writer, 503,
                _error_body(f"no worker answered list_models: {e}",
                            "overloaded_error", "worker_unavailable"),
                extra={"Retry-After": "1"},
            )
            return
        if not env.get("ok"):
            status, etype, code = _status_for_error(str(env.get("error", "")))
            await self._respond(
                writer, status, _error_body(str(env.get("error")), etype, code)
            )
            return
        listing = (env.get("data") or {}).get("models") or {"object": "list", "data": []}
        await self._respond(writer, 200, listing)

    def _bus_headers(
        self, http_headers: dict[str, str], spec: ApiKeySpec | None = None
    ) -> dict[str, str]:
        """NATS headers for this HTTP request: trace id and deadline budget
        pass through from the client when stamped, minted otherwise. An
        authenticated key stamps the resolved tenant + priority class (with
        its fair-share weight override) — NEVER the client's own claim, so
        an HTTP caller cannot spoof premium through the gateway."""
        out = {p.TRACE_HEADER: http_headers.get(
            p.TRACE_HEADER.lower(), new_trace_id()
        )}
        deadline = http_headers.get(p.DEADLINE_HEADER.lower())
        if deadline:
            out[p.DEADLINE_HEADER] = deadline
        if spec is not None:
            out[p.TENANT_HEADER] = spec.tenant
            out[p.PRIORITY_HEADER] = format_priority_header(
                spec.priority, spec.weight
            )
        return out

    async def _chat(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        http_headers: dict[str, str],
        raw_body: bytes,
        spec: ApiKeySpec | None = None,
    ) -> None:
        try:
            body = json.loads(raw_body or b"null")
        except ValueError:
            await self._respond(
                writer, 400, _error_body("request body is not valid JSON",
                                         "invalid_request_error")
            )
            return
        try:
            payload, stream = translate_chat_payload(body)
        except BadRequest as e:
            await self._respond(
                writer, 400, _error_body(str(e), "invalid_request_error")
            )
            return
        tenant = spec.tenant if spec is not None else ANON_TENANT
        self._tenant_requests[tenant] = self._tenant_requests.get(tenant, 0) + 1
        payload["stream"] = stream
        bus_headers = self._bus_headers(http_headers, spec)
        # the gateway span is the root of the cross-process trace: its id
        # rides the Traceparent header so every router attempt (and, through
        # it, every worker hop) parents under this request
        trace_id = bus_headers[p.TRACE_HEADER]
        root_span_id = new_span_id()
        bus_headers[p.TRACEPARENT_HEADER] = span_context_value(
            trace_id, root_span_id
        )
        span_t0 = time.time()
        t0 = time.monotonic()
        status = 0  # 0 = client gone before any response byte
        try:
            if stream:
                status = await self._chat_stream(
                    reader, writer, payload, bus_headers, t0, spec
                )
            else:
                status = await self._chat_once(
                    writer, payload, bus_headers, t0, spec
                )
        finally:
            self._emit_span(Span(
                trace_id=trace_id, span_id=root_span_id,
                stage="gateway.request", worker_id=self.ident,
                t0=span_t0, t1=time.time(),
                attrs={"model": payload.get("model", ""),
                       "stream": stream, "status": status},
            ).to_dict())

    def _emit_span(self, span: dict) -> None:
        """Fire-and-forget publish of the gateway root span; never fatal
        (and never blocking the HTTP response path)."""
        if not self.obs_spans:
            return

        async def _pub() -> None:
            try:
                await self.nc.publish(
                    f"{self.prefix}.obs.spans",
                    json.dumps({"spans": [span]}, separators=(",", ":")).encode(),
                )
            except (ConnectionError, ValueError):
                pass

        asyncio.ensure_future(_pub())

    def _count_retry_hops(self, response: dict) -> None:
        """Served replies report the winning attempt number in their trace
        stats; anything past the first attempt was a retry hop."""
        trace = (response.get("stats") or {}).get("trace") or {}
        attempt = trace.get("attempt")
        if isinstance(attempt, int) and attempt > 1:
            self.retry_hops_total += attempt - 1

    async def _chat_once(
        self,
        writer: asyncio.StreamWriter,
        payload: dict,
        bus_headers: dict[str, str],
        t0: float,
        spec: ApiKeySpec | None = None,
    ) -> int:
        try:
            msg = await self.router.request_chat(
                payload,
                timeout=self.chat_timeout_s,
                headers=bus_headers,
                retry=self.retry,
                raise_on_exhausted=True,
            )
            env = json.loads(msg.payload or b"{}")
        except RouterExhausted as e:
            return await self._respond_exhausted(writer, e)
        except (asyncio.TimeoutError, ConnectionClosedError) as e:
            return await self._respond(
                writer, 503,
                _error_body(f"no worker answered: {e}", "overloaded_error",
                            "worker_unavailable"),
                extra={"Retry-After": "1"},
            )
        except ValueError:
            return await self._respond(
                writer, 500, _error_body("worker reply was not JSON", "api_error")
            )
        if not env.get("ok"):
            status, body, extra = _envelope_error_response(
                str(env.get("error", ""))
            )
            return await self._respond(writer, status, body, extra=extra)
        response = (env.get("data") or {}).get("response") or {}
        response.setdefault("id", f"chatcmpl-{bus_headers[p.TRACE_HEADER]}")
        response.setdefault("created", int(time.time()))
        self._count_retry_hops(response)
        self._charge_usage(spec, response)
        self._ttft_ms.record((time.monotonic() - t0) * 1000.0)
        return await self._respond(writer, 200, response)

    async def _respond_exhausted(
        self, writer: asyncio.StreamWriter, e: RouterExhausted
    ) -> int:
        retry_after = max(1, int(e.retry_after_s + 0.999))
        body = _error_body(e.detail(), "overloaded_error", "worker_unavailable")
        body["error"]["retry_after_s"] = retry_after
        if e.worker_id:
            body["error"]["last_worker"] = e.worker_id
        return await self._respond(
            writer, 503, body, extra={"Retry-After": str(retry_after)}
        )

    # -- SSE streaming -------------------------------------------------------

    async def _chat_stream(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        payload: dict,
        bus_headers: dict[str, str],
        t0: float,
        spec: ApiKeySpec | None = None,
    ) -> int:
        self.streams_total += 1
        chat_id = f"chatcmpl-{bus_headers[p.TRACE_HEADER]}"
        created = int(time.time())
        agen = self.router.request_chat_stream(
            payload,
            timeout=self.chat_timeout_s,
            headers=bus_headers,
            retry=self.retry,
            raise_on_exhausted=True,
        )
        # any bytes (or EOF) from the client after the request mean it is
        # gone — SSE clients never write. Racing the watcher against each
        # bus message makes a mid-stream disconnect cancel the slot within
        # one chunk instead of at socket-buffer pressure.
        eof_task = asyncio.ensure_future(reader.read(1))
        preamble_sent = False
        disconnected = False
        try:
            while True:
                step = asyncio.ensure_future(agen.__anext__())
                await asyncio.wait({step, eof_task}, return_when=asyncio.FIRST_COMPLETED)
                if eof_task.done() and not step.done():
                    step.cancel()
                    try:
                        await step
                    except BaseException:  # noqa: BLE001 — cancelled anext
                        pass
                    disconnected = True
                    break
                try:
                    msg = await step
                except StopAsyncIteration:
                    break
                except RouterExhausted as e:
                    if not preamble_sent:
                        return await self._respond_exhausted(writer, e)
                    raise
                except (asyncio.TimeoutError, ConnectionClosedError) as e:
                    if not preamble_sent:
                        return await self._respond(
                            writer, 503,
                            _error_body(f"no worker answered: {e}",
                                        "overloaded_error", "worker_unavailable"),
                            extra={"Retry-After": "1"},
                        )
                    raise
                terminal = bool(msg.headers and "Nats-Stream-Done" in msg.headers)
                try:
                    env = json.loads(msg.payload or b"{}")
                except ValueError:
                    env = {}
                if terminal:
                    if not env.get("ok"):
                        err = str(env.get("error", "stream failed"))
                        if not preamble_sent:
                            status, body, extra = _envelope_error_response(err)
                            return await self._respond(
                                writer, status, body, extra=extra,
                            )
                        # headers are gone: surface the error in-band, the
                        # way api.openai.com does mid-stream (the cause
                        # token, if any, rides inside the message text)
                        await self._sse(writer, {"error": _error_body(
                            err, *_status_for_error(err)[1:])["error"]})
                        break
                    response = (env.get("data") or {}).get("response") or {}
                    self._count_retry_hops(response)
                    self._charge_usage(spec, response)
                    if not preamble_sent:
                        await self._sse_start(writer, t0)
                        preamble_sent = True
                    for choice in response.get("choices") or [{}]:
                        fin = {
                            "id": chat_id,
                            "object": "chat.completion.chunk",
                            "created": created,
                            "model": payload.get("model", ""),
                            "choices": [{
                                "index": choice.get("index", 0),
                                "delta": {},
                                "finish_reason": choice.get("finish_reason", "stop"),
                            }],
                        }
                        if response.get("usage"):
                            fin["usage"] = response["usage"]
                        await self._sse(writer, fin)
                    break
                chunk = (env.get("data") or {}).get("chunk")
                if not isinstance(chunk, dict):
                    continue
                chunk.setdefault("id", chat_id)
                chunk.setdefault("created", created)
                if not preamble_sent:
                    await self._sse_start(writer, t0)
                    preamble_sent = True
                await self._sse(writer, chunk)
            if preamble_sent and not disconnected:
                writer.write(b"data: [DONE]\n\n")
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            disconnected = True
        finally:
            eof_task.cancel()
            try:
                await eof_task
            except BaseException:  # noqa: BLE001
                pass
            # closing the router stream propagates consumer-gone down the
            # transport: the worker sees <inbox>.cancel and frees the slot
            await agen.aclose()
            if preamble_sent:
                self.sse_open -= 1
            if disconnected:
                self.client_disconnects += 1
        if disconnected and not preamble_sent:
            return 499  # client closed before any response byte (nginx idiom)
        return 200 if preamble_sent else 0

    async def _sse_start(self, writer: asyncio.StreamWriter, t0: float) -> None:
        """First SSE byte: the stream is now a committed 200 — count it,
        open the gauge, and record client-perceived TTFT."""
        await self._sse_preamble(writer)
        self._responses_by_status[200] = self._responses_by_status.get(200, 0) + 1
        self.sse_open += 1
        self._ttft_ms.record((time.monotonic() - t0) * 1000.0)

    @staticmethod
    async def _sse_preamble(writer: asyncio.StreamWriter) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n"
            b"\r\n"
        )
        await writer.drain()

    @staticmethod
    async def _sse(writer: asyncio.StreamWriter, obj: dict) -> None:
        writer.write(b"data: " + json.dumps(obj, separators=(",", ":")).encode() + b"\n\n")
        await writer.drain()


def _parse_head(head: bytes) -> tuple[tuple[str, str], dict[str, str]]:
    """(method, target), lower-cased header dict — or ValueError."""
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise ValueError(f"bad request line: {lines[0]!r}")
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        k, sep, v = line.partition(":")
        if not sep:
            raise ValueError(f"bad header line: {line!r}")
        headers[k.strip().lower()] = v.strip()
    return (parts[0], parts[1]), headers
