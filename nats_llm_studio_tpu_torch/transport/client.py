"""Asyncio NATS client: pub/sub, queue groups, request-reply, streaming requests.

Provides the client capabilities the reference gets from nats.go v1.47.0
(upstream go.mod:8): ``Publish``/``Subscribe``/``QueueSubscribe``/
``Request`` with a muxed ``_INBOX.<nuid>.*`` reply subscription, plus
``request_stream`` — the multi-reply extension the TPU build uses for token
streaming (SURVEY.md §7 hard-part 3): many messages arrive on the reply inbox
and the terminal one carries a ``Nats-Stream-Done`` header with the aggregate,
so naive single-reply clients still see a complete response.

Fault tolerance (the nats.go behaviors the first cut dropped):

* **auto-reconnect** with exponential backoff + jitter when the TCP
  connection is lost (``max_reconnects`` attempts, 0 disables); live
  subscriptions are automatically re-issued on the new connection and
  publishes made while down are buffered (bounded by
  ``pending_buffer_bytes``) and flushed on reconnect
* **PING keepalive** (``ping_interval_s`` > 0): a connection that stops
  answering ``max_outstanding_pings`` consecutive PINGs is declared stale
  and dropped into the reconnect path instead of hanging forever
* **fail-fast closed-connection errors**: ``flush()``/``request()`` raise
  :class:`ConnectionClosedError` the moment the connection is gone instead
  of waiting out the full request timeout, and in-flight request futures
  are failed the same way on a disconnect — so a retry policy can re-issue
  immediately after the reconnect
* **opt-in request retries**: ``request(..., retry=RetryPolicy(...))``
  retries on lost connections and on *retryable* error envelopes (the
  ``"worker draining, retry on another worker"`` / shed shapes — see
  ``transport/envelope.py``), with bounded attempts and backoff
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import time
from dataclasses import dataclass
from typing import AsyncIterator, Awaitable, Callable
from urllib.parse import urlparse

from ..obs import new_trace_id
from ..obs import emit as obs_emit
from ..utils import next_nuid
from . import faults as _faults
from . import protocol as p
from .envelope import deadline_header_value, deadline_remaining_s, is_retryable_envelope

log = logging.getLogger(__name__)


class ConnectionClosedError(ConnectionError):
    """The connection is gone and no reply can arrive on it: closed, never
    connected, reconnect disabled/exhausted, or dropped mid-request. Raised
    instead of letting callers wait out a request timeout on a dead socket."""


@dataclass(slots=True)
class RetryPolicy:
    """Bounded retry for ``request()``: lost connections and *retryable*
    error envelopes (``envelope.is_retryable_envelope``) are re-issued after
    exponential backoff with jitter; other errors surface immediately.
    ``retry_on_timeout`` additionally retries request timeouts — only safe
    for idempotent operations (the first attempt may still execute)."""

    max_attempts: int = 3
    backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    jitter: float = 0.25  # fraction of the delay added uniformly at random
    retry_on_timeout: bool = False

    def delay_s(self, attempt: int) -> float:
        """Backoff before attempt ``attempt + 1`` (attempt is 1-based)."""
        d = min(self.backoff_s * (2 ** (attempt - 1)), self.max_backoff_s)
        return d * (1.0 + random.random() * self.jitter)


@dataclass(slots=True)
class Msg:
    subject: str
    payload: bytes
    reply: str | None = None
    headers: dict[str, str] | None = None
    _client: "NatsClient | None" = None

    def json(self):
        return json.loads(self.payload or b"null")

    async def respond(self, payload: bytes, headers: dict[str, str] | None = None) -> None:
        """Reply via this message's own connection — mirrors msg.Respond in the
        reference (upstream nats_llm_studio.go:214)."""
        if not self.reply:
            raise ValueError("message has no reply subject")
        assert self._client is not None
        await self._client.publish(self.reply, payload, headers=headers)


# queue sentinel a reconnect pushes into gap-sensitive subscriptions (only
# request_stream opts in): replies published while the connection was down
# are gone, so the stream must fail fast rather than idle out
_GAP = object()


class Subscription:
    def __init__(self, client: "NatsClient", sid: str, subject: str, queue: str | None):
        self._client = client
        self.sid = sid
        self.subject = subject
        self.queue = queue
        self._queue: asyncio.Queue[Msg | None] = asyncio.Queue()
        self._cb: Callable[[Msg], Awaitable[None]] | None = None
        self._cb_tasks: set[asyncio.Task] = set()
        self.closed = False
        self._delivered = 0  # total messages handed to this sub
        self._max_msgs: int | None = None  # auto-unsub bound, if any
        self._fail_on_gap = False  # next_msg raises after a reconnect gap

    def _deliver(self, msg: Msg) -> None:
        self._delivered += 1
        if self._cb is not None:
            task = asyncio.ensure_future(self._cb(msg))
            self._cb_tasks.add(task)
            task.add_done_callback(self._cb_tasks.discard)
        else:
            self._queue.put_nowait(msg)

    def _deliver_gap(self) -> None:
        """Reconnect notice for gap-sensitive consumers (request_stream):
        messages may have been lost while the connection was down."""
        if self._fail_on_gap and not self.closed:
            self._queue.put_nowait(_GAP)

    def _close_local(self) -> None:
        """Mark closed and wake pending next_msg waiters (no wire traffic)."""
        if not self.closed:
            self.closed = True
            self._queue.put_nowait(None)

    async def next_msg(self, timeout: float | None = None) -> Msg:
        if self.closed and self._queue.empty():
            raise BrokenPipeError("subscription closed")
        msg = await asyncio.wait_for(self._queue.get(), timeout)
        if msg is None:
            raise BrokenPipeError("subscription closed")
        if msg is _GAP:
            raise ConnectionClosedError(
                "connection lost mid-stream; replies may have been missed"
            )
        return msg

    def __aiter__(self) -> AsyncIterator[Msg]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[Msg]:
        while True:
            try:
                yield await self.next_msg()
            except BrokenPipeError:
                return

    async def unsubscribe(self) -> None:
        if not self.closed:
            self._close_local()
            await self._client._unsubscribe(self.sid)

    async def auto_unsubscribe(self, max_msgs: int) -> None:
        """UNSUB <sid> <max_msgs>: the server stops after ``max_msgs`` total
        deliveries to this sid; the client closes the sub at the same count."""
        await self._client._unsubscribe(self.sid, max_msgs)


class NatsClient:
    """A single NATS connection (with automatic reconnection)."""

    def __init__(self) -> None:
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._parser = p.Parser()
        self._subs: dict[str, Subscription] = {}
        self._next_sid = 0
        self._read_task: asyncio.Task | None = None
        self._pong_waiters: list[asyncio.Future] = []
        self._inbox_prefix = f"_INBOX.{next_nuid()}"
        self._resp_futures: dict[str, asyncio.Future[Msg]] = {}
        self._resp_sub_started = False
        self._closed = asyncio.Event()
        self.server_info: dict = {}
        self._write_lock = asyncio.Lock()
        # -- reconnect state --------------------------------------------------
        self._url = "nats://127.0.0.1:4222"
        self._name: str | None = None
        self._connected = asyncio.Event()  # cleared while the link is down
        self._reconnect_task: asyncio.Task | None = None
        self._ping_task: asyncio.Task | None = None
        self._pending: list[bytes] = []  # frames buffered while reconnecting
        self._pending_bytes = 0
        self._outstanding_pings = 0
        self.reconnects = 0  # completed reconnects (prometheus: lmstudio_reconnects_total)
        self.last_reconnect_s = 0.0  # duration of the last reconnect (bench reports it)
        # knobs (overridable via connect()): nats.go-like defaults, scaled
        # for the embedded single-host broker
        self.max_reconnects = 60  # 0 disables auto-reconnect entirely
        self.reconnect_wait_s = 0.05  # backoff base (doubles per attempt)
        self.reconnect_max_wait_s = 2.0  # backoff cap
        self.ping_interval_s = 0.0  # 0 disables the keepalive task
        self.max_outstanding_pings = 2  # unanswered PINGs before declaring stale
        self.pending_buffer_bytes = 1 << 20  # publish buffer bound while down

    # -- lifecycle ----------------------------------------------------------

    async def connect(
        self,
        url: str = "nats://127.0.0.1:4222",
        name: str | None = None,
        max_reconnects: int | None = None,
        reconnect_wait_s: float | None = None,
        reconnect_max_wait_s: float | None = None,
        ping_interval_s: float | None = None,
        max_outstanding_pings: int | None = None,
        pending_buffer_bytes: int | None = None,
    ) -> None:
        self._url = url
        self._name = name
        if max_reconnects is not None:
            self.max_reconnects = max_reconnects
        if reconnect_wait_s is not None:
            self.reconnect_wait_s = reconnect_wait_s
        if reconnect_max_wait_s is not None:
            self.reconnect_max_wait_s = reconnect_max_wait_s
        if ping_interval_s is not None:
            self.ping_interval_s = ping_interval_s
        if max_outstanding_pings is not None:
            self.max_outstanding_pings = max_outstanding_pings
        if pending_buffer_bytes is not None:
            self.pending_buffer_bytes = pending_buffer_bytes
        await self._dial()
        self._connected.set()
        await self.flush()
        if self.ping_interval_s > 0 and self._ping_task is None:
            self._ping_task = asyncio.ensure_future(self._ping_loop())

    async def _dial(self) -> None:
        """One connection attempt: TCP connect, INFO/CONNECT handshake, fresh
        read loop. Shared by the initial connect and every reconnect."""
        if _faults.ACTIVE is not None:
            f = _faults.ACTIVE.check(_faults.CLIENT_CONNECT)
            if f is not None and f.kind == "raise":
                raise ConnectionError("injected connect failure (chaos)")
        u = urlparse(self._url)
        host = u.hostname or "127.0.0.1"
        port = u.port or 4222
        reader, writer = await asyncio.open_connection(host, port)
        parser = p.Parser()
        # read INFO
        line = await reader.readline()
        events = list(parser.feed(line))
        if not events or not isinstance(events[0], p.InfoEvent):
            writer.close()
            raise ConnectionError(f"expected INFO, got {events!r}")
        self.server_info = events[0].info
        opts = {
            "verbose": False,
            "pedantic": False,
            "lang": "python-tpu",
            "version": "0.1.0",
            "protocol": 1,
            "headers": True,
        }
        if self._name:
            opts["name"] = self._name
        writer.write(p.encode_connect(opts) + p.PING)
        await writer.drain()
        self._reader, self._writer, self._parser = reader, writer, parser
        self._outstanding_pings = 0
        self._read_task = asyncio.ensure_future(self._read_loop(reader))
        # NOTE: callers set _connected — the reconnect path restores subs and
        # flushes the pending buffer FIRST, so concurrent publishes can't
        # jump ahead of buffered ones

    async def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self._connected.clear()
        # the read loop calls close() on EOF: cancelling the task running us
        # would abort the cleanup below at the first await
        cur = asyncio.current_task()
        for task in (self._read_task, self._reconnect_task, self._ping_task):
            if task is not None and task is not cur:
                task.cancel()
        for sub in self._subs.values():
            sub._close_local()
        for fut in self._resp_futures.values():
            if not fut.done():
                fut.set_exception(ConnectionClosedError("connection closed"))
        self._resp_futures.clear()
        for fut in self._pong_waiters:
            if not fut.done():
                fut.set_exception(ConnectionClosedError("connection closed"))
        self._pong_waiters.clear()
        self._pending.clear()
        self._pending_bytes = 0
        if self._writer:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def drain(self) -> None:
        """Unsubscribe everything, flush, close — graceful worker shutdown
        (the runtime behavior upstream README.md:475-484 leaves to the
        embedding application)."""
        for sub in list(self._subs.values()):
            await sub.unsubscribe()
        try:
            await self.flush()
        except ConnectionError:
            pass
        await self.close()

    # -- reconnect machinery -------------------------------------------------

    @property
    def is_connected(self) -> bool:
        return self._connected.is_set() and not self._closed.is_set()

    def _begin_reconnect(self) -> None:
        """The link just dropped: fail in-flight request/flush waiters FAST
        (so retry policies can re-issue after the reconnect instead of
        waiting out their timeouts), notify gap-sensitive streams, and start
        the reconnect task. Idempotent while a reconnect is in flight."""
        if self._closed.is_set():
            return
        self._connected.clear()
        self._outstanding_pings = 0
        if self._writer is not None:
            try:
                self._writer.close()
            except (ConnectionError, OSError):
                pass
        err = ConnectionClosedError("connection lost; reconnecting")
        for fut in self._resp_futures.values():
            if not fut.done():
                fut.set_exception(err)
        self._resp_futures.clear()
        for fut in self._pong_waiters:
            if not fut.done():
                fut.set_exception(err)
        self._pong_waiters.clear()
        for sub in list(self._subs.values()):
            sub._deliver_gap()
        if self._reconnect_task is None or self._reconnect_task.done():
            self._reconnect_task = asyncio.ensure_future(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        """Exponential backoff + jitter until the dial succeeds (or the
        attempt budget runs out → close). On success: re-issue every live
        subscription, flush the pending publish buffer, count the reconnect."""
        t0 = time.monotonic()
        attempt = 0
        while not self._closed.is_set():
            attempt += 1
            if self.max_reconnects > 0 and attempt > self.max_reconnects:
                log.error(
                    "reconnect to %s abandoned after %d attempts", self._url,
                    self.max_reconnects,
                )
                await self.close()
                return
            delay = min(
                self.reconnect_wait_s * (2 ** (attempt - 1)),
                self.reconnect_max_wait_s,
            )
            # jitter: avoids a reconnect stampede when many clients lose the
            # same broker at the same instant
            await asyncio.sleep(delay * (1.0 + random.random() * 0.25))
            if self._closed.is_set():
                return
            try:
                await self._dial()
            except (ConnectionError, OSError, asyncio.TimeoutError):
                continue
            n_subs = sum(1 for s in self._subs.values() if not s.closed)
            n_flushed = len(self._pending)
            try:
                await self._restore_state()
            except (ConnectionError, OSError):
                # the fresh connection died during restore: its read loop
                # saw the EOF too, but _begin_reconnect no-ops while THIS
                # task is alive — so loop and dial again ourselves
                self._connected.clear()
                continue
            self._connected.set()
            self.reconnects += 1
            self.last_reconnect_s = time.monotonic() - t0
            log.info(
                "reconnected to %s after %d attempt(s) in %.3fs "
                "(%d subs restored, %d buffered frames flushed)",
                self._url, attempt, self.last_reconnect_s, n_subs, n_flushed,
            )
            obs_emit(
                "client_reconnect", url=self._url, attempts=attempt,
                seconds=round(self.last_reconnect_s, 4),
            )
            return

    async def _restore_state(self) -> None:
        """Re-SUB every live subscription (re-arming remaining auto-unsub
        bounds) and flush publishes buffered while the link was down."""
        assert self._writer is not None
        async with self._write_lock:
            for sid, sub in list(self._subs.items()):
                if sub.closed:
                    continue
                self._writer.write(p.encode_sub(sub.subject, sid, sub.queue))
                if sub._max_msgs is not None:
                    # server delivery counts reset with the new SUB: re-arm
                    # with what this sub is still owed
                    remaining = max(1, sub._max_msgs - sub._delivered)
                    self._writer.write(p.encode_unsub(sid, remaining))
            # loop: the drain awaits can interleave with _send calls that
            # buffer more frames (we are still "down" until the caller sets
            # _connected) — flush until the buffer stays empty
            while self._pending:
                pending, self._pending = self._pending, []
                self._pending_bytes = 0
                for frame in pending:
                    self._writer.write(frame)
                await self._writer.drain()
            await self._writer.drain()

    async def _ping_loop(self) -> None:
        """Client-originated keepalive: a connection that stops answering
        ``max_outstanding_pings`` consecutive PINGs is stale (half-open TCP,
        hung broker) and is dropped into the reconnect path — the silent
        hang the reference's request timeout was the only detector for."""
        try:
            while not self._closed.is_set():
                await asyncio.sleep(self.ping_interval_s)
                if not self._connected.is_set():
                    continue
                if self._outstanding_pings >= self.max_outstanding_pings:
                    log.warning(
                        "stale connection to %s (%d unanswered PINGs); dropping",
                        self._url, self._outstanding_pings,
                    )
                    obs_emit("client_stale_connection", url=self._url,
                             outstanding_pings=self._outstanding_pings)
                    self._begin_reconnect()
                    continue
                self._outstanding_pings += 1
                try:
                    await self._send(p.PING)
                except ConnectionError:
                    continue
        except asyncio.CancelledError:
            pass

    # -- core ops -----------------------------------------------------------

    async def _send(self, data: bytes) -> None:
        if self._closed.is_set():
            raise ConnectionClosedError("connection closed")
        if not self._connected.is_set():
            if self._reconnect_task is not None and not self._reconnect_task.done():
                # reconnecting: buffer (bounded) and flush on the new link
                if self._pending_bytes + len(data) > self.pending_buffer_bytes:
                    raise ConnectionClosedError(
                        f"pending buffer full ({self._pending_bytes} bytes) "
                        f"while reconnecting"
                    )
                self._pending.append(data)
                self._pending_bytes += len(data)
                return
            raise ConnectionClosedError("not connected")
        assert self._writer is not None
        try:
            async with self._write_lock:
                self._writer.write(data)
                await self._writer.drain()
        except (ConnectionError, OSError) as e:
            # the write path noticed the drop before the read loop did
            if self.max_reconnects:
                self._begin_reconnect()
            raise ConnectionClosedError(f"connection lost during send: {e}") from e

    async def publish(
        self,
        subject: str,
        payload: bytes = b"",
        reply: str | None = None,
        headers: dict[str, str] | None = None,
    ) -> None:
        # client-side guard, same as nats.go/nats.py: the server would answer
        # a violation with -ERR (and real nats-server drops the connection),
        # so fail fast with the advertised limit instead
        limit = (self.server_info or {}).get("max_payload")
        if limit and len(payload) > int(limit):
            raise ValueError(
                f"payload of {len(payload)} bytes exceeds server max_payload {limit}"
            )
        await self._send(p.encode_pub(subject, payload, reply, headers))

    async def subscribe(
        self,
        subject: str,
        queue: str | None = None,
        cb: Callable[[Msg], Awaitable[None]] | None = None,
    ) -> Subscription:
        if self._closed.is_set():
            raise ConnectionClosedError("connection closed")
        if self._writer is None:
            raise ConnectionClosedError("not connected")
        self._next_sid += 1
        sid = str(self._next_sid)
        sub = Subscription(self, sid, subject, queue)
        sub._cb = cb
        self._subs[sid] = sub
        if self._connected.is_set():
            await self._send(p.encode_sub(subject, sid, queue))
        # else: registered locally; the reconnect's _restore_state re-issues
        # SUB for every live sub, including this one
        return sub

    async def _unsubscribe(self, sid: str, max_msgs: int | None = None) -> None:
        if max_msgs is None:
            # immediate unsubscribe: the server stops routing now, drop ours
            self._subs.pop(sid, None)
        else:
            # auto-unsub: the SERVER stops after max_msgs total deliveries;
            # mirror the bound client-side so the sub is closed and removed
            # when the count is exhausted (see _dispatch) instead of leaking
            # in _subs forever
            sub = self._subs.get(sid)
            if sub is not None:
                if sub._delivered >= max_msgs:
                    self._subs.pop(sid, None)
                    sub._close_local()
                else:
                    sub._max_msgs = max_msgs
        try:
            await self._send(p.encode_unsub(sid, max_msgs))
        except ConnectionError:
            pass

    async def flush(self, timeout: float = 10.0) -> None:
        if self._closed.is_set() or self._writer is None:
            # fail fast: no PONG can ever arrive on a closed connection —
            # waiting out `timeout` here was the satellite bug
            raise ConnectionClosedError("connection closed")
        if not self._connected.is_set():
            raise ConnectionClosedError("connection lost; reconnecting")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pong_waiters.append(fut)
        await self._send(p.PING)
        await asyncio.wait_for(fut, timeout)

    # -- request-reply ------------------------------------------------------

    async def _ensure_resp_sub(self) -> None:
        if self._resp_sub_started:
            return
        self._resp_sub_started = True

        async def on_resp(msg: Msg) -> None:
            token = msg.subject.rsplit(".", 1)[-1]
            fut = self._resp_futures.pop(token, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)

        await self.subscribe(self._inbox_prefix + ".*", cb=on_resp)

    def new_inbox(self) -> str:
        return f"_INBOX.{next_nuid()}"

    async def request(
        self,
        subject: str,
        payload: bytes = b"",
        timeout: float = 2.0,
        headers: dict[str, str] | None = None,
        retry: RetryPolicy | None = None,
    ) -> Msg:
        """Single request, single reply — the pattern every reference subject
        uses (upstream README.md:86-88, :131-134, :181-186, :237-245).

        A trace id is minted into the ``X-Trace-Id`` header when the caller
        did not set one, so every request is traceable end-to-end (the worker
        echoes it in the envelope and stamps per-stage spans under it).

        With ``retry``, lost connections (``ConnectionClosedError``) and
        *retryable* error envelopes are re-issued up to
        ``retry.max_attempts`` times with backoff; each re-issue uses a
        fresh inbox token, so a late reply to an abandoned attempt can never
        be mistaken for the current one. The final attempt's envelope (even
        a retryable error) is returned honestly.

        ONE absolute deadline (``X-Deadline-Ms``, minted from the first
        attempt's timeout unless the caller stamped it) spans every attempt:
        each attempt's timeout is capped by the remaining budget, backoff
        sleeps never outlast it, and when the budget is gone the last
        retryable envelope (or error) surfaces immediately instead of
        sleeping past the caller's deadline.

        Workers echo their id in the ``X-Worker-Id`` reply header (and the
        envelope's ``data.worker_id``); each retryable failure adds it to
        the ``X-Excluded-Workers`` header of the next attempt, so a worker
        that just shed (or died under) this request bounces a queue-group
        redelivery retryably instead of serving the retry."""
        if retry is None:
            return await self._request_once(subject, payload, timeout, headers)
        # ONE trace id spans every attempt of a retried request (minted
        # here, before the attempt loop): the retries are the same logical
        # request, and a per-attempt id would shatter its story across the
        # cluster's traces. The attempt header tells the spans apart.
        headers = dict(headers) if headers else {}
        headers.setdefault(p.TRACE_HEADER, new_trace_id())
        headers.setdefault(p.DEADLINE_HEADER, deadline_header_value(timeout))
        deadline_hdr = headers[p.DEADLINE_HEADER]
        excluded = p.parse_worker_list(headers.get(p.EXCLUDED_WORKERS_HEADER))
        last_exc: BaseException | None = None
        last_msg: Msg | None = None
        for attempt in range(1, retry.max_attempts + 1):
            remaining = deadline_remaining_s(deadline_hdr)
            attempt_timeout = (
                timeout if remaining is None else min(timeout, remaining)
            )
            if attempt_timeout <= 0:
                break  # budget exhausted: report the last outcome honestly
            headers[p.ATTEMPT_HEADER] = str(attempt)
            try:
                msg = await self._request_once(
                    subject, payload, attempt_timeout, headers
                )
            except ConnectionClosedError as e:
                last_exc, last_msg = e, None
            except asyncio.TimeoutError as e:
                if not retry.retry_on_timeout:
                    raise
                last_exc, last_msg = e, None
            else:
                if attempt < retry.max_attempts and self._retryable_reply(msg):
                    last_exc, last_msg = None, msg
                    wid = self._reply_worker_id(msg)
                    if wid:
                        if self._is_excluded_bounce(msg):
                            # exclusion is one-shot: the bounce already
                            # deflected the immediate retry, so drop the
                            # worker — a single-worker group (or one whose
                            # every member shed once) must stay servable
                            if wid in excluded:
                                excluded.remove(wid)
                        elif wid not in excluded:
                            excluded.append(wid)
                        if excluded:
                            headers[p.EXCLUDED_WORKERS_HEADER] = (
                                p.format_worker_list(excluded)
                            )
                        else:
                            headers.pop(p.EXCLUDED_WORKERS_HEADER, None)
                    if not await self._backoff_within_budget(
                        retry.delay_s(attempt), deadline_hdr
                    ):
                        break
                    continue
                return msg
            if attempt >= retry.max_attempts:
                break
            if isinstance(last_exc, ConnectionClosedError) and not self._closed.is_set():
                # give the reconnect a chance before burning the next attempt
                try:
                    await asyncio.wait_for(self._connected.wait(), attempt_timeout)
                except asyncio.TimeoutError:
                    pass
            if not await self._backoff_within_budget(
                retry.delay_s(attempt), deadline_hdr
            ):
                break
        if last_msg is not None:
            return last_msg
        if last_exc is not None:
            raise last_exc
        raise asyncio.TimeoutError(
            f"deadline budget exhausted before request to {subject}"
        )

    @staticmethod
    async def _backoff_within_budget(delay: float, deadline_hdr: str) -> bool:
        """Sleep ``delay`` only if the deadline budget survives it; False
        means the budget is (or would be) exhausted and retrying must stop
        now rather than sleeping past the caller's deadline."""
        remaining = deadline_remaining_s(deadline_hdr)
        if remaining is not None and delay >= remaining:
            return False
        await asyncio.sleep(delay)
        return True

    @staticmethod
    def _reply_worker_id(msg: Msg) -> str | None:
        """The replying worker's id: the ``X-Worker-Id`` header when
        present, else the envelope's ``data.worker_id``."""
        wid = (msg.headers or {}).get(p.WORKER_HEADER)
        if wid:
            return wid
        try:
            env = json.loads(msg.payload or b"null")
        except ValueError:
            return None
        if isinstance(env, dict) and isinstance(env.get("data"), dict):
            wid = env["data"].get("worker_id")
            return wid if isinstance(wid, str) and wid else None
        return None

    @staticmethod
    def _retryable_reply(msg: Msg) -> bool:
        try:
            env = json.loads(msg.payload or b"null")
        except ValueError:
            return False
        return is_retryable_envelope(env)

    @staticmethod
    def _is_excluded_bounce(msg: Msg) -> bool:
        """True for a worker's self-check bounce (it matched the request's
        ``X-Excluded-Workers`` header) — the one retryable reply that should
        SHRINK the exclusion list instead of growing it."""
        try:
            env = json.loads(msg.payload or b"null")
        except ValueError:
            return False
        return isinstance(env, dict) and isinstance(env.get("data"), dict) \
            and bool(env["data"].get("excluded_bounce"))

    async def _request_once(
        self,
        subject: str,
        payload: bytes,
        timeout: float,
        headers: dict[str, str] | None,
    ) -> Msg:
        await self._ensure_resp_sub()
        headers = dict(headers) if headers else {}
        headers.setdefault(p.TRACE_HEADER, new_trace_id())
        # absolute budget: the worker sheds/aborts work the caller has
        # already abandoned (capped server-side by the per-op ladder)
        headers.setdefault(p.DEADLINE_HEADER, deadline_header_value(timeout))
        token = next_nuid()
        inbox = f"{self._inbox_prefix}.{token}"
        fut: asyncio.Future[Msg] = asyncio.get_running_loop().create_future()
        self._resp_futures[token] = fut
        await self.publish(subject, payload, reply=inbox, headers=headers)
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._resp_futures.pop(token, None)
            raise
        except BaseException:
            self._resp_futures.pop(token, None)
            raise

    async def request_stream(
        self,
        subject: str,
        payload: bytes = b"",
        timeout: float = 120.0,
        idle_timeout: float = 30.0,
        headers: dict[str, str] | None = None,
    ) -> AsyncIterator[Msg]:
        """Multi-reply request: yields every message published to the reply
        inbox until one carries the ``Nats-Stream-Done`` header (the terminal
        aggregate) or timeout elapses. Mints ``X-Trace-Id`` like request().

        A reconnect mid-stream raises :class:`ConnectionClosedError`
        immediately: replies published while the link was down are gone, so
        continuing would silently drop tokens — callers retry the whole
        logical request (with a fresh inbox) instead."""
        headers = dict(headers) if headers else {}
        headers.setdefault(p.TRACE_HEADER, new_trace_id())
        headers.setdefault(p.DEADLINE_HEADER, deadline_header_value(timeout))
        inbox = self.new_inbox()
        sub = await self.subscribe(inbox)
        sub._fail_on_gap = True
        await self.publish(subject, payload, reply=inbox, headers=headers)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        done = False
        try:
            while True:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    raise asyncio.TimeoutError(f"stream request to {subject} timed out")
                msg = await sub.next_msg(timeout=min(remaining, idle_timeout))
                yield msg
                if msg.headers and "Nats-Stream-Done" in msg.headers:
                    done = True
                    return
        finally:
            if not done:
                # consumer-gone: the caller abandoned the stream before the
                # terminal message (HTTP client disconnected, deadline hit,
                # generator closed). Tell the serving worker so it frees the
                # batcher slot NOW instead of decoding to max_tokens for
                # nobody. Best-effort: the worker's own idle timeout is the
                # backstop if this publish is lost.
                try:
                    await self.publish(inbox + p.STREAM_CANCEL_SUFFIX, b"")
                except Exception:  # noqa: BLE001 — connection may be gone
                    pass
            await sub.unsubscribe()

    # -- read loop ----------------------------------------------------------

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                data = await reader.read(64 * 1024)
                if not data:
                    break
                for ev in self._parser.feed(data):
                    await self._dispatch(ev)
        except asyncio.CancelledError:
            return
        except (ConnectionError, OSError):
            pass
        # connection lost (EOF or socket error). Only the CURRENT
        # connection's read loop may react — a stale loop unwinding after a
        # successful reconnect must not tear the new link down.
        if self._closed.is_set() or self._reader is not reader:
            return
        if self.max_reconnects:
            self._begin_reconnect()
        else:
            await self.close()

    async def _dispatch(self, ev: p.Event) -> None:
        if isinstance(ev, p.MsgEvent):
            sub = self._subs.get(ev.sid or "")
            if sub is not None:
                sub._deliver(
                    Msg(
                        subject=ev.subject,
                        payload=ev.payload,
                        reply=ev.reply,
                        headers=ev.headers,
                        _client=self,
                    )
                )
                if sub._max_msgs is not None and sub._delivered >= sub._max_msgs:
                    # server-side auto-unsub just exhausted: it will send no
                    # more messages on this sid, so retire the sub locally too
                    self._subs.pop(sub.sid, None)
                    sub._close_local()
        elif isinstance(ev, p.CtrlEvent):
            if ev.op == "PING":
                await self._send(p.PONG)
            elif ev.op == "PONG":
                self._outstanding_pings = 0  # keepalive: the link is live
                while self._pong_waiters:
                    fut = self._pong_waiters.pop(0)
                    if not fut.done():
                        fut.set_result(None)
                    break
        elif isinstance(ev, p.ErrEvent):
            # fatal server errors close the connection; others are logged
            pass


async def connect(
    url: str = "nats://127.0.0.1:4222", name: str | None = None, **kwargs
) -> NatsClient:
    nc = NatsClient()
    await nc.connect(url, name=name, **kwargs)
    return nc
