"""Embedded NATS broker: core pub/sub, wildcards, queue groups, headers.

The reference requires an external ``nats-server`` binary (installed and
launched by upstream scripts/setup_unix.sh:72-102). This build ships a
wire-compatible broker in-tree so the whole stack — tests, benchmarks, and
single-host deployments — runs hermetically with zero external processes.
Queue-group delivery (one random member per group per message) reproduces the
competing-consumers scale-out contract (upstream README.md:478-484).

The broker also hosts server-side modules (e.g. the object store,
``store/objectstore.py``) which register internal handlers on API subjects —
the in-tree analog of nats-server's JetStream subsystem.
"""

from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass
from typing import Awaitable, Callable

from ..utils import subject_matches, valid_subject
from . import faults as _faults
from . import protocol as p

log = logging.getLogger(__name__)

MAX_PAYLOAD = 1024 * 1024  # real nats-server's default; chunks are 128 KiB
MAX_PENDING = 64 * 1024 * 1024  # per-client outbound buffer bound (nats-server
# default max_pending): a stalled subscriber must not buffer without limit —
# it is dropped with -ERR 'Slow Consumer' like the real server


@dataclass(slots=True)
class _Sub:
    client: "_ClientConn"
    sid: str
    subject: str
    queue: str | None
    delivered: int = 0  # total messages sent to this sid since SUB
    max_msgs: int | None = None  # auto-unsub bound: TOTAL deliveries since
    # SUB (real nats-server semantics — NOT a countdown from the UNSUB)


class _ClientConn:
    def __init__(self, broker: "EmbeddedBroker", reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.broker = broker
        self.reader = reader
        self.writer = writer
        self.parser = p.Parser()
        self.subs: dict[str, _Sub] = {}
        self.cid = broker._next_cid()
        self.name = ""  # CONNECT name; chaos rules scope severs by it
        self.closed = False
        self._out = asyncio.Queue[bytes | None]()
        self._pending = 0  # bytes enqueued but not yet written to the socket
        self._dropping = False  # slow-consumer drop already scheduled
        self._writer_task: asyncio.Task | None = None

    def send(self, data: bytes) -> None:
        if self.closed or self._dropping:
            return
        if self._pending + len(data) > self.broker.max_pending:
            self._dropping = True
            # slow consumer: the write loop is not draining (stalled reader).
            # Bound broker memory by dropping the client, as nats-server does.
            log.warning(
                "client %d exceeded %d pending bytes; dropping (slow consumer)",
                self.cid, self.broker.max_pending,
            )
            self._out.put_nowait(p.encode_err("Slow Consumer"))  # best-effort
            asyncio.ensure_future(self._close())
            return
        self._pending += len(data)
        self._out.put_nowait(data)

    async def _write_loop(self) -> None:
        try:
            done = False
            while not done:
                data = await self._out.get()
                if data is None:
                    break
                # coalesce pending writes; a None pulled mid-coalesce is the
                # shutdown sentinel — flush what we have, then exit (it must
                # not be swallowed, or _close() stalls its full 1 s wait)
                chunks = [data]
                while not self._out.empty():
                    nxt = self._out.get_nowait()
                    if nxt is None:
                        done = True
                        break
                    chunks.append(nxt)
                buf = b"".join(chunks)
                self.writer.write(buf)
                await self.writer.drain()
                self._pending = max(0, self._pending - len(buf))
        except (ConnectionError, OSError, asyncio.CancelledError):
            pass

    async def run(self) -> None:
        self._writer_task = asyncio.ensure_future(self._write_loop())
        info = {
            "server_id": self.broker.server_id,
            "server_name": "nats-llm-studio-tpu-embedded",
            "version": "2.10.12-compat",
            "proto": 1,
            "headers": True,
            "max_payload": self.broker.max_payload,
            "client_id": self.cid,
        }
        self.send(p.encode_info(info))
        try:
            while True:
                data = await self.reader.read(64 * 1024)
                if not data:
                    break
                for ev in self.parser.feed(data):
                    await self._handle(ev)
        except (ConnectionError, OSError, p.ProtocolError, ValueError) as e:
            # ValueError covers malformed CONNECT JSON (json.JSONDecodeError)
            # and non-numeric size fields — a hostile or broken peer must get
            # -ERR + drop, never an unhandled task exception (SURVEY.md §5
            # failure detection; found by the protocol fuzz test)
            if isinstance(e, (p.ProtocolError, ValueError)) and not isinstance(
                e, (ConnectionError, OSError)
            ):
                self.send(p.encode_err(f"protocol violation: {e}"))
        finally:
            await self._close()

    async def _close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for sub in list(self.subs.values()):
            self.broker._remove_sub(sub)
        self.subs.clear()
        self.broker._clients.discard(self)
        self._out.put_nowait(None)
        if self._writer_task:
            try:
                await asyncio.wait_for(self._writer_task, 1.0)
            except asyncio.TimeoutError:
                self._writer_task.cancel()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass

    async def _handle(self, ev: p.Event) -> None:
        if isinstance(ev, p.MsgEvent):  # PUB / HPUB
            if len(ev.payload) > self.broker.max_payload:
                self.send(p.encode_err("Maximum Payload Violation"))
                return
            if _faults.ACTIVE is not None:  # chaos harness; off ⇒ one attr read
                f = _faults.ACTIVE.check(_faults.BROKER_PUBLISH, ev.subject,
                                         client=self.name)
                if f is not None:
                    if f.kind == "sever":
                        # drop the publisher's TCP connection; the message is
                        # lost, exactly like a broker crash mid-publish (or,
                        # with a client= scoped rule, that worker dying)
                        log.warning("chaos: severing client %d (%s) on publish to %s",
                                    self.cid, self.name or "unnamed", ev.subject)
                        await self._close()
                        return
                    if f.kind == "drop":
                        return  # silently lose this one message
                    if f.kind == "delay":
                        await asyncio.sleep(f.delay_s)
            await self.broker.route(ev.subject, ev.payload, ev.reply, ev.headers)
        elif isinstance(ev, p.SubEvent):
            if not valid_subject(ev.subject, allow_wildcards=True):
                self.send(p.encode_err(f"Invalid Subject: {ev.subject}"))
                return
            sub = _Sub(self, ev.sid, ev.subject, ev.queue)
            self.subs[ev.sid] = sub
            self.broker._add_sub(sub)
        elif isinstance(ev, p.UnsubEvent):
            sub = self.subs.get(ev.sid)
            if sub is None:
                return
            if ev.max_msgs is None or sub.delivered >= ev.max_msgs:
                # immediate unsub, or the bound is already met (UNSUB max is
                # total deliveries since SUB — a sub that already received
                # that many must be retired NOW, or a queue group could
                # route a message to a sid the client has dropped)
                del self.subs[ev.sid]
                self.broker._remove_sub(sub)
            else:
                sub.max_msgs = ev.max_msgs
        elif isinstance(ev, p.CtrlEvent):
            if ev.op == "PING":
                self.send(p.PONG)
        elif isinstance(ev, p.ConnectEvent):
            # no auth in embedded mode; keep the advertised name so
            # client-scoped chaos rules can target one worker's connection
            name = ev.options.get("name")
            if isinstance(name, str):
                self.name = name


InternalHandler = Callable[[str, bytes, str | None, dict[str, str] | None], Awaitable[None]]


class EmbeddedBroker:
    """In-process NATS-compatible broker. ``await start()`` binds the port."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, max_payload: int = MAX_PAYLOAD,
                 max_pending: int = MAX_PENDING):
        self.host = host
        self.port = port
        self.max_payload = max_payload
        self.max_pending = max_pending
        self.server_id = f"EMB{random.getrandbits(48):012X}"
        self._server: asyncio.base_events.Server | None = None
        self._clients: set[_ClientConn] = set()
        self._subs: list[_Sub] = []
        self._cid = 0
        # internal modules: (pattern, handler) — called in-process, no socket
        self._internal: list[tuple[str, InternalHandler]] = []
        # modules with lifecycle (closed deterministically on stop())
        self._modules: list = []

    @property
    def url(self) -> str:
        return f"nats://{self.host}:{self.port}"

    def _next_cid(self) -> int:
        self._cid += 1
        return self._cid

    async def start(self) -> "EmbeddedBroker":
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
        for c in list(self._clients):
            await c._close()
        # close registered modules (e.g. the object store's append-log file
        # handles) deterministically instead of leaving them to GC
        for m in self._modules:
            close = getattr(m, "close", None)
            if close is not None:
                close()
        self._modules.clear()

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = _ClientConn(self, reader, writer)
        self._clients.add(conn)
        await conn.run()

    # -- interest management -------------------------------------------------

    def _add_sub(self, sub: _Sub) -> None:
        self._subs.append(sub)

    def _remove_sub(self, sub: _Sub) -> None:
        try:
            self._subs.remove(sub)
        except ValueError:
            pass

    def register_internal(self, pattern: str, handler: InternalHandler) -> None:
        """Register a server-side module handler (object store, health...)."""
        self._internal.append((pattern, handler))

    def register_module(self, module) -> None:
        """Track a module for lifecycle: its ``close()`` runs on ``stop()``."""
        self._modules.append(module)

    # -- routing -------------------------------------------------------------

    async def route(
        self,
        subject: str,
        payload: bytes,
        reply: str | None = None,
        headers: dict[str, str] | None = None,
    ) -> None:
        """Deliver a message: plain subs each get a copy; queue groups get one
        randomly-chosen member (README.md:478-484 semantics)."""
        plain: list[_Sub] = []
        groups: dict[tuple[str, str], list[_Sub]] = {}
        for sub in self._subs:
            if sub.client.closed or not subject_matches(sub.subject, subject):
                continue
            if sub.queue:
                groups.setdefault((sub.subject, sub.queue), []).append(sub)
            else:
                plain.append(sub)
        targets = plain + [random.choice(members) for members in groups.values()]
        for sub in targets:
            sub.client.send(p.encode_msg(subject, sub.sid, payload, reply, headers))
            sub.delivered += 1
            if sub.max_msgs is not None and sub.delivered >= sub.max_msgs:
                sub.client.subs.pop(sub.sid, None)
                self._remove_sub(sub)
        for pattern, handler in self._internal:
            if subject_matches(pattern, subject):
                try:
                    await handler(subject, payload, reply, headers)
                except Exception:  # module errors must not kill the router
                    log.exception("internal handler error on %s", subject)

    async def publish_internal(
        self,
        subject: str,
        payload: bytes,
        reply: str | None = None,
        headers: dict[str, str] | None = None,
    ) -> None:
        """Publish from a server-side module."""
        await self.route(subject, payload, reply, headers)
