"""Server-side object store module for the embedded broker.

Copy of ``nats_llm_studio_tpu/store/objectstore.py`` with the same on-disk
record format, so a ``store_dir`` written by either package opens in the
other.

Implements the slice of the public JetStream wire API that the Object Store
pattern needs, so the in-tree client (transport/jetstream.py) — and any
foreign client using direct-get — can store/fetch model blobs:

* ``$JS.API.STREAM.CREATE.<name>`` / ``INFO`` / ``DELETE`` / ``PURGE`` /
  ``NAMES`` — JSON request-reply
* ``$JS.API.DIRECT.GET.<name>`` — ``{"last_by_subj"}`` or
  ``{"seq", "next_by_subj"}`` lookups, replied with Nats-Subject /
  Nats-Sequence headers (404 via status header)
* message capture for stream subjects with ``Nats-Rollup: sub`` per-subject
  rollup (object-store metadata updates)

With a store dir, payloads live ON DISK in a binary append-log per stream
(the JetStream file-store analog, setup_unix.sh:87-95): broker RAM holds
only per-message index entries, so a 40 GB model blob costs O(chunk) memory
and its bytes are written exactly once. Rollups/purges mark bytes dead; the
log compacts when dead bytes outweigh live ones. Without a store dir the
module is the memory-store analog (payloads in RAM, nothing persisted).

Log record format: ``u32 header_len | header JSON | payload bytes``; the
first record is the stream header ``{"config", "next_seq"}`` with an empty
payload.
"""

from __future__ import annotations

import json
import logging
import struct
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO

from ..transport.broker import EmbeddedBroker
from ..utils import subject_matches

log = logging.getLogger(__name__)

_API_PREFIX = "$JS.API."
_COMPACT_MIN_DEAD = 64 * 1024 * 1024


@dataclass
class _StoredMsg:
    seq: int
    subject: str
    headers: dict[str, str] | None
    ts: float
    plen: int
    payload: bytes | None = None  # memory mode only
    offset: int = -1  # disk mode: payload offset within the stream log


@dataclass
class _Stream:
    name: str
    config: dict
    next_seq: int = 1
    msgs: list[_StoredMsg] = field(default_factory=list)  # ordered by seq
    dead_bytes: int = 0  # payload bytes in the log no longer referenced

    @property
    def subjects(self) -> list[str]:
        return list(self.config.get("subjects") or [])

    def captures(self, subject: str) -> bool:
        return any(subject_matches(pat, subject) for pat in self.subjects)

    def bytes_total(self) -> int:
        return sum(m.plen for m in self.msgs)


class JetStreamStoreModule:
    """Attach with ``JetStreamStoreModule(broker).install()``."""

    def __init__(self, broker: EmbeddedBroker, store_dir: str | Path | None = None):
        self.broker = broker
        self.streams: dict[str, _Stream] = {}
        self.store_dir = Path(store_dir) if store_dir else None
        self._files: dict[str, BinaryIO] = {}  # open "a+b" log handles
        if self.store_dir:
            self.store_dir.mkdir(parents=True, exist_ok=True)
            self._load_persisted()

    def install(self) -> "JetStreamStoreModule":
        self.broker.register_internal(_API_PREFIX + ">", self._on_api)
        self.broker.register_internal("$O.>", self._on_capture)
        # broker.stop() closes the append-log handles deterministically
        # (GC-held "a+b" handles block dir removal on Windows and leak fds
        # across restarts)
        self.broker.register_module(self)
        return self

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    # -- persistence (file-store analog: binary append-log) ------------------

    def _stream_file(self, name: str) -> Path:
        assert self.store_dir is not None
        return self.store_dir / f"{name}.jsl"

    def _file(self, name: str) -> BinaryIO:
        f = self._files.get(name)
        if f is None or f.closed:
            f = open(self._stream_file(name), "a+b")
            self._files[name] = f
        return f

    @staticmethod
    def _write_record(f: BinaryIO, head: dict, payload: bytes) -> int:
        """Append one record; returns the payload's file offset."""
        hb = json.dumps(head, separators=(",", ":")).encode()
        f.seek(0, 2)
        f.write(struct.pack(">I", len(hb)))
        f.write(hb)
        off = f.tell()
        f.write(payload)
        return off

    def _persist_header(self, stream: _Stream) -> None:
        """(Re)create the log with just the stream header (new stream)."""
        if not self.store_dir:
            return
        f = self._file(stream.name)
        f.truncate(0)
        self._write_record(
            f, {"config": stream.config, "next_seq": stream.next_seq}, b""
        )
        f.flush()

    def _persist_append(self, stream: _Stream, msg: _StoredMsg, payload: bytes) -> None:
        if not self.store_dir:
            msg.payload = payload
            return
        f = self._file(stream.name)
        head = {
            "seq": msg.seq,
            "subject": msg.subject,
            "headers": msg.headers,
            "ts": msg.ts,
            "plen": msg.plen,
        }
        msg.offset = self._write_record(f, head, payload)
        f.flush()

    def _payload(self, stream: _Stream, msg: _StoredMsg) -> bytes:
        if msg.payload is not None:
            return msg.payload
        f = self._file(stream.name)
        f.seek(msg.offset)
        return f.read(msg.plen)

    def _persist_ctl(self, stream: _Stream, ctl: dict) -> None:
        """Append a control record (e.g. a purge) so replay reproduces
        drops that compaction has not yet made physical."""
        if not self.store_dir:
            return
        f = self._file(stream.name)
        self._write_record(f, {"ctl": ctl}, b"")
        f.flush()

    def _mark_dead(self, stream: _Stream, msgs: list[_StoredMsg]) -> None:
        stream.dead_bytes += sum(m.plen + 96 for m in msgs)

    def _maybe_compact(self, stream: _Stream) -> None:
        """Rewrite the log with only live records once dead bytes outweigh
        live ones — purges/rollups never rewrite the log inline, so dropping
        a multi-GB object is O(1) until compaction actually pays. Small logs
        (metadata-dominated) compact eagerly; that path is bounded at 8 MB
        of blocking IO."""
        if not self.store_dir or stream.dead_bytes == 0:
            return
        small = self._stream_file(stream.name).stat().st_size < 8 * 1024 * 1024
        if not small and (
            stream.dead_bytes < _COMPACT_MIN_DEAD
            or stream.dead_bytes < stream.bytes_total()
        ):
            return
        self._compact(stream)

    def _compact(self, stream: _Stream) -> None:
        assert self.store_dir is not None
        path = self._stream_file(stream.name)
        tmp = path.with_suffix(".tmp")
        old = self._file(stream.name)
        with open(tmp, "wb") as f:
            self._write_record(
                f, {"config": stream.config, "next_seq": stream.next_seq}, b""
            )
            for m in stream.msgs:
                head = {
                    "seq": m.seq,
                    "subject": m.subject,
                    "headers": m.headers,
                    "ts": m.ts,
                    "plen": m.plen,
                }
                if m.payload is not None:
                    payload = m.payload
                else:
                    old.seek(m.offset)
                    payload = old.read(m.plen)
                m.offset = self._write_record(f, head, payload)
        old.close()
        del self._files[stream.name]
        tmp.replace(path)
        stream.dead_bytes = 0

    def _load_persisted(self) -> None:
        assert self.store_dir is not None
        for path in sorted(self.store_dir.glob("*.jsl")):
            try:
                st: _Stream | None = None
                kept: list[_StoredMsg] = []
                live = 0
                max_seq = 0
                fsize = path.stat().st_size
                torn_at: int | None = None
                with open(path, "rb") as f:
                    while True:
                        rec_start = f.tell()
                        raw = f.read(4)
                        if not raw:
                            break
                        if len(raw) < 4:
                            torn_at = rec_start
                            break
                        (hlen,) = struct.unpack(">I", raw)
                        hb = f.read(hlen)
                        if len(hb) < hlen:
                            torn_at = rec_start
                            break
                        head = json.loads(hb)
                        if "config" in head:
                            st = _Stream(
                                name=path.stem, config=head["config"],
                                next_seq=head["next_seq"],
                            )
                            continue
                        assert st is not None
                        if "ctl" in head:
                            # replayed purge: reproduce the runtime drop
                            filt = head["ctl"].get("filter")
                            if filt:
                                kept = [
                                    m for m in kept
                                    if not subject_matches(filt, m.subject)
                                ]
                            else:
                                kept = []
                            continue
                        plen = int(head.get("plen", 0))
                        off = f.tell()
                        if off + plen > fsize:
                            # torn tail: header landed, payload did not
                            torn_at = rec_start
                            break
                        f.seek(plen, 1)
                        live += plen
                        max_seq = max(max_seq, head["seq"])
                        rollup = (head.get("headers") or {}).get("Nats-Rollup")
                        if rollup == "sub":
                            kept = [m for m in kept if m.subject != head["subject"]]
                        elif rollup == "all":
                            kept = []
                        kept.append(
                            _StoredMsg(
                                head["seq"], head["subject"], head.get("headers"),
                                head.get("ts", 0.0), plen, offset=off,
                            )
                        )
                if st is None:
                    raise ValueError("missing stream header")
                if torn_at is not None:
                    log.warning(
                        "truncating torn tail record of %s at offset %d",
                        path, torn_at,
                    )
                    with open(path, "r+b") as f:
                        f.truncate(torn_at)
                st.msgs = kept
                st.next_seq = max(st.next_seq, max_seq + 1)
                st.dead_bytes = live - st.bytes_total()
                self.streams[st.name] = st
            except (ValueError, KeyError, AssertionError, struct.error):
                log.warning("skipping corrupt stream file %s", path)

    # -- capture -------------------------------------------------------------

    async def _on_capture(self, subject: str, payload: bytes, reply, headers) -> None:
        if subject.startswith(_API_PREFIX):
            return
        for stream in self.streams.values():
            if not stream.captures(subject):
                continue
            rollup = (headers or {}).get("Nats-Rollup")
            if rollup == "sub":
                dropped = [m for m in stream.msgs if m.subject == subject]
                stream.msgs = [m for m in stream.msgs if m.subject != subject]
                self._mark_dead(stream, dropped)
            elif rollup == "all":
                self._mark_dead(stream, stream.msgs)
                stream.msgs.clear()
            msg = _StoredMsg(
                stream.next_seq, subject, headers, time.time(), len(payload)
            )
            stream.next_seq += 1
            stream.msgs.append(msg)
            self._persist_append(stream, msg, payload)
            if rollup:
                self._maybe_compact(stream)
            if reply:
                ack = {"stream": stream.name, "seq": msg.seq}
                await self.broker.publish_internal(reply, json.dumps(ack).encode())

    # -- API -----------------------------------------------------------------

    async def _reply_json(self, reply: str | None, obj: dict) -> None:
        if reply:
            await self.broker.publish_internal(reply, json.dumps(obj).encode())

    async def _reply_error(self, reply: str | None, code: int, desc: str) -> None:
        await self._reply_json(
            reply, {"error": {"code": code, "err_code": code * 100, "description": desc}}
        )

    async def _on_api(self, subject: str, payload: bytes, reply, headers) -> None:
        op = subject[len(_API_PREFIX) :]
        try:
            body = json.loads(payload) if payload.strip() else {}
        except ValueError:
            await self._reply_error(reply, 400, "bad request payload")
            return
        try:
            if op.startswith("STREAM.CREATE.") or op.startswith("STREAM.UPDATE."):
                await self._stream_create(op.rsplit(".", 1)[1], body, reply)
            elif op.startswith("STREAM.INFO."):
                await self._stream_info(op.rsplit(".", 1)[1], reply)
            elif op.startswith("STREAM.DELETE."):
                await self._stream_delete(op.rsplit(".", 1)[1], reply)
            elif op.startswith("STREAM.PURGE."):
                await self._stream_purge(op.rsplit(".", 1)[1], body, reply)
            elif op == "STREAM.NAMES":
                names = sorted(self.streams)
                await self._reply_json(
                    reply, {"streams": names, "total": len(names), "offset": 0, "limit": 1024}
                )
            elif op.startswith("DIRECT.GET."):
                await self._direct_get(op[len("DIRECT.GET.") :], body, reply)
            else:
                await self._reply_error(reply, 404, f"unknown JS API op {op}")
        except Exception as e:  # noqa: BLE001 — API errors become error replies
            log.exception("JS API error on %s", subject)
            await self._reply_error(reply, 500, str(e))

    async def _stream_create(self, name: str, config: dict, reply) -> None:
        existing = self.streams.get(name)
        if existing is None:
            config = dict(config or {})
            config.setdefault("name", name)
            config.setdefault("subjects", [name])
            self.streams[name] = _Stream(name=name, config=config)
            self._persist_header(self.streams[name])
        else:
            existing.config.update(config or {})
        await self._stream_info(name, reply)

    def _state(self, st: _Stream) -> dict:
        return {
            "messages": len(st.msgs),
            "bytes": st.bytes_total(),
            "first_seq": st.msgs[0].seq if st.msgs else 0,
            "last_seq": st.msgs[-1].seq if st.msgs else st.next_seq - 1,
            "num_subjects": len({m.subject for m in st.msgs}),
        }

    async def _stream_info(self, name: str, reply) -> None:
        st = self.streams.get(name)
        if st is None:
            await self._reply_error(reply, 404, "stream not found")
            return
        await self._reply_json(
            reply,
            {"type": "io.nats.jetstream.api.v1.stream_info_response",
             "config": st.config, "state": self._state(st), "created": ""},
        )

    async def _stream_delete(self, name: str, reply) -> None:
        st = self.streams.pop(name, None)
        if st is None:
            await self._reply_error(reply, 404, "stream not found")
            return
        f = self._files.pop(name, None)
        if f is not None:
            f.close()
        if self.store_dir:
            self._stream_file(name).unlink(missing_ok=True)
        await self._reply_json(reply, {"success": True})

    async def _stream_purge(self, name: str, body: dict, reply) -> None:
        st = self.streams.get(name)
        if st is None:
            await self._reply_error(reply, 404, "stream not found")
            return
        filt = body.get("filter")
        before = len(st.msgs)
        if filt:
            dropped = [m for m in st.msgs if subject_matches(filt, m.subject)]
            st.msgs = [m for m in st.msgs if not subject_matches(filt, m.subject)]
        else:
            dropped = st.msgs
            st.msgs = []
        self._mark_dead(st, dropped)
        self._persist_ctl(st, {"op": "purge", "filter": filt})
        self._maybe_compact(st)
        await self._reply_json(reply, {"success": True, "purged": before - len(st.msgs)})

    async def _direct_get(self, stream_name: str, body: dict, reply) -> None:
        st = self.streams.get(stream_name)
        if reply is None:
            return
        if st is None:
            await self.broker.publish_internal(
                reply, b"", headers={"Status": "404", "Description": "Stream Not Found"}
            )
            return
        msg: _StoredMsg | None = None
        if "last_by_subj" in body:
            pat = body["last_by_subj"]
            for m in reversed(st.msgs):
                if subject_matches(pat, m.subject):
                    msg = m
                    break
        else:
            seq = int(body.get("seq") or 0)
            pat = body.get("next_by_subj")
            for m in st.msgs:
                if m.seq >= seq and (pat is None or subject_matches(pat, m.subject)):
                    msg = m
                    break
        if msg is None:
            await self.broker.publish_internal(
                reply, b"", headers={"Status": "404", "Description": "Message Not Found"}
            )
            return
        hdrs = dict(msg.headers or {})
        hdrs.update(
            {
                "Nats-Stream": st.name,
                "Nats-Subject": msg.subject,
                "Nats-Sequence": str(msg.seq),
                "Nats-Num-Pending": "0",
            }
        )
        await self.broker.publish_internal(reply, self._payload(st, msg), headers=hdrs)


__all__ = ["JetStreamStoreModule"]
