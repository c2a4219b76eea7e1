"""Object Store client speaking the public JetStream wire protocol.

Copy of ``nats_llm_studio_tpu/transport/jetstream.py``, trimmed to what
the model lifecycle and the KV tier's spill run (bucket create, put, info,
chunked and whole get, list, delete):
the same subjects, chunking (``DEFAULT_CHUNK``) and SHA-256 digests, so
either package's client reads and writes objects through either
package's store module.

Implements the README's model-repository pattern for real
(upstream README.md:250-318): bucket = stream ``OBJ_<bucket>`` over
subjects ``$O.<bucket>.C.>`` (chunks) / ``$O.<bucket>.M.>`` (metadata),
chunked puts with SHA-256 digests, reads via direct-get lookups. Works
against the in-tree broker module (store/objectstore.py) and, by construction
of the subjects/payloads, against a real nats-server with JetStream enabled.
"""

from __future__ import annotations

import base64
import hashlib
import json
import time
from dataclasses import dataclass, field

from ..utils.nuid import next_nuid
from .client import Msg, NatsClient

DEFAULT_CHUNK = 128 * 1024


class ObjectStoreError(Exception):
    pass


class ObjectNotFound(ObjectStoreError):
    pass


def _b64name(name: str) -> str:
    return base64.urlsafe_b64encode(name.encode()).decode()


def _digest(data: bytes) -> str:
    return "SHA-256=" + base64.urlsafe_b64encode(hashlib.sha256(data).digest()).decode()


@dataclass
class ObjectInfo:
    name: str
    bucket: str
    nuid: str
    size: int
    chunks: int
    digest: str
    mtime: str = ""
    deleted: bool = False
    description: str = ""
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_json(cls, data: bytes | dict) -> "ObjectInfo":
        d = data if isinstance(data, dict) else json.loads(data)
        return cls(
            name=d.get("name", ""),
            bucket=d.get("bucket", ""),
            nuid=d.get("nuid", ""),
            size=int(d.get("size", 0)),
            chunks=int(d.get("chunks", 0)),
            digest=d.get("digest", ""),
            mtime=d.get("mtime", ""),
            deleted=bool(d.get("deleted", False)),
            description=d.get("description", ""),
            raw=d,
        )


class ObjectStore:
    """Async object-store API bound to one NATS connection."""

    def __init__(self, nc: NatsClient, timeout: float = 30.0):
        self.nc = nc
        self.timeout = timeout

    # -- JS API helpers ------------------------------------------------------

    async def _api(self, op: str, payload: dict | None = None) -> dict:
        msg = await self.nc.request(
            f"$JS.API.{op}",
            json.dumps(payload or {}).encode(),
            timeout=self.timeout,
        )
        status = (msg.headers or {}).get("Status")
        if status and status.startswith("404"):
            raise ObjectNotFound((msg.headers or {}).get("Description", "not found"))
        body = json.loads(msg.payload) if msg.payload.strip() else {}
        err = body.get("error")
        if err:
            code = int(err.get("code", 500))
            if code == 404:
                raise ObjectNotFound(err.get("description", "not found"))
            raise ObjectStoreError(err.get("description", str(err)))
        return body

    async def _direct_get(self, stream: str, query: dict) -> Msg:
        msg = await self.nc.request(
            f"$JS.API.DIRECT.GET.{stream}", json.dumps(query).encode(), timeout=self.timeout
        )
        status = (msg.headers or {}).get("Status")
        if status and status.startswith("404"):
            raise ObjectNotFound((msg.headers or {}).get("Description", "message not found"))
        if status and not status.startswith("200"):
            raise ObjectStoreError(f"direct get status {status}")
        if not (msg.headers or {}).get("Nats-Subject") and msg.payload[:1] == b"{":
            # JSON error envelope from the API layer
            body = json.loads(msg.payload)
            if body.get("error"):
                code = int(body["error"].get("code", 500))
                exc = ObjectNotFound if code == 404 else ObjectStoreError
                raise exc(body["error"].get("description", "error"))
        return msg

    # -- buckets -------------------------------------------------------------

    @staticmethod
    def _stream(bucket: str) -> str:
        return f"OBJ_{bucket}"

    async def ensure_bucket(self, bucket: str, description: str = "") -> None:
        cfg = {
            "name": self._stream(bucket),
            "description": description,
            "subjects": [f"$O.{bucket}.C.>", f"$O.{bucket}.M.>"],
            "retention": "limits",
            "discard": "new",
            "allow_rollup_hdrs": True,
            "allow_direct": True,
            "max_msgs": -1,
            "max_bytes": -1,
        }
        await self._api(f"STREAM.CREATE.{self._stream(bucket)}", cfg)

    # -- objects -------------------------------------------------------------

    async def put(
        self, bucket: str, name: str, data: bytes, chunk_size: int = DEFAULT_CHUNK,
        description: str = "",
    ) -> ObjectInfo:
        # overwrite: remember the previous revision's chunk subject so its
        # chunks can be purged after the metadata rollup (otherwise every
        # re-publish leaks the full old blob in the stream)
        old_nuid: str | None = None
        try:
            old_nuid = (await self.info(bucket, name)).nuid
        except ObjectStoreError:
            pass
        nuid = next_nuid()
        chunk_subject = f"$O.{bucket}.C.{nuid}"
        n_chunks = 0
        for off in range(0, len(data), chunk_size):
            await self.nc.publish(chunk_subject, data[off : off + chunk_size])
            n_chunks += 1
        if n_chunks == 0:  # zero-byte object still needs no chunks
            pass
        await self.nc.flush()
        info = ObjectInfo(
            name=name,
            bucket=bucket,
            nuid=nuid,
            size=len(data),
            chunks=n_chunks,
            digest=_digest(data),
            mtime=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            description=description,
        )
        meta = {
            "name": info.name,
            "bucket": info.bucket,
            "nuid": info.nuid,
            "size": info.size,
            "chunks": info.chunks,
            "digest": info.digest,
            "mtime": info.mtime,
            "description": description,
        }
        await self.nc.publish(
            f"$O.{bucket}.M.{_b64name(name)}",
            json.dumps(meta, separators=(",", ":")).encode(),
            headers={"Nats-Rollup": "sub"},
        )
        await self.nc.flush()
        if old_nuid and old_nuid != nuid:
            await self._api(
                f"STREAM.PURGE.{self._stream(bucket)}",
                {"filter": f"$O.{bucket}.C.{old_nuid}"},
            )
        return info

    async def info(self, bucket: str, name: str) -> ObjectInfo:
        msg = await self._direct_get(
            self._stream(bucket), {"last_by_subj": f"$O.{bucket}.M.{_b64name(name)}"}
        )
        inf = ObjectInfo.from_json(msg.payload)
        if inf.deleted:
            raise ObjectNotFound(f"object {name!r} is deleted")
        return inf

    async def get_chunks(self, bucket: str, name: str):
        """Stream an object chunk by chunk (async generator).

        O(chunk) memory regardless of object size — the path multi-GB model
        pulls ride (the 100 GiB file-store contract, setup_unix.sh analog).
        Size and SHA-256 digest are verified incrementally; a mismatch
        raises after the last chunk, before the caller commits the result.
        """
        inf = await self.info(bucket, name)
        chunk_subject = f"$O.{bucket}.C.{inf.nuid}"
        seq = 0
        total = 0
        h = hashlib.sha256()
        for _ in range(inf.chunks):
            msg = await self._direct_get(
                self._stream(bucket), {"seq": seq + 1, "next_by_subj": chunk_subject}
            )
            seq = int((msg.headers or {}).get("Nats-Sequence", seq + 1))
            total += len(msg.payload)
            h.update(msg.payload)
            yield msg.payload
        if total != inf.size:
            raise ObjectStoreError(f"size mismatch for {name!r}: {total} != {inf.size}")
        want = "SHA-256=" + base64.urlsafe_b64encode(h.digest()).decode()
        if inf.digest and want != inf.digest:
            raise ObjectStoreError(f"digest mismatch for {name!r}")

    async def list(self, bucket: str, include_deleted: bool = False) -> list[ObjectInfo]:
        out: list[ObjectInfo] = []
        seq = 0
        pat = f"$O.{bucket}.M.>"
        while True:
            try:
                msg = await self._direct_get(
                    self._stream(bucket), {"seq": seq + 1, "next_by_subj": pat}
                )
            except ObjectNotFound:
                break
            inf = ObjectInfo.from_json(msg.payload)
            if include_deleted or not inf.deleted:
                out.append(inf)
            seq = int((msg.headers or {}).get("Nats-Sequence", seq + 1))
        return out

    async def get(self, bucket: str, name: str) -> bytes:
        parts = [chunk async for chunk in self.get_chunks(bucket, name)]
        return b"".join(parts)

    async def delete(self, bucket: str, name: str) -> None:
        inf = await self.info(bucket, name)
        await self._api(
            f"STREAM.PURGE.{self._stream(bucket)}", {"filter": f"$O.{bucket}.C.{inf.nuid}"}
        )
        meta = dict(inf.raw)
        meta.update({"deleted": True, "size": 0, "chunks": 0, "digest": ""})
        await self.nc.publish(
            f"$O.{bucket}.M.{_b64name(name)}",
            json.dumps(meta, separators=(",", ":")).encode(),
            headers={"Nats-Rollup": "sub"},
        )
        await self.nc.flush()
