"""KVX1: the byte layout of a set of KV chunks on the wire or in the Object
Store.

Copy of the encode and decode of ``nats_llm_studio_tpu/serve/kv_transfer.py``
(``encode_kv_blob``, ``decode_kv_blob``, ``KVTransferFormatError``), byte
for byte, so a blob either package writes decodes in the other. The host KV
tier (``serve/kv_tiers.py``) spills single-chunk blobs in it. Per prefill
chunk the blob holds one [1, L, Hkv, C, D] K row and V row (bf16/f32 dense,
or int8 KVQ codes plus [1, L, Hkv, C] f32 scales) and the chunk-end logits
where a prefill harvested them. The port's leaves are CPU tensors or
ndarrays: numpy has no bfloat16 (the reference takes it from
``ml_dtypes``), so a bf16 leaf is a ``torch.bfloat16`` tensor and decodes
back into one; every other dtype decodes into an ndarray, as in the
reference.

Layout (all integers little-endian):

    magic   b"KVX1"
    u32     header length
    header  canonical JSON (sorted keys) describing layout/dtypes/shapes,
            the covered token ids, and which chunks carry logits
    body    per chunk, in order: K codes, [K scales], V codes, [V scales],
            [logits f32] — raw C-order array bytes, sizes derivable from
            the header alone
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

MAGIC = b"KVX1"

_MAX_HEADER_BYTES = 16 << 20  # corrupt-length guard, far above any real header


class KVTransferFormatError(ValueError):
    """The blob is not a well-formed KV transfer payload."""


_BF16 = "bfloat16"


class _Leaf:
    """One leaf as the encoder needs it: its dtype name, shape and raw
    C-order bytes."""

    __slots__ = ("name", "shape", "data")

    def __init__(self, x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().contiguous()
            if x.dtype == torch.bfloat16:
                self.name = _BF16
                self.data = x.reshape(-1).view(torch.int16).numpy().tobytes()
            else:
                a = x.numpy()
                self.name, self.data = a.dtype.name, a.tobytes()
            self.shape = tuple(x.shape)
        else:
            a = np.ascontiguousarray(x)
            self.name, self.shape, self.data = a.dtype.name, a.shape, a.tobytes()


def _itemsize(name: str) -> int:
    return 2 if name == _BF16 else np.dtype(name).itemsize


def _from_bytes(data: bytes, name: str, shape):
    """Raw bytes -> an ndarray of ``name``, or a bf16 tensor."""
    if name == _BF16:
        return torch.frombuffer(bytearray(data), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _leaf_pair(arr):
    """Normalize a chunk leaf: dense -> (codes, None); a KVQ-style (codes,
    scales) pair passes through."""
    if isinstance(arr, tuple):
        q, s = arr
        return _Leaf(q), _Leaf(s)
    return _Leaf(arr), None


def encode_kv_blob(export: dict) -> bytes:
    """Serialize one prefill export.

    ``export`` holds ``token_ids`` (covered prompt ids), ``chunk_tokens``
    (C), and ``chunks`` — per prefill chunk a dict with ``k``/``v`` leaves
    (a CPU tensor or ndarray, or ``(codes, scales)`` for KVQ) and optional
    ``logits`` (f32 [vocab]).
    """
    chunks = export["chunks"]
    if not chunks:
        raise KVTransferFormatError("empty export: nothing to ship")
    k0, s0 = _leaf_pair(chunks[0]["k"])
    layout = "kvq" if s0 is not None else "dense"
    header = {
        "version": 1,
        "layout": layout,
        "dtype": k0.name,
        "chunk_tokens": int(export["chunk_tokens"]),
        "n_chunks": len(chunks),
        "token_ids": [int(t) for t in export["token_ids"]],
        "k_shape": list(k0.shape),
        "logits": [],
        "vocab": 0,
    }
    if layout == "kvq":
        header["scale_dtype"] = s0.name
        header["s_shape"] = list(s0.shape)
    body = bytearray()
    for ch in chunks:
        logits = ch.get("logits")
        header["logits"].append(logits is not None)
        for leaf in (ch["k"], ch["v"]):
            q, s = _leaf_pair(leaf)
            if (s is not None) != (layout == "kvq"):
                raise KVTransferFormatError("mixed dense/kvq leaves in one export")
            if list(q.shape) != header["k_shape"]:
                raise KVTransferFormatError(
                    f"ragged chunk shape {q.shape} vs {header['k_shape']}"
                )
            body += q.data
            if s is not None:
                body += s.data
        if logits is not None:
            lg = np.ascontiguousarray(logits, dtype=np.float32).reshape(-1)
            header["vocab"] = int(lg.shape[0])
            body += lg.tobytes()
    hdr = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    return MAGIC + struct.pack("<I", len(hdr)) + hdr + bytes(body)


def decode_kv_blob(blob: bytes) -> dict:
    """Parse a blob back into the export dict shape (ndarray leaves, bf16
    tensors; KVQ chunks come back as ``(codes, scales)`` pairs).
    Raises :class:`KVTransferFormatError` on any malformed input; the
    host tier's fetch counts that as a miss rather than importing garbage
    KV."""
    if len(blob) < len(MAGIC) + 4 or blob[: len(MAGIC)] != MAGIC:
        raise KVTransferFormatError("bad magic: not a KV transfer blob")
    (hlen,) = struct.unpack_from("<I", blob, len(MAGIC))
    off = len(MAGIC) + 4
    if hlen > _MAX_HEADER_BYTES or off + hlen > len(blob):
        raise KVTransferFormatError("header length out of range")
    try:
        header = json.loads(blob[off : off + hlen])
    except ValueError as e:
        raise KVTransferFormatError(f"unparseable header: {e}") from e
    off += hlen
    if header.get("version") != 1:
        raise KVTransferFormatError(f"unknown version {header.get('version')!r}")
    layout = header["layout"]
    if layout not in ("dense", "kvq"):
        raise KVTransferFormatError(f"unknown layout {layout!r}")
    k_shape = tuple(header["k_shape"])
    dtype = header["dtype"]
    leaf_bytes = int(np.prod(k_shape)) * _itemsize(dtype)
    if layout == "kvq":
        s_shape = tuple(header["s_shape"])
        s_dtype = header["scale_dtype"]
        scale_bytes = int(np.prod(s_shape)) * _itemsize(s_dtype)
    vocab = int(header.get("vocab", 0))

    def take(n: int) -> bytes:
        nonlocal off
        if off + n > len(blob):
            raise KVTransferFormatError("truncated body")
        out = blob[off : off + n]
        off += n
        return out

    chunks = []
    for has_logits in header["logits"]:
        ch: dict = {}
        for name in ("k", "v"):
            q = _from_bytes(take(leaf_bytes), dtype, k_shape)
            if layout == "kvq":
                s = _from_bytes(take(scale_bytes), s_dtype, s_shape)
                ch[name] = (q, s)
            else:
                ch[name] = q
        if has_logits:
            if vocab <= 0:
                raise KVTransferFormatError("logits flagged but vocab missing")
            ch["logits"] = np.frombuffer(
                take(vocab * 4), dtype=np.float32
            ).reshape(vocab)
        else:
            ch["logits"] = None
        chunks.append(ch)
    if len(chunks) != int(header["n_chunks"]):
        raise KVTransferFormatError("chunk count mismatch")
    if off != len(blob):
        raise KVTransferFormatError(f"{len(blob) - off} trailing bytes")
    return {
        "token_ids": list(header["token_ids"]),
        "chunk_tokens": int(header["chunk_tokens"]),
        "chunks": chunks,
    }
