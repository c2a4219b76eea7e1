"""Tokenizers reconstructed from GGUF metadata.

Preserves the reference's "everything ships in the .gguf" property
(SURVEY.md §2.2): the vocab, merges, and scores are read from the file's
``tokenizer.ggml.*`` keys — no external tokenizer download. Two families:

- ``llama``  : SentencePiece-style BPE driven by per-token scores
               (Llama-2, Mistral/Mixtral, Granite-7b lineage)
- ``gpt2``   : byte-level BPE driven by ranked merges
               (Llama-3, Granite-3.x, GPT-2 lineage)
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Iterable

from .constants import (
    KEY_TOKENIZER_ADD_BOS,
    KEY_TOKENIZER_BOS,
    KEY_TOKENIZER_EOS,
    KEY_TOKENIZER_MERGES,
    KEY_TOKENIZER_MODEL,
    KEY_TOKENIZER_SCORES,
    KEY_TOKENIZER_TOKENS,
    KEY_TOKENIZER_TYPES,
    TokenType,
)

try:  # proper \p{L}/\p{N} classes for byte-level BPE pretokenization
    import regex as _re

    _HAVE_REGEX = True
except ImportError:  # pragma: no cover
    import re as _re  # type: ignore[no-redef]

    _HAVE_REGEX = False

_SPIECE = "▁"  # ▁

# llama-3 style pretokenizer (also a good default for gpt2-family vocabs)
_BPE_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_BPE_PATTERN_ASCII = (  # fallback when `regex` is unavailable
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\w\d]?[^\W\d_]+|\d{1,3}"
    r"| ?[^\s\w\d]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_PIECE_CACHE_MAX = 1 << 16  # pieces a gpt2 tokenizer remembers the ids of


@lru_cache(maxsize=1)
def _byte_to_unicode() -> dict[int, str]:
    """GPT-2's invertible byte <-> printable-unicode mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


class GGUFTokenizer:
    """Encode/decode against a GGUF-embedded vocabulary."""

    def __init__(
        self,
        model: str,
        tokens: list[str],
        scores: list[float] | None = None,
        token_types: list[int] | None = None,
        merges: list[str] | None = None,
        bos_id: int | None = None,
        eos_id: int | None = None,
        add_bos: bool = True,
    ):
        if model not in ("llama", "gpt2"):
            raise NotImplementedError(
                f"tokenizer model {model!r} not supported (llama/gpt2 families only)"
            )
        self.model = model
        self.tokens = tokens
        self.scores = scores or []
        self.token_types = token_types or []
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.add_bos = add_bos
        self.vocab: dict[str, int] = {t: i for i, t in enumerate(tokens)}
        self._byte_tokens: dict[int, int] = {}  # byte value -> token id (SPM <0xXX>)
        if token_types:
            for i, tt in enumerate(token_types):
                if tt == TokenType.BYTE:
                    s = tokens[i]
                    if s.startswith("<0x") and s.endswith(">"):
                        self._byte_tokens[int(s[3:-1], 16)] = i
        self.merge_ranks: dict[tuple[str, str], int] = {}
        for rank, m in enumerate(merges or []):
            a, _, b = m.partition(" ")
            self.merge_ranks[(a, b)] = rank
        if model == "gpt2":
            self._b2u = _byte_to_unicode()
            self._u2b = {c: b for b, c in self._b2u.items()}
            pat = _BPE_PATTERN if _HAVE_REGEX else _BPE_PATTERN_ASCII
            self._pre = _re.compile(pat)
            # pre-tokenized piece -> ids: words recur, and their merge loop
            # dominates a long prompt's encode (it runs on the event loop)
            self._piece_ids: dict[str, list[int]] = {}
        self._control_ids = {
            i for i, tt in enumerate(token_types or []) if tt == TokenType.CONTROL
        }
        self.unk_id: int | None = next(
            (i for i, tt in enumerate(token_types or []) if tt == TokenType.UNKNOWN),
            self.vocab.get("<unk>"),
        )

    # -- construction -------------------------------------------------------

    @classmethod
    def from_metadata(cls, md: dict[str, Any]) -> "GGUFTokenizer":
        return cls(
            model=str(md.get(KEY_TOKENIZER_MODEL, "gpt2")),
            tokens=list(md[KEY_TOKENIZER_TOKENS]),
            scores=md.get(KEY_TOKENIZER_SCORES),
            token_types=md.get(KEY_TOKENIZER_TYPES),
            merges=md.get(KEY_TOKENIZER_MERGES),
            bos_id=md.get(KEY_TOKENIZER_BOS),
            eos_id=md.get(KEY_TOKENIZER_EOS),
            add_bos=bool(md.get(KEY_TOKENIZER_ADD_BOS, True)),
        )

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # -- encoding -----------------------------------------------------------

    def encode(self, text: str, add_bos: bool | None = None) -> list[int]:
        ids = self._encode_spm(text) if self.model == "llama" else self._encode_bpe(text)
        use_bos = self.add_bos if add_bos is None else add_bos
        if use_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def _encode_spm(self, text: str) -> list[int]:
        if not text:
            return []
        text = _SPIECE + text.replace(" ", _SPIECE)
        # seed with single characters (byte-fallback for unknowns)
        pieces: list[str] = list(text)
        ids: list[int] = []
        pieces = self._merge_by_score(pieces)
        for p in pieces:
            tid = self.vocab.get(p)
            if tid is not None:
                ids.append(tid)
                continue
            for byte in p.encode("utf-8"):
                bid = self._byte_tokens.get(byte)
                if bid is not None:
                    ids.append(bid)
                elif self.unk_id is not None:  # SentencePiece semantics
                    ids.append(self.unk_id)
        return ids

    def _merge_by_score(self, pieces: list[str]) -> list[str]:
        """Greedy SentencePiece BPE via a bigram heap: O(L log L) instead of
        rescanning every pair per merge (the prompt-encode hot path feeds
        TTFT, SURVEY.md §7 hard part #1)."""
        import heapq

        text = list(pieces)  # symbol table; consumed entries become ""
        prev = list(range(-1, len(text) - 1))
        nxt = list(range(1, len(text) + 1))

        heap: list[tuple[float, int, int, str]] = []

        def push(i: int, j: int) -> None:
            if i < 0 or j >= len(text):
                return
            cand = text[i] + text[j]
            tid = self.vocab.get(cand)
            if tid is not None and tid < len(self.scores):
                heapq.heappush(heap, (-self.scores[tid], i, j, cand))

        for i in range(len(text) - 1):
            push(i, i + 1)

        while heap:
            _, i, j, cand = heapq.heappop(heap)
            if text[i] + text[j] != cand or not text[i] or not text[j]:
                continue  # stale entry: one side already merged away
            text[i] = cand
            text[j] = ""
            nxt[i] = nxt[j]
            if nxt[j] < len(text):
                prev[nxt[j]] = i
            push(prev[i], i)
            push(i, nxt[i])
        return [t for t in text if t]

    def _encode_bpe(self, text: str) -> list[int]:
        ids: list[int] = []
        cache = self._piece_ids
        for piece in self._pre.findall(text):
            got = cache.get(piece)
            if got is None:
                mapped = "".join(self._b2u[b] for b in piece.encode("utf-8"))
                got = [tid for tid in map(self.vocab.get, self._bpe_merge(mapped))
                       if tid is not None]
                if len(cache) < _PIECE_CACHE_MAX:
                    cache[piece] = got
            ids.extend(got)
        return ids

    def _bpe_merge(self, word: str) -> Iterable[str]:
        parts = list(word)
        while len(parts) > 1:
            ranked = [
                (self.merge_ranks.get((parts[i], parts[i + 1])), i)
                for i in range(len(parts) - 1)
            ]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            _, i = min(ranked)
            parts = parts[:i] + [parts[i] + parts[i + 1]] + parts[i + 2 :]
        return parts

    # -- decoding -----------------------------------------------------------

    def decode(self, ids: Iterable[int], skip_control: bool = True) -> str:
        if self.model == "llama":
            out: list[bytes] = []
            for i in ids:
                if skip_control and i in self._control_ids:
                    continue
                tok = self.tokens[i]
                if tok.startswith("<0x") and tok.endswith(">") and len(tok) == 6:
                    out.append(bytes([int(tok[3:-1], 16)]))
                else:
                    out.append(tok.replace(_SPIECE, " ").encode("utf-8"))
            text = b"".join(out).decode("utf-8", errors="replace")
            return text[1:] if text.startswith(" ") else text
        # gpt2: unicode chars map back to bytes
        buf = bytearray()
        for i in ids:
            if skip_control and i in self._control_ids:
                continue
            for ch in self.tokens[i]:
                b = self._u2b.get(ch)
                if b is not None:
                    buf.append(b)
                else:
                    buf.extend(ch.encode("utf-8"))
        return buf.decode("utf-8", errors="replace")
