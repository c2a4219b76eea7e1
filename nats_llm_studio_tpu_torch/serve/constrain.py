"""JSON-schema constrained decoding: schema -> character NFA -> lazy DFA ->
per-state token-vocabulary masks.

Copy of ``nats_llm_studio_tpu/serve/constrain.py`` (numpy only).

The gateway accepts OpenAI's ``response_format: {"type": "json_schema"}``;
this module turns the schema into a :class:`TokenDFA` whose per-state boolean
masks the batcher uploads as a per-step logit mask (Outlines/XGrammar line of
work). Everything is in-tree — no regex/automata dependency:

* a JSON-schema subset compiles into a Thompson NFA via combinators
  (no intermediate regex string to mis-parse): objects with properties in
  declaration order, strings, integers, numbers, booleans, null, enum/const,
  bounded arrays, anyOf/oneOf
* the DFA is the lazy subset construction over the NFA, memoized per
  (state-set, character) — character classes may be negated, so the
  alphabet is discovered from token walks instead of enumerated
* :class:`TokenDFA` walks every vocabulary token's surface string through
  the DFA once per visited state and caches the resulting [vocab] bool mask;
  EOS/stop tokens are allowed only at accepting states

The emitted language is *canonical tight JSON* (no whitespace between
tokens): constrained output is parseable and schema-valid by construction,
and the DFA stays small. Multi-byte/partial-UTF-8 byte-fallback tokens are
excluded from masks (a constrained stream can still emit any ASCII JSON).
"""

from __future__ import annotations

import json
import os
from typing import Iterable

import numpy as np

__all__ = [
    "ConstraintError",
    "TokenDFA",
    "compile_token_dfa",
    "enabled",
    "token_strings",
    "validate_response_format",
]


def enabled() -> bool:
    """``CONSTRAIN=0`` is the operator off-switch: constrained requests are
    rejected up front instead of entering the single-step ext decode regime
    (which trades batcher throughput for schema guarantees)."""
    return os.environ.get("CONSTRAIN", "").strip().lower() not in (
        "0", "false", "off",
    )

# guard rails: schemas compiling past these bounds are rejected up front
# (the DFA walk is per-token per-state — unbounded blowup would stall the
# engine thread, not just this request)
_MAX_NFA_STATES = 20_000
_MAX_DFA_STATES = 20_000
_MAX_REPEAT = 64
# canonical JSON string contents: anything except the quote, the backslash,
# and raw control characters (escapes are not generated — tight JSON without
# them is still schema-valid)
_STRING_BANNED = frozenset('"\\') | frozenset(chr(c) for c in range(0x20))


class ConstraintError(ValueError):
    """Schema rejected: unsupported construct or compiled automaton too big."""


# -- Thompson NFA via combinators -------------------------------------------
#
# Fragments are (start, accepts) over a shared transition table. Transitions:
#   eps[s]   -> list of epsilon successor states
#   edges[s] -> list of ((negate, charset), successor)


class _NFA:
    def __init__(self) -> None:
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[tuple[bool, frozenset], int]]] = []

    def state(self) -> int:
        if len(self.eps) >= _MAX_NFA_STATES:
            raise ConstraintError(
                f"schema too complex: > {_MAX_NFA_STATES} NFA states"
            )
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    # fragments ----------------------------------------------------------

    def char(self, chars: Iterable[str], negate: bool = False):
        a, b = self.state(), self.state()
        self.edges[a].append(((negate, frozenset(chars)), b))
        return a, b

    def lit(self, text: str):
        a = self.state()
        cur = a
        for ch in text:
            nxt = self.state()
            self.edges[cur].append(((False, frozenset((ch,))), nxt))
            cur = nxt
        return a, cur

    def seq(self, *frags):
        if not frags:
            a = self.state()
            return a, a
        start, end = frags[0]
        for s, e in frags[1:]:
            self.eps[end].append(s)
            end = e
        return start, end

    def alt(self, *frags):
        a, b = self.state(), self.state()
        for s, e in frags:
            self.eps[a].append(s)
            self.eps[e].append(b)
        return a, b

    def opt(self, frag):
        s, e = frag
        self.eps[s].append(e)
        return s, e

    def star(self, frag):
        s, e = frag
        a, b = self.state(), self.state()
        self.eps[a] += [s, b]
        self.eps[e] += [s, b]
        return a, b

    def plus(self, frag):
        s, e = frag
        self.eps[e].append(s)
        return s, e

    def repeat(self, make_frag, lo: int, hi: int):
        """``make_frag()`` repeated between lo and hi times (fresh states per
        copy — fragments cannot be reused once wired)."""
        if hi > _MAX_REPEAT:
            raise ConstraintError(f"repetition bound {hi} > {_MAX_REPEAT}")
        frags = [make_frag() for _ in range(lo)]
        frags += [self.opt(make_frag()) for _ in range(hi - lo)]
        return self.seq(*frags) if frags else self.seq()


# -- JSON-schema subset -> NFA fragment --------------------------------------


def _string_frag(n: _NFA, schema: dict):
    body = n.star(n.char(_STRING_BANNED, negate=True))
    return n.seq(n.lit('"'), body, n.lit('"'))


def _integer_frag(n: _NFA, schema: dict):
    nonzero = n.seq(
        n.char("123456789"),
        n.repeat(lambda: n.char("0123456789"), 0, 17),
    )
    return n.seq(n.opt(n.lit("-")), n.alt(n.lit("0"), nonzero))


def _number_frag(n: _NFA, schema: dict):
    frac = n.seq(n.lit("."), n.plus(n.char("0123456789")))
    exp = n.seq(
        n.char("eE"), n.opt(n.char("+-")), n.repeat(lambda: n.char("0123456789"), 1, 3)
    )
    return n.seq(_integer_frag(n, schema), n.opt(frac), n.opt(exp))


def _enum_frag(n: _NFA, values):
    if not values:
        raise ConstraintError("enum must be non-empty")
    frags = []
    for v in values:
        try:
            frags.append(n.lit(json.dumps(v, separators=(",", ":"))))
        except TypeError as e:  # non-JSON value in the schema
            raise ConstraintError(f"enum value not JSON-serializable: {v!r}") from e
    return n.alt(*frags)


def _array_frag(n: _NFA, schema: dict, depth: int):
    items = schema.get("items") or {}
    lo = int(schema.get("minItems", 0))
    hi = int(schema.get("maxItems", 8))
    if not (0 <= lo <= hi):
        raise ConstraintError(f"bad array bounds minItems={lo} maxItems={hi}")
    if hi == 0:
        return n.lit("[]")
    first = _schema_frag(n, items, depth)
    rest = n.repeat(
        lambda: n.seq(n.lit(","), _schema_frag(n, items, depth)),
        max(lo - 1, 0), hi - 1,
    )
    body = n.seq(first, rest)
    if lo == 0:
        body = n.opt(body)
    return n.seq(n.lit("["), body, n.lit("]"))


def _object_frag(n: _NFA, schema: dict, depth: int):
    props = schema.get("properties") or {}
    if not isinstance(props, dict):
        raise ConstraintError("'properties' must be an object")
    if not props:
        # generic object: bounded string->value members
        member = lambda: n.seq(  # noqa: E731 — tiny local factory
            _string_frag(n, {}), n.lit(":"), _value_frag(n, depth - 1)
        )
        body = n.opt(n.seq(member(), n.repeat(
            lambda: n.seq(n.lit(","), member()), 0, 8,
        )))
        return n.seq(n.lit("{"), body, n.lit("}"))
    # canonical form: every declared property present, declaration order —
    # the DFA needs one fixed member order, and requiring all of them keeps
    # optional-member combinatorics out of the automaton
    frags = [n.lit("{")]
    for i, (key, sub) in enumerate(props.items()):
        if i:
            frags.append(n.lit(","))
        frags.append(n.lit(json.dumps(str(key)) + ":"))
        frags.append(_schema_frag(n, sub if isinstance(sub, dict) else {}, depth))
    frags.append(n.lit("}"))
    return n.seq(*frags)


def _value_frag(n: _NFA, depth: int):
    """Generic JSON value, nesting bounded at ``depth`` (DFAs cannot count
    unbounded nesting; a bounded approximation keeps output parseable)."""
    scalars = [
        _string_frag(n, {}),
        _number_frag(n, {}),
        n.lit("true"), n.lit("false"), n.lit("null"),
    ]
    if depth <= 0:
        return n.alt(*scalars)
    return n.alt(
        *scalars,
        _object_frag(n, {}, depth - 1),
        _array_frag(n, {"items": {}}, depth - 1),
    )


def _schema_frag(n: _NFA, schema: dict, depth: int = 2):
    if not isinstance(schema, dict):
        raise ConstraintError(f"schema must be an object, got {type(schema).__name__}")
    if "const" in schema:
        return _enum_frag(n, [schema["const"]])
    if "enum" in schema:
        return _enum_frag(n, schema["enum"])
    for key in ("anyOf", "oneOf"):
        if key in schema:
            subs = schema[key]
            if not isinstance(subs, list) or not subs:
                raise ConstraintError(f"'{key}' must be a non-empty array")
            return n.alt(*[_schema_frag(n, s, depth) for s in subs])
    t = schema.get("type")
    if isinstance(t, list):
        return n.alt(*[_schema_frag(n, {**schema, "type": ti}, depth) for ti in t])
    if t == "object" or (t is None and "properties" in schema):
        return _object_frag(n, schema, depth)
    if t == "string":
        return _string_frag(n, schema)
    if t == "integer":
        return _integer_frag(n, schema)
    if t == "number":
        return _number_frag(n, schema)
    if t == "boolean":
        return n.alt(n.lit("true"), n.lit("false"))
    if t == "null":
        return n.lit("null")
    if t == "array":
        return _array_frag(n, schema, depth)
    if t is None:
        return _value_frag(n, depth)
    raise ConstraintError(f"unsupported schema type: {t!r}")


# -- lazy subset-construction DFA --------------------------------------------


class _DFA:
    """Subset construction over the NFA, built lazily: transitions are
    memoized per (state, char) because negated character classes make the
    alphabet effectively unbounded. State 0 is the start; ``None`` is the
    dead state."""

    def __init__(self, nfa: _NFA, start: int, accept: int):
        self._nfa = nfa
        self._accept = accept
        self._ids: dict[frozenset, int] = {}
        self._sets: list[frozenset] = []
        self._trans: dict[tuple[int, str], int | None] = {}
        self.start = self._intern(self._closure({start}))

    def _closure(self, states: set) -> frozenset:
        stack, seen = list(states), set(states)
        eps = self._nfa.eps
        while stack:
            s = stack.pop()
            for t in eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    def _intern(self, sset: frozenset) -> int:
        sid = self._ids.get(sset)
        if sid is None:
            if len(self._sets) >= _MAX_DFA_STATES:
                raise ConstraintError(
                    f"schema too complex: > {_MAX_DFA_STATES} DFA states"
                )
            sid = len(self._sets)
            self._ids[sset] = sid
            self._sets.append(sset)
        return sid

    def step(self, sid: int, ch: str) -> int | None:
        key = (sid, ch)
        hit = self._trans.get(key, _MISS)
        if hit is not _MISS:
            return hit
        nxt: set[int] = set()
        edges = self._nfa.edges
        for s in self._sets[sid]:
            for (negate, chars), t in edges[s]:
                if (ch in chars) != negate:
                    nxt.add(t)
        out = self._intern(self._closure(nxt)) if nxt else None
        self._trans[key] = out
        return out

    def accepting(self, sid: int) -> bool:
        return self._accept in self._sets[sid]


_MISS = object()


# -- vocabulary surface strings ----------------------------------------------


def token_strings(tokenizer, vocab_size: int) -> list:
    """Per-token-id surface string, or None for tokens a constrained stream
    must never emit (control tokens, partial-UTF-8 byte fallbacks). Handles
    the GGUF llama/gpt2 families precisely and falls back to per-id
    ``decode`` for anything else (test fakes, external tokenizers)."""
    model = getattr(tokenizer, "model", None)
    tokens = getattr(tokenizer, "tokens", None)
    out: list = [None] * vocab_size
    n = min(vocab_size, len(tokens) if tokens is not None else vocab_size)
    control = getattr(tokenizer, "_control_ids", frozenset())
    if tokens is not None and model == "llama":
        for i in range(n):
            if i in control:
                continue
            t = tokens[i]
            if t.startswith("<0x") and t.endswith(">") and len(t) == 6:
                b = int(t[3:-1], 16)
                out[i] = chr(b) if 0x20 <= b < 0x7F else None
            else:
                out[i] = t.replace("▁", " ")
        return out
    if tokens is not None and model == "gpt2":
        u2b = getattr(tokenizer, "_u2b", {})
        for i in range(n):
            if i in control:
                continue
            buf = bytearray()
            for ch in tokens[i]:
                b = u2b.get(ch)
                if b is not None:
                    buf.append(b)
                else:
                    buf.extend(ch.encode("utf-8"))
            try:
                out[i] = buf.decode("utf-8")
            except UnicodeDecodeError:
                out[i] = None  # partial multi-byte sequence
        return out
    if tokens is not None:
        for i in range(n):
            out[i] = tokens[i] if i not in control else None
        return out
    dec = getattr(tokenizer, "decode", None)
    if dec is None:
        raise ConstraintError("tokenizer exposes neither .tokens nor .decode")
    for i in range(n):
        try:
            out[i] = dec([i])
        except Exception:  # noqa: BLE001 — odd ids stay banned
            out[i] = None
    return out


# -- token-level DFA ----------------------------------------------------------


class TokenDFA:
    """Character DFA lifted to the token vocabulary.

    ``mask(state)`` is a cached [vocab] bool array: token allowed iff its
    whole surface string transitions without hitting the dead state (ending
    mid-pattern is fine — later tokens continue the walk). EOS/stop ids are
    allowed exactly at accepting states, so generation can only end on a
    complete schema-valid document."""

    def __init__(self, dfa: _DFA, strings: list, vocab_size: int,
                 eos_ids: frozenset):
        self._dfa = dfa
        self._strings = strings
        self.vocab_size = vocab_size
        self.eos_ids = frozenset(i for i in eos_ids if 0 <= i < vocab_size)
        self.start = dfa.start
        self._masks: dict[int, np.ndarray] = {}
        # token walk memo: (state, token_id) -> end state (None = banned)
        self._walk: dict[tuple[int, int], int | None] = {}

    def _walk_token(self, state: int, tid: int) -> int | None:
        key = (state, tid)
        hit = self._walk.get(key, _MISS)
        if hit is not _MISS:
            return hit
        s = self._strings[tid]
        out: int | None
        if s is None or s == "":
            out = None
        else:
            cur: int | None = state
            for ch in s:
                cur = self._dfa.step(cur, ch)
                if cur is None:
                    break
            out = cur
        self._walk[key] = out
        return out

    def mask(self, state: int) -> np.ndarray:
        m = self._masks.get(state)
        if m is not None:
            return m
        m = np.zeros(self.vocab_size, dtype=bool)
        for tid in range(self.vocab_size):
            if self._walk_token(state, tid) is not None:
                m[tid] = True
        if self._dfa.accepting(state):
            for e in self.eos_ids:
                m[e] = True
        self._masks[state] = m
        return m

    def advance(self, state: int, tid: int) -> int | None:
        """Next DFA state after emitting token ``tid`` (None = the token was
        not allowed — callers treat this as a terminal condition)."""
        if tid in self.eos_ids:
            return state if self._dfa.accepting(state) else None
        return self._walk_token(state, tid)

    def accepting(self, state: int) -> bool:
        return self._dfa.accepting(state)

    def live(self, state: int) -> bool:
        """Any token (or EOS) allowed from here? False = the stream must
        end now with whatever finish reason the caller chooses."""
        return bool(self.mask(state).any())


# compile cache: the vocab walk is the expensive part (O(vocab x token_len)
# per visited DFA state), and agents re-send the same schema every call
_CACHE: dict[tuple[int, str, int], TokenDFA] = {}
_CACHE_MAX = 32


def compile_token_dfa(schema, tokenizer, vocab_size: int,
                      eos_ids: Iterable[int] = ()) -> TokenDFA:
    """Compile a JSON schema into a :class:`TokenDFA` for ``tokenizer``.

    Raises :class:`ConstraintError` for unsupported/over-complex schemas —
    callers map that to a 400, never a retryable envelope."""
    try:
        canon = json.dumps(schema, sort_keys=True, separators=(",", ":"))
    except TypeError as e:
        raise ConstraintError(f"schema is not JSON-serializable: {e}") from e
    key = (id(tokenizer), canon, int(vocab_size))
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    nfa = _NFA()
    start, end = _schema_frag(nfa, schema if isinstance(schema, dict) else {})
    dfa = _DFA(nfa, start, end)
    strings = token_strings(tokenizer, vocab_size)
    tdfa = TokenDFA(dfa, strings, vocab_size, frozenset(eos_ids))
    # smoke-check: a schema whose start state allows nothing can never
    # produce a token — reject at compile time, not mid-decode
    if not tdfa.live(tdfa.start):
        raise ConstraintError(
            "schema compiles to an empty language for this vocabulary"
        )
    if len(_CACHE) >= _CACHE_MAX:
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = tdfa
    return tdfa


# -- response_format validation (shared by gateway and engine) ---------------


def validate_response_format(rf) -> dict | None:
    """Structural check of an OpenAI ``response_format`` value. Returns the
    schema dict for constrained modes (``{}`` means "any JSON object"),
    None when no constraint applies. Raises ValueError with a client-facing
    message for garbled values — the gateway turns that into a 400 WITHOUT
    touching the batcher."""
    if rf is None:
        return None
    if not isinstance(rf, dict):
        raise ValueError("response_format must be an object")
    t = rf.get("type")
    if t in (None, "text"):
        return None
    if t == "json_object":
        return {}
    if t != "json_schema":
        raise ValueError(
            f"response_format.type must be 'text', 'json_object' or "
            f"'json_schema', got {t!r}"
        )
    js = rf.get("json_schema")
    if not isinstance(js, dict):
        raise ValueError("response_format.json_schema must be an object")
    schema = js.get("schema")
    if not isinstance(schema, dict):
        raise ValueError("response_format.json_schema.schema must be an object")
    return schema
