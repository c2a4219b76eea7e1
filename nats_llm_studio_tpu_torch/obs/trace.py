"""Request-scoped trace context: one id, one monotonic timestamp per stage.

Copy of ``nats_llm_studio_tpu/obs/trace.py`` (``Trace``, ``Span``,
``new_trace_id``, ``new_span_id``, ``parse_span_context``,
``span_context_value``, ``STAGES``), whole.

A chat request's life is enqueue → admit dispatch → prefill → first token
→ decode → publish; the trace rides the request object through the worker
and the batcher owner thread, each layer stamping the stage it completes.
The report is returned in the response ``stats`` block, so one
``nats req lmstudio.chat_model`` shows the full latency waterfall with no
extra round-trip (and no clock-sync problem: every mark comes from the
same host's monotonic clock).

Marks are first-write-wins: a stage is stamped where it first completes,
and re-marking (e.g. a retry path crossing the same site) cannot move an
already-recorded timestamp backwards.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

# canonical stage order for the waterfall; unknown stages append after
STAGES = ("recv", "enqueue", "admit", "prefill", "first_token", "decode_done", "publish")


def new_trace_id() -> str:
    return os.urandom(8).hex()


def new_span_id() -> str:
    return os.urandom(4).hex()


def span_context_value(trace_id: str, span_id: str) -> str:
    """Render a W3C traceparent-style header value (``00-<trace>-<span>-01``)
    carrying the caller's span as parent context for the next hop."""
    return f"00-{trace_id}-{span_id}-01"


def parse_span_context(value: str | None) -> tuple[str, str] | None:
    """Parse a traceparent-style value into ``(trace_id, span_id)``;
    anything malformed returns ``None`` rather than raising — a bad
    header must never fail the request it rode in on."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, _ = parts
    if not trace_id or not span_id:
        return None
    return trace_id, span_id


@dataclass
class Span:
    """One hop of a cross-process trace, assembled fleet-side by trace_id.

    ``t0``/``t1`` are wall-clock seconds (``time.time()``) — unlike the
    in-process waterfall marks, spans cross host/process boundaries where
    monotonic clocks don't compare; the assembled tree orders children by
    ``t0`` and tolerates modest clock skew because causality comes from
    the parent links, not the timestamps.
    """

    trace_id: str
    span_id: str
    stage: str  # "gateway.request" | "router.attempt" | "worker.serve" | ...
    worker_id: str = ""
    parent_span_id: str = ""
    t0: float = 0.0
    t1: float = 0.0
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "stage": self.stage,
            "worker_id": self.worker_id,
            "parent_span_id": self.parent_span_id,
            "t0": round(self.t0, 6),
            "t1": round(self.t1, 6),
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span | None":
        if not isinstance(d, dict):
            return None
        trace_id, span_id = d.get("trace_id"), d.get("span_id")
        if not isinstance(trace_id, str) or not isinstance(span_id, str):
            return None
        if not trace_id or not span_id:
            return None
        attrs = d.get("attrs")
        return cls(
            trace_id=trace_id,
            span_id=span_id,
            stage=str(d.get("stage", "")),
            worker_id=str(d.get("worker_id", "")),
            parent_span_id=str(d.get("parent_span_id", "")),
            t0=float(d.get("t0", 0.0) or 0.0),
            t1=float(d.get("t1", 0.0) or 0.0),
            attrs=attrs if isinstance(attrs, dict) else {},
        )


class Trace:
    __slots__ = ("trace_id", "attempt", "span_id", "parent_span_id",
                 "t0_wall", "_marks", "_lock")

    def __init__(self, trace_id: str | None = None, attempt: int | None = None,
                 parent_span_id: str = ""):
        self.trace_id = trace_id or new_trace_id()
        # retry attempt number (1-based) stamped from the X-Attempt
        # header: one trace id spans all attempts of a retried request,
        # so the attempt tag is what tells the spans apart
        self.attempt = attempt
        # every trace doubles as one span of the cross-process tree: the
        # hop that created it minted span_id, the upstream hop's span id
        # arrives in the Traceparent header as parent_span_id
        self.span_id = new_span_id()
        self.parent_span_id = parent_span_id
        self.t0_wall = time.time()
        self._marks: dict[str, float] = {}
        self._lock = threading.Lock()

    def to_span(self, stage: str, worker_id: str = "",
                attrs: dict | None = None) -> dict:
        """Close this trace's span now and return its wire dict."""
        return Span(
            trace_id=self.trace_id,
            span_id=self.span_id,
            stage=stage,
            worker_id=worker_id,
            parent_span_id=self.parent_span_id,
            t0=self.t0_wall,
            t1=time.time(),
            attrs=attrs or {},
        ).to_dict()

    def mark(self, stage: str, t: float | None = None) -> None:
        """Stamp ``stage`` at monotonic time ``t`` (now if omitted); the
        first mark for a stage wins. Safe from any thread — the worker's
        asyncio loop and the batcher owner thread stamp the same trace."""
        if t is None:
            t = time.monotonic()
        with self._lock:
            self._marks.setdefault(stage, t)

    def marks(self) -> dict[str, float]:
        with self._lock:
            return dict(self._marks)

    def report(self) -> dict:
        """``{trace_id, spans_ms, marks_ms}``: per-stage durations between
        consecutive *recorded* stages (absent stages are skipped, so a
        fake engine without batcher marks still reports queue → publish),
        plus each mark's offset from the first."""
        marks = self.marks()
        ordered = [(s, marks[s]) for s in STAGES if s in marks]
        ordered += sorted(
            ((s, t) for s, t in marks.items() if s not in STAGES), key=lambda x: x[1]
        )
        spans: dict[str, float] = {}
        offsets: dict[str, float] = {}
        if ordered:
            t0 = ordered[0][1]
            for stage, t in ordered:
                offsets[stage] = round(max(0.0, t - t0) * 1e3, 3)
            span_edges = {
                "queue_ms": ("enqueue", "admit"),
                "prefill_ms": ("admit", "prefill"),
                "first_token_ms": ("prefill", "first_token"),
                "decode_ms": ("first_token", "decode_done"),
                "publish_ms": ("decode_done", "publish"),
            }
            for name, (a, b) in span_edges.items():
                if a in marks and b in marks:
                    spans[name] = round(max(0.0, marks[b] - marks[a]) * 1e3, 3)
            spans["total_ms"] = round(max(0.0, ordered[-1][1] - t0) * 1e3, 3)
        out = {"trace_id": self.trace_id, "spans_ms": spans, "marks_ms": offsets}
        if self.attempt is not None:
            out["attempt"] = self.attempt
        # span linkage: lets a flight-recorder dump (which embeds this
        # report) be joined to the assembled cluster trace
        out["span_id"] = self.span_id
        if self.parent_span_id:
            out["parent_span_id"] = self.parent_span_id
        return out
