"""Observability: bounded histograms, the event ring, request traces,
Prometheus exposition and the flight recorder.

Copies of the jax-free modules of ``nats_llm_studio_tpu/obs/``:
``histogram.py`` (``LogHistogram``, ``HistSnapshot``), ``events.py``
(``EventRing``, ``EVENTS``, ``emit``), ``trace.py`` (``Trace``, ``Span``,
span context), ``prom.py`` (``PromRenderer``) and ``recorder.py``
(``FlightRecorder``). The fleet aggregator, the XLA compile-cache listener
and the roofline ledger are not ported yet.
"""

from .events import EVENTS, EventRing, emit
from .histogram import HistSnapshot, LogHistogram
from .prom import PromRenderer
from .recorder import FlightRecorder
from .trace import (
    STAGES,
    Span,
    Trace,
    new_span_id,
    new_trace_id,
    parse_span_context,
    span_context_value,
)

__all__ = [
    "EVENTS",
    "EventRing",
    "emit",
    "HistSnapshot",
    "LogHistogram",
    "PromRenderer",
    "FlightRecorder",
    "STAGES",
    "Span",
    "Trace",
    "new_span_id",
    "new_trace_id",
    "parse_span_context",
    "span_context_value",
]
