"""Observability: bounded histograms, the event ring, request traces,
Prometheus exposition, the flight recorder, the efficiency plane and the
fleet aggregator.

Copies of the jax-free modules of ``nats_llm_studio_tpu/obs/``:
``histogram.py`` (``LogHistogram``, ``HistSnapshot``, the cross-worker
``merge`` helpers), ``events.py`` (``EventRing``, ``EVENTS``, ``emit``),
``trace.py`` (``Trace``, ``Span``, span context), ``prom.py``
(``PromRenderer``), ``recorder.py`` (``FlightRecorder``) and
``aggregator.py`` (``Aggregator``, ``SloEvaluator``, ``SpanStore``,
``assemble_trace``, ``merge_expositions``); and ``roofline.py``, the port's
efficiency plane (the reference's classification, ledger and peaks, with an
analytic ``ForwardCost`` in place of XLA's cost analysis and an H100 peak
table). XLA's compile-cache listener has no counterpart.
"""

from .aggregator import (
    Aggregator,
    SloEvaluator,
    SpanStore,
    assemble_trace,
    merge_expositions,
)
from .events import EVENTS, EventRing, emit
from .histogram import (
    HistSnapshot,
    LogHistogram,
    MergedHist,
    bucket_pairs,
    merge,
    quantile,
)
from .prom import PromRenderer
from .recorder import FlightRecorder
from .roofline import (
    DECODE_PROGRAMS,
    PREFILL_PROGRAMS,
    SPEC_PROGRAMS,
    WASTE_CATEGORIES,
    ForwardCost,
    HbmLedger,
    RollingUtilization,
    chip_peaks,
    classify_program,
    efficiency_enabled,
    resolve_chip_peaks,
)
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
    "Aggregator",
    "SloEvaluator",
    "SpanStore",
    "assemble_trace",
    "merge_expositions",
    "EVENTS",
    "EventRing",
    "emit",
    "FlightRecorder",
    "HistSnapshot",
    "LogHistogram",
    "MergedHist",
    "bucket_pairs",
    "merge",
    "quantile",
    "PromRenderer",
    "DECODE_PROGRAMS",
    "PREFILL_PROGRAMS",
    "SPEC_PROGRAMS",
    "WASTE_CATEGORIES",
    "ForwardCost",
    "HbmLedger",
    "RollingUtilization",
    "chip_peaks",
    "classify_program",
    "efficiency_enabled",
    "resolve_chip_peaks",
    "STAGES",
    "Span",
    "Trace",
    "new_span_id",
    "new_trace_id",
    "parse_span_context",
    "span_context_value",
]
