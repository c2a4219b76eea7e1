"""Observability: bounded histograms and the event ring.

Copies of the jax-free ``nats_llm_studio_tpu/obs/histogram.py``
(``LogHistogram``, ``HistSnapshot``) and ``obs/events.py`` (``EventRing``,
``EVENTS``, ``emit``), trimmed to what ``serve/prefix_cache.py`` uses. The
rest of the reference's ``obs/`` (traces, exposition, the flight recorder,
the roofline ledger) is not ported yet.
"""

from .events import EVENTS, EventRing, emit
from .histogram import HistSnapshot, LogHistogram

__all__ = ["EVENTS", "EventRing", "emit", "HistSnapshot", "LogHistogram"]
