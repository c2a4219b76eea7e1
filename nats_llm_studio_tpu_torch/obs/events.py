"""Fixed-capacity structured event ring for post-hoc incident diagnosis.

Copy of ``nats_llm_studio_tpu/obs/events.py``, whole.

Aggregate counters say *that* requests were shed; the event ring says
*which* and *why* — the last N notable happenings (sheds, cancels, ring
compactions, engine load/evict, slow requests over a threshold) with
wall-clock timestamps, served on ``lmstudio.events``. Capacity-bounded:
emit is O(1), old events are overwritten, and the ``dropped`` counter
records how many fell off so a reader knows the window is partial.

Producers span threads (batcher owner, asyncio handlers, registry), so
every operation takes the ring's lock.
"""

from __future__ import annotations

import threading
import time


class EventRing:
    def __init__(self, capacity: int = 512):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._buf: list[dict | None] = [None] * capacity
        self._seq = 0  # total events ever emitted
        self._lock = threading.Lock()

    def emit(self, kind: str, **fields) -> dict:
        # both clocks: wall for humans/log-correlation, monotonic so
        # events line up with trace marks and recorder frames (which are
        # monotonic-stamped) without cross-clock arithmetic
        ev = {
            "kind": kind,
            "ts": round(time.time(), 3),
            "mono": round(time.monotonic(), 3),
            **fields,
        }
        with self._lock:
            ev["seq"] = self._seq
            self._buf[self._seq % self.capacity] = ev
            self._seq += 1
        return ev

    @property
    def emitted(self) -> int:
        return self._seq

    @property
    def dropped(self) -> int:
        """Events that have been overwritten (fell out of the window)."""
        return max(0, self._seq - self.capacity)

    def snapshot(self, kind: str | None = None, limit: int | None = None) -> list[dict]:
        """Events oldest-first, optionally filtered by ``kind`` and capped
        to the most recent ``limit``."""
        with self._lock:
            start = max(0, self._seq - self.capacity)
            out = [
                ev
                for i in range(start, self._seq)
                if (ev := self._buf[i % self.capacity]) is not None
            ]
        if kind is not None:
            out = [ev for ev in out if ev["kind"] == kind]
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._seq = 0


# process-wide default ring: the batcher owner thread, the registry, and
# the worker handlers all emit here; the worker serves it on
# ``lmstudio.events``
EVENTS = EventRing(512)


def emit(kind: str, **fields) -> dict:
    return EVENTS.emit(kind, **fields)
