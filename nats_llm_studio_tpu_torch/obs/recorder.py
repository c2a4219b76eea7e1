"""Flight recorder: a bounded ring of periodic state frames + anomaly dumps.

Copy of ``nats_llm_studio_tpu/obs/recorder.py`` (``FlightRecorder``, whole).

Prometheus gauges answer "what is the worker doing *now*"; the event ring
answers "what notable things happened"; neither answers "what was the
queue depth / pool occupancy / brownout level over the thirty seconds
*before* the crash". The flight recorder does: the batcher owner loop
samples one compact frame per ``OBS_RECORDER_INTERVAL_MS`` into a
fixed-capacity ring, and when an anomaly fires (engine restart, KV pool
exhaustion, SHED_ONLY entry, a slow request) the recorder writes the
last ``dump_window_s`` of frames plus the event-ring tail plus the
offending request's trace to a timestamped JSON under ``OBS_DUMP_DIR``,
then emits a ``flight_dump`` event pointing at the file.

Threading: frames are appended by the batcher owner thread; dumps and
reads come from the asyncio thread (debug subjects, slow-request path)
and from the registry's supervisor task. Every operation takes the
recorder's lock; ``sample``/``due`` are O(1) so the owner loop pays
nothing measurable per tick.

Import-light like the rest of ``obs/``: stdlib + the event ring only —
the batcher and transport import *us*.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .events import EVENTS, emit

# dumps triggered by the same anomaly class within this window collapse
# into one file (a crash storm must not fill the disk); force=True
# bypasses the limiter for operator-requested and restart dumps
_DEFAULT_MIN_INTERVAL_S = 1.0


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


class FlightRecorder:
    """Bounded frame ring with rate-limited anomaly dumps.

    A disabled recorder (``enabled=False``) keeps the full API but
    ``due`` is always False and ``dump`` returns None, so call sites
    never branch on configuration.
    """

    def __init__(
        self,
        *,
        capacity: int = 600,
        interval_ms: float = 250.0,
        dump_dir: str = "",
        dump_window_s: float = 30.0,
        dump_min_interval_s: float = _DEFAULT_MIN_INTERVAL_S,
        engine: str = "",
        worker_id: str = "",
        counter_fns: dict | None = None,
        enabled: bool = True,
    ):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.interval_s = max(float(interval_ms), 1.0) / 1e3
        self.dump_dir = dump_dir
        self.dump_window_s = float(dump_window_s)
        self.dump_min_interval_s = float(dump_min_interval_s)
        self.engine = engine
        # cluster identity: stamped on every frame and dump so artifacts
        # from N workers sharing one OBS_DUMP_DIR stay attributable
        self.worker_id = worker_id
        # name -> zero-arg callable returning a number; merged into every
        # frame so process-level counters (reconnects, engine restarts)
        # line up with batcher-level state on the same timeline
        self.counter_fns = dict(counter_fns or {})
        self._buf: list[dict | None] = [None] * self.capacity
        self._seq = 0
        self._last_sample_mono = 0.0
        self._last_dump_mono = 0.0
        self._dumps_written = 0
        self._lock = threading.Lock()

    @classmethod
    def from_env(
        cls, *, engine: str = "", worker_id: str = "",
        counter_fns: dict | None = None,
    ) -> "FlightRecorder":
        return cls(
            enabled=_env("OBS_RECORDER", "1") not in ("0", "false", "off"),
            interval_ms=float(_env("OBS_RECORDER_INTERVAL_MS", "250")),
            dump_dir=_env("OBS_DUMP_DIR", ""),
            dump_window_s=float(_env("OBS_DUMP_WINDOW_S", "30")),
            engine=engine,
            worker_id=worker_id,
            counter_fns=counter_fns,
        )

    # ------------------------------------------------------------- sampling

    def due(self, now: float | None = None) -> bool:
        """Cheap owner-loop check: is the next frame's interval up?"""
        if not self.enabled:
            return False
        if now is None:
            now = time.monotonic()
        return (now - self._last_sample_mono) >= self.interval_s

    def sample(self, frame: dict, now: float | None = None) -> None:
        """Append one frame (owner thread). Stamps wall + monotonic time
        and merges the registered process counters."""
        if not self.enabled:
            return
        if now is None:
            now = time.monotonic()
        fr = {"ts": round(time.time(), 3), "mono": round(now, 3)}
        if self.worker_id:
            fr["worker_id"] = self.worker_id
        for name, fn in self.counter_fns.items():
            try:
                fr[name] = fn()
            except Exception:
                pass
        fr.update(frame)
        with self._lock:
            self._last_sample_mono = now
            self._buf[self._seq % self.capacity] = fr
            self._seq += 1

    @property
    def frames_sampled(self) -> int:
        return self._seq

    @property
    def dumps_written(self) -> int:
        return self._dumps_written

    def frames(self, last_s: float | None = None, limit: int | None = None) -> list[dict]:
        """Frames oldest-first, optionally restricted to the trailing
        ``last_s`` seconds (by monotonic stamp) or the last ``limit``."""
        with self._lock:
            start = max(0, self._seq - self.capacity)
            out = [
                fr
                for i in range(start, self._seq)
                if (fr := self._buf[i % self.capacity]) is not None
            ]
        if last_s is not None and out:
            cutoff = out[-1]["mono"] - last_s
            out = [fr for fr in out if fr["mono"] >= cutoff]
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def tail(self, limit: int = 20) -> list[dict]:
        return self.frames(limit=limit)

    # ---------------------------------------------------------------- dumps

    def dump(
        self,
        reason: str,
        trace: dict | None = None,
        extra: dict | None = None,
        force: bool = False,
    ) -> str | None:
        """Write the flight-dump JSON and return its path, or None when
        disabled, no ``dump_dir`` is configured, or rate-limited.

        The dump is the incident artifact: trailing frames, event-ring
        tail, the offending request's trace, and free-form context.
        ``force`` bypasses the rate limiter (operator-requested dumps and
        restart dumps must always land).
        """
        if not self.enabled or not self.dump_dir:
            return None
        now = time.monotonic()
        with self._lock:
            if not force and (now - self._last_dump_mono) < self.dump_min_interval_s:
                return None
            self._last_dump_mono = now
            self._dumps_written += 1
            n = self._dumps_written
        doc = {
            "reason": reason,
            "engine": self.engine,
            "worker_id": self.worker_id,
            "ts": round(time.time(), 3),
            "mono": round(now, 3),
            "interval_ms": round(self.interval_s * 1e3, 3),
            "frames": self.frames(last_s=self.dump_window_s),
            "events": EVENTS.snapshot(limit=64),
            "trace": trace,
            "extra": extra or {},
        }
        fname = "flight-{:.3f}-{}-{}.json".format(time.time(), n, reason.replace("/", "_"))
        path = os.path.join(self.dump_dir, fname)
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
        except OSError as e:
            emit("flight_dump_error", reason=reason, error=str(e))
            return None
        emit(
            "flight_dump",
            reason=reason,
            path=path,
            engine=self.engine,
            worker_id=self.worker_id,
            frames=len(doc["frames"]),
        )
        return path
