"""Adaptive brownout: degrade service under overload instead of falling over.

Copy of ``nats_llm_studio_tpu/serve/brownout.py``, whole.

The batcher's only overload responses so far are binary — serve, or shed at
the depth/age bounds. Under sustained pressure that means full-quality
service right up to the cliff, then 503s. This module adds the middle
ground: a small state machine the batcher owner thread ticks every loop,

    NORMAL  →  BROWNOUT  →  SHED_ONLY

driven by three signals (admit queue depth as a fraction of the limit,
queue age p95, HBM headroom) with hysteresis — escalation is immediate when
any signal crosses its high-water mark, de-escalation requires *every*
signal below its low-water mark continuously for ``dwell_s`` so the
controller cannot flap at a threshold.

Per level the batcher applies cheap, reversible levers (serve/batcher.py):

- BROWNOUT: pause speculative decoding (verify slots go back to plain
  decode throughput), halve ``decode_burst`` (shorter dispatch windows →
  faster shed/abort reaction), stop harvesting new prefix-cache blocks
  (admits stop paying the copy-out), and tighten the effective admit queue
  limit to ``tighten_frac`` of the configured one.
- SHED_ONLY: all of the above, burst forced to 1, and *new* submits are
  shed immediately with a retryable envelope — already-queued work drains.

Every transition is emitted to the obs event ring (kind ``brownout``) and
the current level is exposed as the ``lmstudio_brownout_level`` gauge and
in ``health``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..obs.events import emit as obs_emit

NORMAL = 0
BROWNOUT = 1
SHED_ONLY = 2

LEVEL_NAMES = {NORMAL: "normal", BROWNOUT: "brownout", SHED_ONLY: "shed_only"}


@dataclass(frozen=True)
class BrownoutConfig:
    """Thresholds for the controller; env-tunable via BROWNOUT_* knobs
    (config.py). ``*_hi`` marks escalate one level when crossed, ``*_lo``
    marks must ALL hold for ``dwell_s`` before de-escalating one level.
    ``shed_only_scale`` multiplies the hi marks for the BROWNOUT→SHED_ONLY
    edge (pressure well past the first response)."""

    depth_hi: float = 0.75     # queue depth / queue limit
    depth_lo: float = 0.40
    age_hi_ms: float = 1500.0  # queue age p95
    age_lo_ms: float = 500.0
    hbm_lo_frac: float = 0.05  # headroom below this escalates
    dwell_s: float = 2.0       # calm required before stepping back down
    shed_only_scale: float = 1.5
    tighten_frac: float = 0.5  # effective admit-limit fraction in brownout
    # SHED_ONLY slot target as a fraction of max_slots: with tiered KV +
    # slot suspend enabled the batcher suspends (not cancels) the youngest
    # slots down to this fraction on the SHED_ONLY edge, freeing pool blocks
    # and decode width for the oldest streams without losing any work
    suspend_frac: float = 0.5


class BrownoutController:
    """Ticked by the batcher owner thread only; ``level`` is a plain int
    read cross-thread by the submit path (single attribute read — no lock)."""

    def __init__(self, cfg: BrownoutConfig | None = None, *, engine: str = ""):
        self.cfg = cfg or BrownoutConfig()
        self.engine = engine
        self.level = NORMAL
        self.transitions = 0  # lifetime transition count (bench deltas)
        self._calm_since: float | None = None

    def _pressure(self, depth_frac: float, age_p95_ms: float,
                  hbm_headroom_frac: float | None, scale: float) -> list[str]:
        """Names of the signals over their (scaled) high-water marks."""
        c = self.cfg
        over = []
        if depth_frac >= c.depth_hi * scale:
            over.append("depth")
        if age_p95_ms >= c.age_hi_ms * scale:
            over.append("age")
        if hbm_headroom_frac is not None and hbm_headroom_frac <= c.hbm_lo_frac / scale:
            over.append("hbm")
        return over

    def update(self, *, depth_frac: float, age_p95_ms: float,
               hbm_headroom_frac: float | None = None,
               now: float | None = None) -> int:
        """Feed the current signals; returns the (possibly new) level."""
        c = self.cfg
        now = time.monotonic() if now is None else now
        hot = self._pressure(depth_frac, age_p95_ms, hbm_headroom_frac, 1.0)
        very_hot = self._pressure(depth_frac, age_p95_ms, hbm_headroom_frac,
                                  c.shed_only_scale)
        calm = (
            depth_frac < c.depth_lo
            and age_p95_ms < c.age_lo_ms
            and (hbm_headroom_frac is None or hbm_headroom_frac > c.hbm_lo_frac)
        )

        target = self.level
        if self.level < SHED_ONLY and very_hot:
            target = SHED_ONLY
        elif self.level < BROWNOUT and hot:
            target = BROWNOUT

        if target > self.level:
            self._calm_since = None
            self._transition(target, reasons=very_hot or hot)
            return self.level

        if self.level > NORMAL and calm:
            if self._calm_since is None:
                self._calm_since = now
            elif now - self._calm_since >= c.dwell_s:
                self._calm_since = now  # restart the dwell for the next step
                self._transition(self.level - 1, reasons=["calm"])
        else:
            self._calm_since = None
        return self.level

    def _transition(self, new_level: int, reasons: list[str]) -> None:
        old = self.level
        self.level = new_level
        self.transitions += 1
        obs_emit(
            "brownout",
            engine=self.engine,
            level=new_level,
            level_name=LEVEL_NAMES[new_level],
            prev=LEVEL_NAMES[old],
            reasons=reasons,
        )

    # -- levers the batcher consults ------------------------------------

    @property
    def pause_spec(self) -> bool:
        return self.level >= BROWNOUT

    @property
    def pause_prefix_harvest(self) -> bool:
        return self.level >= BROWNOUT

    def effective_burst(self, burst: int) -> int:
        if self.level >= SHED_ONLY:
            return 1
        if self.level >= BROWNOUT:
            return max(1, burst // 2)
        return burst

    def effective_queue_limit(self, max_queue: int) -> int:
        """Tightened admit limit (0 keeps the zero-disables convention)."""
        if max_queue and self.level >= BROWNOUT:
            return max(1, int(max_queue * self.cfg.tighten_frac))
        return max_queue

    def suspend_target(self, max_slots: int) -> int:
        """Slot-count target for the suspend lever: below it, the batcher
        stops suspending. Only binds in SHED_ONLY; resume is gated on the
        level dropping back below SHED_ONLY."""
        if self.level >= SHED_ONLY:
            return max(1, int(max_slots * self.cfg.suspend_frac))
        return max_slots
