"""Multi-tenant QoS primitives: fair share, priority classes and tenant rollups.

Copy of ``nats_llm_studio_tpu/serve/qos.py`` trimmed to what the batcher
and the worker use: the priority classes (``class_rank``,
``class_weight``, ``normalize_priority``, ``format_priority_header`` /
``parse_priority_header``), ``DrrScheduler``, ``cap_tenant_rows``,
``TenantStats`` and the gateway's ``ApiKeySpec``, ``parse_api_keys``,
``TokenBucket`` and ``TenantUsage``.

* ``parse_api_keys`` / ``TokenBucket`` / ``TenantUsage`` — the gateway's
  API-key table, per-key rate limit and per-tenant monthly token quota.

* ``DrrScheduler`` — deficit round-robin over per-tenant queues,
  weighted by priority class. The batcher owner loop reorders its
  waitlist through this before each admission pass, so admission
  converges to weighted fair share instead of FIFO arrival order.
  Single-tenant traffic degenerates to exact FIFO.
* ``cap_tenant_rows`` — top-K + ``other`` rollup for every exposition
  that carries a ``tenant`` label, so a key-guessing client cannot blow
  up Prometheus cardinality.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

# Priority classes, weakest first. Rank order is the SHED order: brownout
# and preemption consume batch before standard before premium, never the
# reverse. Weights are the DRR quantum multipliers — a premium tenant
# drains ~16x the tokens per round of a batch tenant under contention.
PRIORITY_CLASSES = ("batch", "standard", "premium")

_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}
_WEIGHT = {"batch": 1, "standard": 4, "premium": 16}

# identity of every unauthenticated / raw-NATS caller: existing clients
# and tests that never heard of tenancy keep working at standard priority
ANON_TENANT = "anonymous"
DEFAULT_PRIORITY = "standard"


def class_rank(priority: str) -> int:
    """0 = batch (shed first) .. 2 = premium (shed last). Unknown class
    strings map to standard — a garbled header must not grant premium."""
    return _RANK.get(priority, _RANK[DEFAULT_PRIORITY])


def class_weight(priority: str) -> int:
    return _WEIGHT.get(priority, _WEIGHT[DEFAULT_PRIORITY])


def normalize_priority(priority) -> str:
    """Clamp any wire value to a known class (headers are attacker-ish
    input: raw-NATS callers can claim anything; unknown claims become
    ``standard``, never ``premium``)."""
    p = str(priority or "").strip().lower()
    return p if p in _RANK else DEFAULT_PRIORITY


def format_priority_header(priority: str, weight: float = 0.0) -> str:
    """Wire encoding for ``PRIORITY_HEADER``: ``class`` or
    ``class:weight`` when the API key carries an explicit fair-share
    weight — so a per-key weight override survives the gateway -> router
    -> worker hop instead of collapsing back to the class default."""
    p = normalize_priority(priority)
    return f"{p}:{weight:g}" if weight > 0 else p


def parse_priority_header(value) -> tuple[str, float]:
    """Decode ``PRIORITY_HEADER``: ``(class, weight)`` with weight 0.0
    meaning "derive from class". Tolerates any garbage (raw-NATS callers
    set arbitrary headers): unknown class -> standard, bad weight -> 0."""
    raw = str(value or "").strip()
    p, _, w = raw.partition(":")
    try:
        weight = max(0.0, float(w)) if w else 0.0
    except ValueError:
        weight = 0.0
    return normalize_priority(p), weight


@dataclass(frozen=True)
class ApiKeySpec:
    """One parsed ``API_KEYS`` entry."""

    key: str
    tenant: str
    priority: str = DEFAULT_PRIORITY
    weight: float = 0.0  # 0 = derive from class
    rps: float = 0.0  # requests/s token-bucket rate; 0 = unlimited
    monthly_tokens: int = 0  # monthly completion-token quota; 0 = unlimited


def parse_api_keys(spec: str) -> dict[str, ApiKeySpec]:
    """Parse the ``API_KEYS`` spec: comma-separated
    ``key:tenant:class[:weight[:rps[:monthly_tokens]]]`` entries, e.g.
    ``sk-a:acme:premium:0:50:1000000,sk-b:hobby:batch``.

    Malformed entries raise (a half-configured auth table silently
    admitting everyone is worse than failing the gateway at boot).
    """
    keys: dict[str, ApiKeySpec] = {}
    for raw in (spec or "").split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = [p.strip() for p in raw.split(":")]
        if len(parts) < 2 or not parts[0] or not parts[1]:
            raise ValueError(
                f"API_KEYS entry {raw!r}: want key:tenant:class"
                f"[:weight[:rps[:monthly_tokens]]]"
            )
        priority = parts[2].lower() if len(parts) > 2 and parts[2] else DEFAULT_PRIORITY
        if priority not in _RANK:
            raise ValueError(
                f"API_KEYS entry {raw!r}: class {priority!r} not in "
                f"{'/'.join(PRIORITY_CLASSES)}"
            )
        try:
            weight = float(parts[3]) if len(parts) > 3 and parts[3] else 0.0
            rps = float(parts[4]) if len(parts) > 4 and parts[4] else 0.0
            quota = int(parts[5]) if len(parts) > 5 and parts[5] else 0
        except ValueError:
            raise ValueError(
                f"API_KEYS entry {raw!r}: weight/rps/monthly_tokens must be numeric"
            ) from None
        if parts[0] in keys:
            raise ValueError(f"API_KEYS: duplicate key {parts[0]!r}")
        keys[parts[0]] = ApiKeySpec(
            key=parts[0], tenant=parts[1], priority=priority,
            weight=max(0.0, weight), rps=max(0.0, rps),
            monthly_tokens=max(0, quota),
        )
    return keys


class TokenBucket:
    """Classic token bucket over the monotonic clock. ``rate`` tokens/s
    refill up to a burst of ``max(1, 2 s of rate)``; one ``take()`` per
    request. Thread-safe (the gateway serves connections concurrently)."""

    def __init__(self, rate: float, burst: float | None = None):
        self.rate = max(0.0, float(rate))
        self.burst = float(burst) if burst else max(1.0, self.rate * 2.0)
        self._level = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def take(self, n: float = 1.0) -> bool:
        """True = admitted. A zero-rate bucket admits everything."""
        if self.rate <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            self._level = min(self.burst, self._level + (now - self._t) * self.rate)
            self._t = now
            if self._level >= n:
                self._level -= n
                return True
            return False

    def retry_after_s(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (429 Retry-After)."""
        if self.rate <= 0:
            return 0.0
        with self._lock:
            deficit = n - self._level
        return max(0.0, deficit / self.rate)


class TenantUsage:
    """Per-tenant monthly completion-token accounting. The month key is
    wall-clock UTC ``YYYY-MM`` — crossing the boundary implicitly resets
    every counter (old months are dropped, this is accounting not
    billing-grade bookkeeping). Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._month = ""
        self._tokens: dict[str, int] = {}
        self._requests: dict[str, int] = {}

    @staticmethod
    def _now_month() -> str:
        return time.strftime("%Y-%m", time.gmtime())

    def _roll(self) -> None:
        m = self._now_month()
        if m != self._month:
            self._month = m
            self._tokens = {}
            self._requests = {}

    def charge(self, tenant: str, tokens: int) -> int:
        """Add ``tokens`` to the tenant's month; returns the new total."""
        with self._lock:
            self._roll()
            self._requests[tenant] = self._requests.get(tenant, 0) + 1
            t = self._tokens.get(tenant, 0) + max(0, int(tokens))
            self._tokens[tenant] = t
            return t

    def tokens_used(self, tenant: str) -> int:
        with self._lock:
            self._roll()
            return self._tokens.get(tenant, 0)

    def over_quota(self, tenant: str, monthly_tokens: int) -> bool:
        if monthly_tokens <= 0:
            return False
        return self.tokens_used(tenant) >= monthly_tokens

    def snapshot(self) -> dict[str, dict[str, int]]:
        with self._lock:
            self._roll()
            return {
                t: {"tokens": self._tokens.get(t, 0),
                    "requests": self._requests.get(t, 0)}
                for t in set(self._tokens) | set(self._requests)
            }


class DrrScheduler:
    """Deficit round-robin across tenants, weighted by priority class.

    ``order(items, tenant_of, cost_of, weight_of)`` returns the items
    re-ordered into DRR service order WITHOUT consuming them — the
    batcher re-runs it over whatever is still waiting each admission
    pass, and per-tenant deficit counters persist across passes so a
    heavy tenant's over-service in one round is repaid in the next.
    FIFO order within a tenant is always preserved; with a single
    tenant the output equals the input (exact FIFO backcompat).

    Owner-thread only (the batcher calls it from ``_run``); the quantum
    is denominated in the same unit as ``cost_of`` (prompt tokens).
    """

    def __init__(self, quantum: float = 256.0):
        self.quantum = max(1.0, float(quantum))
        self._deficit: dict[str, float] = {}

    def order(self, items, tenant_of, cost_of, weight_of) -> list:
        if len(items) <= 1:
            return list(items)
        queues: dict[str, list] = {}
        weights: dict[str, float] = {}
        for it in items:
            t = tenant_of(it)
            queues.setdefault(t, []).append(it)
            # a tenant mixing classes (several keys) gets its best weight
            weights[t] = max(weights.get(t, 0.0), float(weight_of(it)))
        if len(queues) == 1:
            return list(items)
        # drop deficit state for tenants no longer queued: an absent
        # tenant must not bank unbounded credit while idle (classic DRR
        # resets the counter when the queue empties)
        for t in list(self._deficit):
            if t not in queues:
                del self._deficit[t]
        # round-robin visit order: stable by first arrival in `items`
        # (dict preserves insertion order), so equal-weight tenants
        # alternate rather than starving on name sort
        out: list = []
        active = list(queues)
        while active:
            next_active = []
            for t in active:
                self._deficit[t] = (
                    self._deficit.get(t, 0.0)
                    + self.quantum * max(1.0, weights.get(t, 1.0))
                )
                q = queues[t]
                while q and self._deficit[t] >= float(cost_of(q[0])):
                    self._deficit[t] -= float(cost_of(q[0]))
                    out.append(q.pop(0))
                if q:
                    next_active.append(t)
                else:
                    # emptied queue: no banked credit while idle
                    self._deficit[t] = 0.0
            active = next_active
        return out

    def forget(self, tenant: str) -> None:
        self._deficit.pop(tenant, None)


def cap_tenant_rows(rows: dict, top_k: int, key_of=None) -> dict:
    """Roll everything past the top-K tenants (by total value) into one
    ``other`` row. ``rows`` maps tenant -> number OR tenant -> dict of
    numeric counters (summed for ranking, merged key-wise into ``other``).
    A tenant literally named ``other`` merges into the rollup too. The
    anonymous tenant is ranked like any other. top_k <= 0 disables."""
    if top_k <= 0 or len(rows) <= top_k:
        return dict(rows)

    def total(v):
        if isinstance(v, dict):
            return sum(float(x) for x in v.values())
        return float(v)

    ranked = sorted(rows.items(), key=lambda kv: (-total(kv[1]), kv[0]))
    out: dict = {}
    other = None
    for i, (t, v) in enumerate(ranked):
        if i < top_k and t != "other":
            out[t] = v
        elif other is None:
            other = dict(v) if isinstance(v, dict) else v
        elif isinstance(v, dict):
            for k, x in v.items():
                other[k] = other.get(k, 0) + x
        else:
            other += v
    if other is not None:
        out["other"] = other
    return out


@dataclass
class TenantStats:
    """Per-tenant serving counters, shared between the batcher threads
    (submit-side sheds run on event loops; serves on the owner thread) —
    every mutation takes the lock, same discipline as
    ``BatcherStats.record_shed``."""

    _lock: threading.Lock = field(default_factory=threading.Lock)
    _rows: dict = field(default_factory=dict)

    def _row(self, tenant: str) -> dict:
        row = self._rows.get(tenant)
        if row is None:
            row = {"requests": 0, "served": 0, "shed": 0, "preempted": 0,
                   "tokens": 0, "queue_age_ms_sum": 0.0}
            self._rows[tenant] = row
        return row

    def record_request(self, tenant: str) -> None:
        with self._lock:
            self._row(tenant)["requests"] += 1

    def record_served(self, tenant: str, tokens: int, queue_age_ms: float) -> None:
        with self._lock:
            row = self._row(tenant)
            row["served"] += 1
            row["tokens"] += int(tokens)
            row["queue_age_ms_sum"] += float(queue_age_ms)

    def record_shed(self, tenant: str) -> None:
        with self._lock:
            self._row(tenant)["shed"] += 1

    def record_preempted(self, tenant: str) -> None:
        with self._lock:
            self._row(tenant)["preempted"] += 1

    def snapshot(self, top_k: int = 0) -> dict[str, dict]:
        with self._lock:
            rows = {t: dict(r) for t, r in self._rows.items()}
        return cap_tenant_rows(rows, top_k) if top_k else rows
