"""Bounded log-bucket histograms: O(1) record, O(buckets) snapshot.

Copy of ``nats_llm_studio_tpu/obs/histogram.py`` trimmed to what the
prefix cache, the batcher's stats and the Prometheus renderer use:
``LogHistogram`` (``record``, ``snapshot``, ``count``, ``max``,
``percentile``), ``HistSnapshot`` (``percentile``, ``mean``; no snapshot
deltas or ``to_dict``) and the cross-worker merge helpers the fleet
aggregator uses (``bucket_pairs``, ``MergedHist``, ``merge``,
``quantile``).

A fixed geometric bucket ladder covers [lo, hi] with a bounded relative
error per bucket (``growth`` - 1 worst case), so a long-lived worker's
percentiles cost a fixed few hundred ints of memory no matter how many
values it has recorded.

Recording happens on the batcher owner thread while health/metrics
handlers snapshot from the asyncio thread, so both paths take the
histogram's lock (a handful of ns against a ~ms device dispatch).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from dataclasses import dataclass


def _bounds(lo: float, hi: float, growth: float) -> tuple[float, ...]:
    if not (lo > 0 and hi > lo and growth > 1.0):
        raise ValueError(f"need 0 < lo < hi and growth > 1, got {lo}, {hi}, {growth}")
    out = [lo]
    b = lo
    while b < hi:
        b *= growth
        out.append(min(b, hi))
    return tuple(out)


# bucket ladders are shared across histogram instances (every batcher
# stat block holds five of these)
_BOUNDS_CACHE: dict[tuple[float, float, float], tuple[float, ...]] = {}


@dataclass(frozen=True)
class HistSnapshot:
    """Immutable point-in-time view; subtractable for phase deltas."""

    bounds: tuple[float, ...]  # upper edges; counts[i] holds v <= bounds[i]
    counts: tuple[int, ...]  # len(bounds) + 1: the last bucket is > bounds[-1]
    count: int
    total: float
    vmin: float | None  # None on empty snapshots and on deltas
    vmax: float | None

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (0 <= q <= 1) by linear interpolation
        inside the containing bucket — same rank rule as sorting all
        recorded values ascending and indexing ``int(count * q)``."""
        if self.count <= 0:
            return 0.0
        rank = min(self.count - 1, int(self.count * q))
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c > rank:
                lo_edge = 0.0 if i == 0 else self.bounds[i - 1]
                hi_edge = self.bounds[i] if i < len(self.bounds) else (
                    self.vmax if self.vmax is not None else self.bounds[-1]
                )
                frac = (rank - cum + 1) / c
                est = lo_edge + (hi_edge - lo_edge) * frac
                # recorded extrema (when known) tighten the bucket edges
                if self.vmax is not None:
                    est = min(est, self.vmax)
                if self.vmin is not None:
                    est = max(est, self.vmin)
                return est
            cum += c
        return self.vmax if self.vmax is not None else self.bounds[-1]


class LogHistogram:
    """Fixed-size thread-safe histogram over geometric bucket boundaries.

    ``record`` is O(log buckets) (one bisect + one increment under the
    lock); ``snapshot`` is O(buckets). Values below ``lo`` land in the
    first bucket, values above ``hi`` in the overflow bucket (percentile
    estimates there fall back to the recorded max).
    """

    __slots__ = ("bounds", "_counts", "_count", "_total", "_vmin", "_vmax", "_lock")

    def __init__(self, lo: float = 0.01, hi: float = 1e7, growth: float = 1.25):
        key = (lo, hi, growth)
        bounds = _BOUNDS_CACHE.get(key)
        if bounds is None:
            bounds = _BOUNDS_CACHE.setdefault(key, _bounds(lo, hi, growth))
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self._count = 0
        self._total = 0.0
        self._vmin: float | None = None
        self._vmax: float | None = None
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._total += value
            if self._vmin is None or value < self._vmin:
                self._vmin = value
            if self._vmax is None or value > self._vmax:
                self._vmax = value

    def snapshot(self) -> HistSnapshot:
        with self._lock:
            return HistSnapshot(
                bounds=self.bounds,
                counts=tuple(self._counts),
                count=self._count,
                total=self._total,
                vmin=self._vmin,
                vmax=self._vmax,
            )

    @property
    def count(self) -> int:
        return self._count

    @property
    def max(self) -> float:
        return self._vmax if self._vmax is not None else 0.0

    def percentile(self, q: float) -> float:
        return self.snapshot().percentile(q)


# ---------------------------------------------------------------------------
# Cross-worker histogram merging, for the fleet aggregator.
# ---------------------------------------------------------------------------

_INF = float("inf")


def bucket_pairs(text: str, family: str) -> list[tuple[float, float]]:
    """Extract ``(upper_edge, cumulative_count)`` pairs for one histogram
    family from a Prometheus exposition text; ``+Inf`` maps to infinity."""
    pairs: list[tuple[float, float]] = []
    for line in text.splitlines():
        if not line.startswith(family + "_bucket"):
            continue
        i = line.index('le="') + 4
        le = line[i:line.index('"', i)]
        pairs.append((_INF if le == "+Inf" else float(le),
                      float(line.rsplit(None, 1)[1])))
    return pairs


@dataclass(frozen=True)
class MergedHist:
    """Delta-merged view over N workers' cumulative histogram buckets.

    Renderers elide empty buckets, so merging *cumulative* counts by edge
    across workers produces non-monotonic garbage; each series converts
    to per-bucket deltas first, then the deltas merge. Mean/variance use
    bucket midpoints (the +Inf bucket collapses to that series' last
    finite edge); quantiles return the upper bucket edge — resolution-
    honest, no interpolation.
    """

    # (midpoint, collapsed upper edge, count) — +Inf already collapsed
    samples: tuple[tuple[float, float, float], ...]
    # (true upper edge, count) with +Inf preserved, sorted — this is the
    # shape a renderer needs to re-expose the merged histogram
    deltas: tuple[tuple[float, float], ...]

    @property
    def count(self) -> float:
        return sum(n for _, _, n in self.samples)

    @property
    def mean(self) -> float:
        c = self.count
        return sum(v * n for v, _, n in self.samples) / c if c else 0.0

    @property
    def variance(self) -> float:
        c = self.count
        if not c:
            return 0.0
        m = self.mean
        return sum(n * (v - m) ** 2 for v, _, n in self.samples) / c

    @property
    def std(self) -> float:
        return self.variance ** 0.5

    def quantile(self, q: float) -> float:
        """First upper bucket edge whose cumulative merged delta count
        reaches ``q * count``; 0.0 on an empty merge. Always finite (the
        +Inf bucket was collapsed per-series at merge time)."""
        count = self.count
        if count <= 0:
            return 0.0
        agg: dict[float, float] = {}
        for _, upper, n in self.samples:
            agg[upper] = agg.get(upper, 0.0) + n
        cum = 0.0
        for edge, n in sorted(agg.items()):
            cum += n
            if cum >= q * count:
                return edge
        return 0.0

    def snapshot(self, total: float | None = None) -> HistSnapshot:
        """Rebuild a :class:`HistSnapshot` (for ``PromRenderer.histogram``)
        from the merged deltas. ``total`` should be the summed ``_sum`` of
        the source expositions; defaults to the midpoint estimate."""
        finite = [(e, n) for e, n in self.deltas if e != _INF]
        overflow = sum(n for e, n in self.deltas if e == _INF)
        counts = tuple(int(round(n)) for _, n in finite) + (int(round(overflow)),)
        if total is None:
            total = sum(v * n for v, _, n in self.samples)
        return HistSnapshot(
            bounds=tuple(e for e, _ in finite),
            counts=counts,
            count=int(round(sum(n for _, n in self.deltas))),
            total=total,
            vmin=None,
            vmax=None,
        )


def merge(series) -> MergedHist:
    """Merge an iterable of per-exposition cumulative bucket-pair lists
    (as returned by :func:`bucket_pairs`) into one :class:`MergedHist`.

    Per series, cumulative counts convert to deltas FIRST; negative
    deltas (counter resets, malformed input) are dropped rather than
    poisoning the merge.
    """
    samples: list[tuple[float, float, float]] = []
    true_deltas: dict[float, float] = {}
    for pairs in series:
        prev_edge, prev_cum = 0.0, 0.0
        for edge, cum in sorted(pairs):
            n = cum - prev_cum
            if n > 0:
                if edge == _INF:
                    mid_v = upper = prev_edge
                else:
                    mid_v = (prev_edge + edge) / 2
                    upper = edge
                samples.append((mid_v, upper, n))
                true_deltas[edge] = true_deltas.get(edge, 0.0) + n
            prev_cum = cum
            if edge != _INF:
                prev_edge = edge
    return MergedHist(samples=tuple(samples),
                      deltas=tuple(sorted(true_deltas.items())))


def quantile(pairs, q: float) -> float:
    """Resolution-honest quantile of a single exposition's cumulative
    bucket pairs — shorthand for ``merge([pairs]).quantile(q)``."""
    return merge([pairs]).quantile(q)
