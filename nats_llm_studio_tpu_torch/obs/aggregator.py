"""Fleet-level observability plane: trace assembly, metric merging, SLO burn.

Copy of ``nats_llm_studio_tpu/obs/aggregator.py`` (pure Python, no
change of behaviour): the port's ``route`` (with ``OBS_AGGREGATOR=1``) and
``obs`` commands run it over torch workers.

One collector per cluster (or a queue group of them) does three jobs:

* **Trace assembly** — every hop (gateway, router, workers, both ends of
  the kv_export two-hop) publishes compact span batches on
  ``{prefix}.obs.spans``; the collector indexes them by trace id and
  serves the assembled parent-linked tree on request via
  ``{prefix}.debug.trace.<trace_id>``.
* **Metric aggregation** — it ingests ``{prefix}.cluster.adverts`` for
  membership, scrapes each live worker's directed ``metrics.prom``
  subject on an interval, and serves one cluster-level Prometheus
  exposition on ``{prefix}.cluster.metrics.prom``: counters/gauges sum
  across workers, histograms merge delta-first through
  :func:`obs.histogram.merge`, and
  the ``worker_id`` label is dropped from merged families.
* **SLO burn-rate alerts** — objectives (cluster TTFT p95,
  served-or-retryable ratio, shed rate) are evaluated over a fast and a
  slow window; when BOTH windows burn, an ``slo_burn`` event with the
  per-worker breakdown goes out on ``{prefix}.events`` — the control
  signal an autoscaler needs.

Import-light like the rest of obs/: this module never imports torch or the
transport — an already-connected client (duck-typed ``subscribe`` /
``request`` / ``publish``) is injected, mirroring how ``ClusterRouter``
receives its connection. Replies are hand-built in the transport's
``{ok, error?, data?}`` envelope shape.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import re
import time
from collections import OrderedDict, deque

from .events import emit
from .histogram import bucket_pairs, merge
from .prom import PromRenderer
from .trace import Span

log = logging.getLogger("lmstudio.obs.aggregator")

_INF = float("inf")

# subjects under the prefix (mirrors serve/router.py's ADVERT_SUBJECT style)
SPANS_SUBJECT = "obs.spans"
CLUSTER_METRICS_SUBJECT = "cluster.metrics.prom"
TRACE_QUERY_PREFIX = "debug.trace"
OBS_QUEUE_GROUP = "lmstudio-obs"


# --- Prometheus exposition parsing -----------------------------------------

_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) ([a-z]+)\s*$")
_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace('\\"', '"').replace("\\n", "\n").replace("\\\\", "\\")


def parse_exposition(text: str) -> tuple[dict[str, str], list[tuple[str, dict, float]]]:
    """Parse exposition text into ``(types, samples)`` where ``types`` maps
    family name -> declared type and ``samples`` is a list of
    ``(sample_name, labels, value)``. Unparseable lines are skipped — the
    merger must survive a garbled worker, not die on it."""
    types: dict[str, str] = {}
    samples: list[tuple[str, dict, float]] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                types.setdefault(m.group(1), m.group(2))
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, raw_labels, raw_value = m.group(1), m.group(2), m.group(3)
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = {k: _unescape(v) for k, v in _LABEL_RE.findall(raw_labels or "")}
        samples.append((name, labels, value))
    return types, samples


def _resolve_family(name: str, types: dict[str, str]) -> tuple[str, str, str] | None:
    """Map a sample name to ``(family, type, suffix)``; None when untyped."""
    typ = types.get(name)
    if typ is not None:
        return name, typ, ""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            fam = name[: -len(suffix)]
            if types.get(fam) == "histogram":
                return fam, "histogram", suffix
    return None


# Ratio/rate gauges where summing across workers is meaningless (a 2-worker
# fleet at 40% MFU each is NOT at 80%): these average over the contributing
# samples instead. Totals-style families (device_ms, flops, bytes) still sum.
MEAN_GAUGE_FAMILIES = frozenset({
    "lmstudio_mfu",
    "lmstudio_mbu",
    "lmstudio_goodput_tokens_per_device_s",
})

_TENANT_LABEL = "tenant"


def _tenant_topk_env() -> int:
    try:
        return int(os.environ.get("QOS_TENANT_TOPK", "8") or 0)
    except ValueError:
        return 8


def _cap_tenant_series(
    series: dict[tuple, float], top_k: int
) -> dict[tuple, float]:
    """Cardinality cap for a merged scalar family carrying a ``tenant``
    label: keep the top-K tenants by summed value, fold the rest into
    ``tenant="other"`` — the cluster-view counterpart of
    ``serve.qos.cap_tenant_rows`` (N workers' disjoint per-worker top-Ks
    can union far past K, so the cap must be re-applied after the merge).
    Series missing the label anywhere pass through untouched."""
    totals: dict[str, float] = {}
    for k, v in series.items():
        t = dict(k).get(_TENANT_LABEL)
        if t is None:
            return series
        totals[t] = totals.get(t, 0.0) + v
    if top_k <= 0 or len(totals) <= top_k:
        return series
    keep = {
        t for t, _ in sorted(
            totals.items(), key=lambda kv: (-kv[1], kv[0])
        )[:top_k] if t != "other"
    }
    out: dict[tuple, float] = {}
    for k, v in series.items():
        lbl = dict(k)
        if lbl[_TENANT_LABEL] not in keep:
            lbl[_TENANT_LABEL] = "other"
        nk = tuple(sorted(lbl.items()))
        out[nk] = out.get(nk, 0.0) + v
    return out


def merge_into(renderer: PromRenderer, texts: list[str],
               drop_labels: tuple[str, ...] = ("worker_id",),
               tenant_topk: int | None = None) -> None:
    """Merge N workers' expositions into ``renderer`` as one cluster view.

    Counters and gauges sum across workers by their remaining label sets
    once ``drop_labels`` are removed (except :data:`MEAN_GAUGE_FAMILIES`,
    which average); histogram families merge delta-first per label group
    (each worker's cumulative buckets convert to deltas before edges
    combine — see :class:`obs.histogram.MergedHist`) and are re-rendered
    spec-clean: one TYPE line per family, cumulative monotone buckets,
    ``+Inf`` == ``_count``.
    """
    types: dict[str, str] = {}
    parsed: list[list[tuple[str, dict, float]]] = []
    for text in texts:
        t, samples = parse_exposition(text)
        for k, v in t.items():
            types.setdefault(k, v)
        parsed.append(samples)

    order: list[tuple[str, str]] = []  # (family, type) in first-seen order
    scalars: dict[str, dict[tuple, float]] = {}
    scalar_n: dict[str, dict[tuple, int]] = {}  # sample counts for means
    hist_series: dict[str, dict[tuple, dict[tuple, list]]] = {}
    hist_sums: dict[str, dict[tuple, float]] = {}

    def _key(labels: dict) -> tuple:
        return tuple(sorted(
            (k, v) for k, v in labels.items() if k not in drop_labels
        ))

    for text_idx, samples in enumerate(parsed):
        for name, labels, value in samples:
            resolved = _resolve_family(name, types)
            if resolved is None:
                continue
            family, typ, suffix = resolved
            if typ in ("counter", "gauge"):
                if (family, typ) not in order:
                    order.append((family, typ))
                scalars.setdefault(family, {})
                k = _key(labels)
                scalars[family][k] = scalars[family].get(k, 0.0) + value
                n = scalar_n.setdefault(family, {})
                n[k] = n.get(k, 0) + 1
            elif typ == "histogram":
                if (family, typ) not in order:
                    order.append((family, typ))
                groups = hist_series.setdefault(family, {})
                sums = hist_sums.setdefault(family, {})
                if suffix == "_bucket":
                    le = labels.pop("le", None)
                    if le is None:
                        continue
                    edge = _INF if le in ("+Inf", "inf") else float(le)
                    gk = _key(labels)
                    # series identity keeps worker_id (and the source text,
                    # in case two texts share one id) so cumulative counts
                    # never mix across processes before the delta conversion
                    sk = (text_idx,) + tuple(sorted(labels.items()))
                    groups.setdefault(gk, {}).setdefault(sk, []).append((edge, value))
                elif suffix == "_sum":
                    gk = _key(labels)
                    groups.setdefault(gk, {})
                    sums[gk] = sums.get(gk, 0.0) + value
                # _count is re-derived from the merged deltas: using the
                # advertised one would let a non-monotonic source break the
                # (+Inf == _count) exposition invariant

    for family, typ in order:
        if typ == "histogram":
            sums = hist_sums.get(family, {})
            for gk in sorted(hist_series.get(family, {})):
                m = merge(hist_series[family][gk].values())
                renderer.histogram(family, m.snapshot(total=sums.get(gk, 0.0)),
                                   labels=dict(gk))
        else:
            add = renderer.counter if typ == "counter" else renderer.gauge
            mean = typ == "gauge" and family in MEAN_GAUGE_FAMILIES
            series = scalars.get(family, {})
            if not mean and series and any(
                _TENANT_LABEL in dict(k) for k in series
            ):
                series = _cap_tenant_series(
                    series,
                    tenant_topk if tenant_topk is not None
                    else _tenant_topk_env(),
                )
            for k in sorted(series):
                v = series[k]
                if mean:
                    v /= max(scalar_n.get(family, {}).get(k, 1), 1)
                add(family, v, labels=dict(k))


def merge_expositions(texts: list[str],
                      drop_labels: tuple[str, ...] = ("worker_id",)) -> str:
    renderer = PromRenderer()
    merge_into(renderer, texts, drop_labels)
    return renderer.render()


# --- span assembly ----------------------------------------------------------


class SpanStore:
    """Bounded trace_id -> spans index. Oldest-touched traces evict first;
    per-trace span counts are capped so one runaway trace cannot evict the
    rest of the fleet's history."""

    def __init__(self, max_traces: int = 512, max_spans_per_trace: int = 256):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._traces: OrderedDict[str, dict[str, dict]] = OrderedDict()
        self.spans_total = 0
        self.dropped_total = 0

    def add(self, d: dict) -> bool:
        span = Span.from_dict(d)
        if span is None:
            self.dropped_total += 1
            return False
        spans = self._traces.get(span.trace_id)
        if spans is None:
            spans = self._traces[span.trace_id] = {}
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)
        else:
            self._traces.move_to_end(span.trace_id)
        if span.span_id not in spans and len(spans) >= self.max_spans_per_trace:
            self.dropped_total += 1
            return False
        spans[span.span_id] = span.to_dict()  # re-send of a span id updates it
        self.spans_total += 1
        return True

    def get(self, trace_id: str) -> list[dict]:
        return list(self._traces.get(trace_id, {}).values())

    def __len__(self) -> int:
        return len(self._traces)


def assemble_trace(trace_id: str, spans: list[dict]) -> dict:
    """Build the parent-linked tree for one trace. Spans whose parent never
    arrived (lost batch, OBS_SPANS off at one hop) surface as extra roots
    rather than disappearing; children order by wall t0 (clock skew can
    reorder siblings, never reparent them — causality lives in the links)."""
    nodes = {s["span_id"]: {**s, "children": []} for s in spans}
    roots = []
    for sid, node in nodes.items():
        parent = node.get("parent_span_id") or ""
        if parent and parent != sid and parent in nodes:
            nodes[parent]["children"].append(node)
        else:
            roots.append(node)

    def _sort(children: list[dict]) -> None:
        children.sort(key=lambda n: (n.get("t0", 0.0), n["span_id"]))
        for c in children:
            _sort(c["children"])

    _sort(roots)
    return {"trace_id": trace_id, "span_count": len(nodes), "roots": roots}


# --- SLO burn-rate evaluation ----------------------------------------------


class SloEvaluator:
    """Multi-window burn-rate evaluation over scraped worker snapshots.

    ``observe()`` is fed one ``{worker_id: sample}`` dict per scrape tick
    (see :meth:`sample_from_exposition`); windowed deltas subtract the
    cumulative counters/buckets at the window start from the newest ones,
    per worker, so restarts (counter resets) clamp to zero instead of
    going negative. An alert fires only when BOTH the fast and the slow
    window burn at >= 1.0 — the classic guard against paging on a blip
    (fast-only) or on long-stale history (slow-only).
    """

    OBJECTIVES = ("ttft_p95", "served_ratio", "shed_rate")

    def __init__(self, *, ttft_p95_ms: float = 2000.0, window_s: float = 60.0,
                 served_ratio: float = 0.99, shed_ratio: float = 0.05,
                 fast_window_s: float | None = None,
                 min_alert_gap_s: float | None = None):
        self.ttft_p95_ms = ttft_p95_ms
        self.window_s = window_s
        self.served_ratio = served_ratio
        self.shed_ratio = shed_ratio
        self.fast_window_s = min(
            window_s, fast_window_s if fast_window_s is not None
            else max(1.0, window_s / 12.0)
        )
        self.min_alert_gap_s = (min_alert_gap_s if min_alert_gap_s is not None
                                else self.fast_window_s)
        self._snaps: deque[tuple[float, dict[str, dict]]] = deque()
        self._last_alert: dict[str, float] = {}
        # latest burn per objective, for the cluster exposition gauges
        self.last_burns: dict[str, dict[str, float]] = {}

    @staticmethod
    def sample_from_exposition(text: str) -> dict:
        """Extract the cumulative signals one worker contributes to the
        objectives: TTFT buckets, admitted requests, sheds, retryable
        in-flight failures."""
        def family_sum(family: str) -> float:
            return sum(
                float(line.rsplit(None, 1)[1])
                for line in text.splitlines()
                if line.startswith(family + "{") or line.startswith(family + " ")
            )

        return {
            "ttft": bucket_pairs(text, "lmstudio_ttft_ms"),
            "requests": family_sum("lmstudio_batcher_requests_total"),
            "sheds": family_sum("lmstudio_batcher_shed_by_cause_total"),
            "failed": family_sum("lmstudio_inflight_failed_retryable_total"),
        }

    @staticmethod
    def _cum_at(pairs: list[tuple[float, float]], edge: float) -> float:
        """Cumulative count at ``edge`` for a sorted elided bucket list:
        the renderer only prints edges whose delta is non-zero, so the
        cumulative function is exactly the value at the largest printed
        edge <= ``edge`` (0 before the first)."""
        cum = 0.0
        for e, c in pairs:
            if e > edge:
                break
            cum = c
        return cum

    def observe(self, now: float,
                per_worker: dict[str, dict]) -> list[dict]:
        """Record one scrape tick and return any alerts to publish."""
        self._snaps.append((now, per_worker))
        # keep exactly one snapshot at/older than the slow window start so
        # the baseline lookup always has an anchor
        while len(self._snaps) >= 2 and self._snaps[1][0] <= now - self.window_s:
            self._snaps.popleft()

        slow = self._window_deltas(now, self.window_s)
        fast = self._window_deltas(now, self.fast_window_s)
        alerts: list[dict] = []
        for objective in self.OBJECTIVES:
            burn_fast, observed_fast = self._burn(objective, fast)
            burn_slow, observed_slow = self._burn(objective, slow)
            self.last_burns[objective] = {
                "fast": round(burn_fast, 4), "slow": round(burn_slow, 4),
            }
            if burn_fast < 1.0 or burn_slow < 1.0:
                continue
            if now - self._last_alert.get(objective, -_INF) < self.min_alert_gap_s:
                continue
            self._last_alert[objective] = now
            alerts.append({
                "objective": objective,
                "target": self._target(objective),
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "observed_fast": round(observed_fast, 4),
                "observed_slow": round(observed_slow, 4),
                "window_s": self.window_s,
                "fast_window_s": self.fast_window_s,
                "per_worker": {
                    wid: self._worker_breakdown(d) for wid, d in slow.items()
                },
            })
        return alerts

    def _target(self, objective: str) -> float:
        return {"ttft_p95": self.ttft_p95_ms, "served_ratio": self.served_ratio,
                "shed_rate": self.shed_ratio}[objective]

    def _window_deltas(self, now: float, win_s: float) -> dict[str, dict]:
        if not self._snaps:
            return {}
        base = self._snaps[0][1]
        for t, snap in self._snaps:
            if t <= now - win_s:
                base = snap
            else:
                break
        cur = self._snaps[-1][1]
        out: dict[str, dict] = {}
        for wid, s in cur.items():
            b = base.get(wid) or {"ttft": [], "requests": 0.0, "sheds": 0.0,
                                  "failed": 0.0}
            base_pairs = sorted(b["ttft"])
            ttft = [
                (edge, max(0.0, cum - self._cum_at(base_pairs, edge)))
                for edge, cum in sorted(s["ttft"])
            ]
            out[wid] = {
                "ttft": ttft,
                "requests": max(0.0, s["requests"] - b["requests"]),
                "sheds": max(0.0, s["sheds"] - b["sheds"]),
                "failed": max(0.0, s["failed"] - b["failed"]),
            }
        return out

    @staticmethod
    def _worker_breakdown(d: dict) -> dict:
        m = merge([d["ttft"]])
        return {
            "ttft_p95_ms": round(m.quantile(0.95), 3),
            "ttft_count": int(m.count),
            "requests": d["requests"],
            "sheds": d["sheds"],
            "failed": d["failed"],
        }

    def _burn(self, objective: str, deltas: dict[str, dict]) -> tuple[float, float]:
        """``(burn_rate, observed_value)`` for one objective over one
        window's per-worker deltas. An idle window burns 0.0 — no traffic
        is not an SLO violation."""
        requests = sum(d["requests"] for d in deltas.values())
        if objective == "ttft_p95":
            m = merge(d["ttft"] for d in deltas.values())
            if m.count <= 0:
                return 0.0, 0.0
            p95 = m.quantile(0.95)
            return p95 / max(1e-9, self.ttft_p95_ms), p95
        if requests <= 0:
            return 0.0, 0.0 if objective == "shed_rate" else 1.0
        sheds = sum(d["sheds"] for d in deltas.values())
        failed = sum(d["failed"] for d in deltas.values())
        if objective == "served_ratio":
            bad_frac = min(1.0, (sheds + failed) / requests)
            budget = max(1e-9, 1.0 - self.served_ratio)
            return bad_frac / budget, 1.0 - bad_frac
        shed_frac = min(1.0, sheds / requests)
        return shed_frac / max(1e-9, self.shed_ratio), shed_frac


# --- the collector ----------------------------------------------------------


class Aggregator:
    """The cluster collector; see the module docstring for the three jobs.

    ``nc`` is an already-connected client owned by the caller (main.py's
    ``obs`` subcommand, an embedding router process, or a test harness);
    ``start()``/``stop()`` manage only subscriptions and the scrape loop.
    """

    def __init__(self, nc, *, prefix: str = "lmstudio",
                 scrape_interval_s: float = 2.0, stale_after_s: float = 5.0,
                 scrape_timeout_s: float | None = None,
                 slo: SloEvaluator | None = None,
                 slo_ttft_p95_ms: float = 2000.0, slo_window_s: float = 60.0,
                 slo_served_ratio: float = 0.99, slo_shed_ratio: float = 0.05,
                 extra_expositions: list | None = None):
        self.nc = nc
        self.prefix = prefix
        # zero-arg callables, each returning exposition text merged into
        # render_cluster() — how an embedded autoscaler's families ride the
        # cluster scrape without a second process
        self.extra_expositions = list(extra_expositions or [])
        self.scrape_interval_s = scrape_interval_s
        self.stale_after_s = stale_after_s
        self.scrape_timeout_s = (scrape_timeout_s if scrape_timeout_s is not None
                                 else max(1.0, scrape_interval_s))
        self.slo = slo or SloEvaluator(
            ttft_p95_ms=slo_ttft_p95_ms, window_s=slo_window_s,
            served_ratio=slo_served_ratio, shed_ratio=slo_shed_ratio,
            # the fast window cannot resolve faster than the scrape cadence
            fast_window_s=max(2 * scrape_interval_s, slo_window_s / 12.0),
        )
        self.spans = SpanStore()
        self._members: dict[str, dict] = {}  # wid -> {"mono": t, "advert": {}}
        self._last_texts: dict[str, str] = {}
        self._cluster_ttft_p95 = 0.0
        self.scrapes_total = 0
        self.scrape_errors_total = 0
        self.span_batches_total = 0
        self.alerts_total = 0
        self._subs: list = []
        self._task: asyncio.Task | None = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self, *, scrape_loop: bool = True) -> None:
        sub = await self.nc.subscribe(f"{self.prefix}.cluster.adverts",
                                      cb=self._on_advert)
        self._subs.append(sub)
        sub = await self.nc.subscribe(f"{self.prefix}.{SPANS_SUBJECT}",
                                      cb=self._on_spans)
        self._subs.append(sub)
        # request/reply surfaces share a queue group: replicas all hold the
        # full span/metric state (spans and adverts are broadcast), so any
        # one member can answer
        sub = await self.nc.subscribe(f"{self.prefix}.{CLUSTER_METRICS_SUBJECT}",
                                      queue=OBS_QUEUE_GROUP,
                                      cb=self._on_cluster_metrics)
        self._subs.append(sub)
        sub = await self.nc.subscribe(f"{self.prefix}.{TRACE_QUERY_PREFIX}.>",
                                      queue=OBS_QUEUE_GROUP,
                                      cb=self._on_trace_query)
        self._subs.append(sub)
        if scrape_loop:
            self._task = asyncio.ensure_future(self._scrape_loop())
        log.info("aggregator up: prefix=%s scrape=%.1fs", self.prefix,
                 self.scrape_interval_s)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for sub in self._subs:
            try:
                await sub.unsubscribe()
            except (ConnectionError, ValueError):
                pass
        self._subs.clear()

    # -- membership ----------------------------------------------------------

    async def _on_advert(self, msg) -> None:
        try:
            d = json.loads(msg.payload or b"{}")
        except ValueError:
            return
        wid = d.get("worker_id") if isinstance(d, dict) else None
        if not wid:
            return
        self._members[wid] = {"mono": time.monotonic(), "advert": d}

    def live_workers(self) -> list[str]:
        """Workers advertising within the staleness window. Draining workers
        stay scrapable — their final counters are exactly what a drain
        post-mortem needs. Gateway adverts (role "gateway") are scraped
        (see :meth:`_scrape_targets`) but are not workers: they must not
        count toward ``lmstudio_cluster_workers`` or scaling signals."""
        now = time.monotonic()
        return sorted(
            wid for wid, m in self._members.items()
            if now - m["mono"] <= self.stale_after_s
            and m["advert"].get("role") != "gateway"
        )

    def _scrape_targets(self) -> list[str]:
        """Everything advertising a directed ``metrics.prom`` subject —
        live workers plus gateway-role members, whose lmstudio_gateway_*
        families fold into the cluster exposition."""
        now = time.monotonic()
        return sorted(
            wid for wid, m in self._members.items()
            if now - m["mono"] <= self.stale_after_s
        )

    # -- scraping + merging --------------------------------------------------

    async def _scrape_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.scrape_interval_s)
                try:
                    await self.scrape_once()
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — the loop must survive a bad tick
                    log.exception("scrape tick failed")
        except asyncio.CancelledError:
            return

    async def scrape_once(self) -> dict[str, str]:
        """One scrape tick: request every advert member's directed exposition
        (workers AND gateway-role members), refresh the merged view, advance
        the SLO windows, publish alerts. Returns the WORKER texts only —
        gateway expositions fold into :meth:`render_cluster` but carry no
        serving signals, so they stay out of the SLO windows and out of the
        callers' per-worker view."""
        # prune long-dead members so the map cannot grow without bound
        now_mono = time.monotonic()
        for wid in [w for w, m in self._members.items()
                    if now_mono - m["mono"] > 10 * self.stale_after_s]:
            del self._members[wid]
        members = self._scrape_targets()
        results = await asyncio.gather(
            *(self.nc.request(f"{self.prefix}.worker.{wid}.metrics.prom", b"",
                              timeout=self.scrape_timeout_s)
              for wid in members),
            return_exceptions=True,
        )
        texts: dict[str, str] = {}
        for wid, res in zip(members, results):
            if isinstance(res, BaseException):
                self.scrape_errors_total += 1
            else:
                texts[wid] = res.payload.decode("utf-8", errors="replace")
        self.scrapes_total += 1
        self._last_texts = texts
        workers = set(self.live_workers())
        texts = {wid: t for wid, t in texts.items() if wid in workers}

        per_worker = {
            wid: SloEvaluator.sample_from_exposition(t) for wid, t in texts.items()
        }
        self._cluster_ttft_p95 = merge(
            s["ttft"] for s in per_worker.values()
        ).quantile(0.95)
        for alert in self.slo.observe(time.monotonic(), per_worker):
            await self._publish_alert(alert)
        return texts

    def render_cluster(self) -> str:
        """The merged cluster exposition: every worker family (minus the
        worker_id label) plus the aggregator's own lmstudio_cluster_*
        families."""
        r = PromRenderer()
        texts = [self._last_texts[w] for w in sorted(self._last_texts)]
        for fn in self.extra_expositions:
            try:
                texts.append(fn())
            except Exception:  # noqa: BLE001 — a co-tenant must not break the scrape
                log.exception("extra exposition source failed")
        merge_into(r, texts)
        r.gauge("lmstudio_cluster_workers", len(self.live_workers()),
                help="workers advertising within the staleness window")
        r.counter("lmstudio_cluster_scrapes_total", self.scrapes_total,
                  help="aggregator scrape ticks")
        r.counter("lmstudio_cluster_scrape_errors_total",
                  self.scrape_errors_total,
                  help="per-worker scrape requests that timed out or failed")
        r.counter("lmstudio_cluster_span_batches_total", self.span_batches_total,
                  help="span batches ingested from {prefix}.obs.spans")
        r.counter("lmstudio_cluster_spans_total", self.spans.spans_total,
                  help="individual spans ingested")
        r.gauge("lmstudio_cluster_traces", len(self.spans),
                help="distinct trace ids currently held for assembly")
        r.gauge("lmstudio_cluster_ttft_p95_ms",
                round(self._cluster_ttft_p95, 3),
                help="cluster TTFT p95 merged delta-first across the last "
                     "scrape (upper bucket edge, same code path as bench.py)")
        r.counter("lmstudio_cluster_slo_alerts_total", self.alerts_total,
                  help="slo_burn events published")
        for objective, burns in sorted(self.slo.last_burns.items()):
            for window in ("fast", "slow"):
                r.gauge("lmstudio_cluster_slo_burn", burns[window],
                        labels={"objective": objective, "window": window},
                        help="latest burn rate per objective and window "
                             "(>= 1.0 in BOTH windows fires slo_burn)")
        return r.render()

    # -- alerts --------------------------------------------------------------

    async def _publish_alert(self, alert: dict) -> None:
        self.alerts_total += 1
        emit("slo_burn", **alert)
        log.warning("slo_burn: %s burn_fast=%.2f burn_slow=%.2f",
                    alert["objective"], alert["burn_fast"], alert["burn_slow"])
        try:
            await self.nc.publish(
                f"{self.prefix}.events",
                json.dumps({"kind": "slo_burn", **alert},
                           separators=(",", ":")).encode(),
            )
        except (ConnectionError, ValueError):
            pass  # reconnect in flight; the alert still sits in the ring

    # -- request/reply surfaces ----------------------------------------------

    async def _on_spans(self, msg) -> None:
        try:
            d = json.loads(msg.payload or b"{}")
        except ValueError:
            return
        spans = d.get("spans") if isinstance(d, dict) else None
        if not isinstance(spans, list):
            return
        self.span_batches_total += 1
        for s in spans:
            self.spans.add(s)

    async def _on_cluster_metrics(self, msg) -> None:
        if not msg.reply:
            return
        try:
            await msg.respond(self.render_cluster().encode())
        except (ConnectionError, ValueError):
            pass

    async def _on_trace_query(self, msg) -> None:
        if not msg.reply:
            return
        want = f"{self.prefix}.{TRACE_QUERY_PREFIX}."
        trace_id = (msg.subject[len(want):]
                    if msg.subject.startswith(want) else "")
        spans = self.spans.get(trace_id)
        if spans:
            env: dict = {"ok": True, "data": assemble_trace(trace_id, spans)}
        else:
            env = {"ok": False,
                   "error": f"no spans recorded for trace {trace_id!r}"}
        try:
            await msg.respond(json.dumps(env, separators=(",", ":")).encode())
        except (ConnectionError, ValueError):
            pass
