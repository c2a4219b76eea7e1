"""Prometheus text exposition (version 0.0.4) rendering.

Copy of ``nats_llm_studio_tpu/obs/prom.py`` (``PromRenderer``), whole.

One renderer per scrape: metrics registered under the same family name
share a single ``# TYPE`` line regardless of how many label sets (e.g.
per-model batcher histograms) contribute samples — duplicate TYPE lines
are invalid exposition and real scrapers reject them.
"""

from __future__ import annotations

from .histogram import HistSnapshot


def _escape(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(labels: dict[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _num(v: float) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class PromRenderer:
    def __init__(self, default_labels: dict[str, str] | None = None) -> None:
        # family name -> (type, help, [sample lines])
        self._families: dict[str, tuple[str, str | None, list[str]]] = {}
        # merged under every sample's labels (explicit labels win): the
        # worker stamps worker_id here so a multi-worker scrape stays
        # attributable without threading the label through every call site
        self._default_labels = dict(default_labels or {})

    def _merged(self, labels: dict | None) -> dict | None:
        if not self._default_labels:
            return labels
        return {**self._default_labels, **(labels or {})}

    def _family(self, name: str, typ: str, help_: str | None) -> list[str]:
        fam = self._families.get(name)
        if fam is None:
            fam = (typ, help_, [])
            self._families[name] = fam
        elif fam[0] != typ:
            raise ValueError(f"metric {name} registered as both {fam[0]} and {typ}")
        return fam[2]

    def counter(self, name: str, value: float, labels: dict | None = None,
                help: str | None = None) -> None:
        self._family(name, "counter", help).append(
            f"{name}{_labels(self._merged(labels))} {_num(value)}"
        )

    def gauge(self, name: str, value: float, labels: dict | None = None,
              help: str | None = None) -> None:
        self._family(name, "gauge", help).append(
            f"{name}{_labels(self._merged(labels))} {_num(value)}"
        )

    def histogram(self, name: str, snap: HistSnapshot, labels: dict | None = None,
                  help: str | None = None) -> None:
        lines = self._family(name, "histogram", help)
        base = dict(self._merged(labels) or {})
        cum = 0
        for bound, c in zip(snap.bounds, snap.counts):
            cum += c
            if c == 0:
                continue  # elide empty buckets; the cumulative counts stay exact
            lines.append(
                f'{name}_bucket{_labels({**base, "le": _num(float(bound))})} {cum}'
            )
        lines.append(f'{name}_bucket{_labels({**base, "le": "+Inf"})} {snap.count}')
        lines.append(f"{name}_sum{_labels(base)} {_num(round(snap.total, 6))}")
        lines.append(f"{name}_count{_labels(base)} {snap.count}")

    def render(self) -> str:
        out: list[str] = []
        for name, (typ, help_, lines) in self._families.items():
            if help_:
                out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {typ}")
            out.extend(lines)
        return "\n".join(out) + "\n"
