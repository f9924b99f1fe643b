"""Metrics registry: typed counters/gauges/histograms with explicit labels.

Replaces the service's untyped ``stats`` dict (DESIGN.md §14.2). Every metric
is declared once with a name, help string, and an explicit label vocabulary;
label *names* are audited against the disclosure policy at registration
(:func:`repro_torch.obs.redact.audit_labels`) — a secret-dependent dimension cannot
even be declared. Two renderers:

* :meth:`MetricsRegistry.render_prometheus` — the text exposition format
  (``# HELP`` / ``# TYPE`` + one sample line per label set, histograms as
  cumulative ``_bucket``/``_sum``/``_count``);
* :meth:`MetricsRegistry.snapshot` — a JSON-safe dict for the service's
  ``status()`` API and the CI telemetry validator.

Metric names follow prometheus conventions (``reflex_`` prefix, ``_total``
for counters, ``_seconds``/``_bytes`` units). The registry is per-service —
process-wide signals (the Engine jit cache) are mirrored into gauges at
snapshot time by the service.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from . import redact

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram"]

DEFAULT_BUCKETS = (
    1e-5, 1e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0,
)


def _label_key(labelnames: Tuple[str, ...], labels: Dict) -> Tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}"
        )
    return tuple(str(labels[n]) for n in labelnames)


def _fmt_labels(labelnames: Tuple[str, ...], key: Tuple, extra: str = "") -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(labelnames, key)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        redact.audit_labels(name, labelnames)
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._lock = threading.Lock()

    def _key(self, labels: Dict) -> Tuple:
        return _label_key(self.labelnames, labels)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help, labelnames):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple, float] = {}

    def labels(self, **labels) -> "_CounterChild":
        return _CounterChild(self, self._key(labels))

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def touch(self, **labels) -> None:
        """Materialize a label set at 0 (so e.g. a tenant appears in the
        per-tenant breakdown the moment its session opens)."""
        key = self._key(labels)
        with self._lock:
            self._values.setdefault(key, 0.0)

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        return sum(self._values.values())

    def samples(self) -> List[Tuple[Tuple, float]]:
        return sorted(self._values.items())


class _CounterChild:
    def __init__(self, parent: Counter, key: Tuple):
        self._parent, self._key_ = parent, key

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._parent._lock:
            vals = self._parent._values
            vals[self._key_] = vals.get(self._key_, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help, labelnames):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def samples(self) -> List[Tuple[Tuple, float]]:
        return sorted(self._values.items())


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, buckets: Tuple[float, ...]):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        # per label set: (bucket counts, sum, count)
        self._data: Dict[Tuple, List] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            st = self._data.setdefault(
                key, [[0] * (len(self.buckets) + 1), 0.0, 0]
            )
            st[0][bisect.bisect_left(self.buckets, value)] += 1
            st[1] += float(value)
            st[2] += 1

    def count(self, **labels) -> int:
        st = self._data.get(self._key(labels))
        return 0 if st is None else st[2]

    def sum(self, **labels) -> float:
        st = self._data.get(self._key(labels))
        return 0.0 if st is None else st[1]

    def samples(self) -> List[Tuple[Tuple, List]]:
        return sorted(self._data.items())


class MetricsRegistry:
    """Declare-once, render-anywhere metric store."""

    def __init__(self) -> None:
        self._metrics: "Dict[str, _Metric]" = {}
        self._lock = threading.Lock()

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric) or (
                    existing.labelnames != metric.labelnames
                ):
                    raise ValueError(
                        f"metric {metric.name!r} re-registered with a "
                        "different type or label set"
                    )
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._register(Counter(name, help, tuple(labelnames)))

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, tuple(labelnames)))

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help, tuple(labelnames), buckets))

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    # -- renderers ------------------------------------------------------------
    def render_prometheus(self) -> str:
        """Text exposition format. Every line that leaves here carries only
        declared (audited) label names and numeric samples."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, (counts, total, n) in m.samples():
                    cum = 0
                    for b, c in zip(m.buckets, counts):
                        cum += c
                        le = 'le="%s"' % b
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(m.labelnames, key, le)} {cum}"
                        )
                    le_inf = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(m.labelnames, key, le_inf)} {n}"
                    )
                    lines.append(
                        f"{name}_sum{_fmt_labels(m.labelnames, key)} {total}"
                    )
                    lines.append(
                        f"{name}_count{_fmt_labels(m.labelnames, key)} {n}"
                    )
            else:
                samples = m.samples()
                if not samples:
                    lines.append(f"{name} 0")
                for key, value in samples:
                    lines.append(
                        f"{name}{_fmt_labels(m.labelnames, key)} {value}"
                    )
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict:
        """JSON-safe dump: {metric: {kind, help, samples: [{labels, value}]}}
        (histograms carry sum/count/buckets per label set)."""
        out: Dict = {}
        for name, m in sorted(self._metrics.items()):
            entry: Dict = {"kind": m.kind, "help": m.help,
                           "labelnames": list(m.labelnames)}
            if isinstance(m, Histogram):
                entry["samples"] = [
                    {
                        "labels": dict(zip(m.labelnames, key)),
                        "sum": total,
                        "count": n,
                        "buckets": {str(b): c for b, c in
                                    zip(m.buckets, counts)},
                    }
                    for key, (counts, total, n) in m.samples()
                ]
            else:
                entry["samples"] = [
                    {"labels": dict(zip(m.labelnames, key)), "value": v}
                    for key, v in m.samples()
                ]
            out[name] = entry
        return out
