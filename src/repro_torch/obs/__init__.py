"""End-to-end query observability (DESIGN.md §14).

Three instruments behind one disclosure audit boundary
(:mod:`repro_torch.obs.redact`):

* :mod:`repro_torch.obs.trace` — hierarchical lifecycle spans (query -> compile ->
  admit -> schedule.wait -> batch.flush -> execute -> node[op] -> reveal ->
  record), thread-local like the :class:`~repro_torch.core.ledger.CommLedger`,
  exported as structured JSONL;
* :mod:`repro_torch.obs.metrics` — a typed metrics registry (counters / gauges /
  histograms with audited label sets) rendered as Prometheus text exposition
  or a JSON snapshot;
* :mod:`repro_torch.obs.explain` — EXPLAIN / EXPLAIN ANALYZE plan-tree rendering
  with estimated-vs-actual rows/seconds/bytes/rounds per node.

Telemetry about intermediate results is itself a disclosure channel
(Shrinkwrap's lesson): every emitted value passes ``redact.public_view`` —
only oblivious capacities and accountant-charged post-reveal sizes are
emittable; the true cardinality T and the noise draws p/eta never leave the
process through any span, metric, or EXPLAIN line.

The port's copy of ``repro.obs`` (which imports no jax): the disclosure
policy (``SECRET_KEYS``, ``PUBLIC_KEYS``, the default-deny ``public_view``)
is the reference's word for word, and ``explain_text`` walks the port's
plan nodes.
"""
from . import redact
from .distributed import (
    TraceContext,
    WireMetricsPublisher,
    chrome_trace,
    clock_offset,
    merge_party_spans,
    write_chrome_trace,
)
from .explain import explain_text
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Span, Tracer, active_tracer, annotate, record, span

__all__ = [
    "redact",
    "explain_text",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "Span",
    "Tracer",
    "active_tracer",
    "annotate",
    "record",
    "span",
    "TraceContext",
    "WireMetricsPublisher",
    "chrome_trace",
    "clock_offset",
    "merge_party_spans",
    "write_chrome_trace",
]
