"""Distributed observability for the multi-party mesh (DESIGN.md §17).

Three pieces glue the per-process instruments (:mod:`repro_torch.obs.trace`,
:mod:`repro_torch.obs.metrics`) into one mesh-wide view:

* **Trace propagation + merge** — the coordinator mints a ``trace_id`` per
  traced query and ships a :class:`TraceContext` inside the ``execute``
  control frame; each party runs the query under a fresh per-query
  :class:`~repro_torch.obs.trace.Tracer` carrying that id and ships its (already
  redacted) spans back in the reply. :func:`merge_party_spans` folds the
  three shipments into the coordinator's tracer: span ids are renumbered
  into the coordinator's id space, party root spans are re-parented under
  the coordinator's ``execute`` span, and party timestamps are normalized
  onto the coordinator's clock via :func:`clock_offset` (an NTP-style
  midpoint estimate over the control-frame send/receive timestamps). Every
  shipped attribute dict is re-audited against the disclosure deny-list on
  arrival — a misbehaving (or stale-versioned) party process cannot smuggle
  a secret-keyed attribute into the exported trace.

* **Flame-graph export** — :func:`chrome_trace` /
  :func:`write_chrome_trace` render any span list as Chrome trace-event
  JSON (``chrome://tracing`` / Perfetto ``ui.perfetto.dev``): one complete
  ("ph":"X") event per span, one track per party plus a coordinator track.

* **Wire metrics publication** — :class:`WireMetricsPublisher` maps the
  JSON-safe per-link snapshots that party processes return from the
  ``stats`` control verb (see ``runtime/transport.py:WireStats``) onto
  ``reflex_wire_*`` counters/gauges in a coordinator-side
  :class:`~repro_torch.obs.metrics.MetricsRegistry`, tagged with a ``party``
  label. Counters are advanced by snapshot *delta* (pulled totals are
  monotonic per process), so repeated ``status()`` pulls never double
  count. Label names pass the same ``audit_labels`` deny-list gate as every
  other metric.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Union

from . import redact
from .metrics import MetricsRegistry
from .trace import Span, Tracer

__all__ = [
    "TraceContext",
    "new_trace_id",
    "clock_offset",
    "merge_party_spans",
    "chrome_trace",
    "write_chrome_trace",
    "WireMetricsPublisher",
]


def new_trace_id() -> str:
    """Opaque 16-hex-char trace identity (no secret derivation: pure OS
    entropy, safe to print anywhere)."""
    return os.urandom(8).hex()


@dataclasses.dataclass
class TraceContext:
    """What the ``execute`` control frame carries to each party: the trace
    identity and the coordinator-side span the party's spans hang under."""

    trace_id: str
    parent_span_id: Optional[int] = None

    def to_dict(self) -> Dict:
        return {
            "trace_id": self.trace_id,
            "parent_span_id": self.parent_span_id,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "TraceContext":
        return cls(
            trace_id=str(d["trace_id"]),
            parent_span_id=d.get("parent_span_id"),
        )


def clock_offset(
    t_send: float, t_recv: float, t_reply: float, t_ack: float
) -> float:
    """NTP-style offset of a party's clock relative to the coordinator's.

    ``t_send``/``t_ack`` are coordinator wall clocks around one control round
    trip; ``t_recv``/``t_reply`` are the party's wall clocks for the same
    frames. Returns ``offset`` such that ``party_ts - offset`` lands on the
    coordinator's timeline (accurate to half the round-trip asymmetry —
    microseconds on localhost, and only ever used for display alignment,
    never for protocol decisions)."""
    return ((t_recv - t_send) + (t_reply - t_ack)) / 2.0


def merge_party_spans(
    tracer: Tracer, parent: Span, shipments: Sequence[Dict]
) -> int:
    """Fold party-shipped span lists into the coordinator's tracer.

    Each shipment is one party's execute-reply excerpt::

        {"party": p, "trace_id": ..., "spans": [span dicts],
         "clock": {"t_recv": ..., "t_reply": ...},   # party wall clock
         "t_send": ..., "t_ack": ...}                # coordinator wall clock

    Per shipment: verify the trace identity, re-audit every attribute dict
    against the disclosure deny-list (:func:`repro_torch.obs.redact
    .assert_emittable` — party tracers redact at source, but the coordinator
    does not trust the wire), renumber span ids after the coordinator's
    current counter, re-parent roots under ``parent``, and shift timestamps
    by the estimated clock offset. Returns the number of spans merged."""
    want = tracer.ensure_trace_id()
    merged = 0
    for ship in shipments:
        spans = ship.get("spans")
        if not spans:
            continue
        party = ship.get("party")
        got = ship.get("trace_id")
        if got is not None and got != want:
            raise ValueError(
                f"party {party} shipped spans for trace {got!r}, "
                f"expected {want!r}"
            )
        clk = ship.get("clock") or {}
        off = 0.0
        if {"t_recv", "t_reply"} <= set(clk) and \
                ship.get("t_send") is not None and \
                ship.get("t_ack") is not None:
            off = clock_offset(
                ship["t_send"], clk["t_recv"], clk["t_reply"], ship["t_ack"]
            )
        base = tracer._next_id
        top = 0
        for sd in spans:
            attrs = dict(sd.get("attrs") or {})
            redact.assert_emittable(
                attrs, where=f"party {party} span {sd.get('name')!r}"
            )
            sid = int(sd["span_id"])
            top = max(top, sid)
            pid = sd.get("parent_id")
            if pid is None:
                # party root: hangs under the coordinator's execute span
                new_parent: Optional[int] = parent.span_id
                attrs.setdefault("clock_offset_s", round(off, 6))
            else:
                new_parent = base + int(pid)
            tracer.spans.append(Span(
                name=str(sd["name"]),
                span_id=base + sid,
                parent_id=new_parent,
                ts=float(sd["ts"]) - off,
                seconds=float(sd.get("seconds", 0.0)),
                attrs=attrs,
            ))
            merged += 1
        tracer._next_id = base + top
    return merged


# -----------------------------------------------------------------------------
# Chrome trace-event / Perfetto export
# -----------------------------------------------------------------------------

def _span_dicts(spans: Union[Tracer, Iterable]) -> List[Dict]:
    if isinstance(spans, Tracer):
        spans = spans.spans
    out = []
    for s in spans:
        out.append(s.to_dict() if isinstance(s, Span) else dict(s))
    return out


def chrome_trace(
    spans: Union[Tracer, Iterable], trace_id: Optional[str] = None
) -> Dict:
    """Chrome trace-event JSON for ``chrome://tracing`` / Perfetto.

    One complete ("ph":"X") event per span; the track (``tid``) is the
    party id, with the coordinator's spans on their own track. Timestamps
    are already clock-normalized by :func:`merge_party_spans`, so the
    per-party tracks line up on one timeline."""
    sds = _span_dicts(spans)
    if trace_id is None and isinstance(spans, Tracer):
        trace_id = spans.trace_id
    t0 = min((sd["ts"] for sd in sds), default=0.0)
    events: List[Dict] = []
    tracks = set()
    for sd in sds:
        attrs = sd.get("attrs") or {}
        party = attrs.get("party")
        tid = int(party) + 1 if party is not None else 0
        tracks.add(tid)
        events.append({
            "name": sd["name"],
            "cat": "reflex",
            "ph": "X",
            "pid": 1,
            "tid": tid,
            "ts": (sd["ts"] - t0) * 1e6,           # microseconds
            "dur": max(sd.get("seconds", 0.0), 0.0) * 1e6,
            "args": attrs,
        })
    meta = [{
        "name": "process_name", "ph": "M", "pid": 1,
        "args": {"name": "reflex query"},
    }]
    for tid in sorted(tracks):
        label = "coordinator" if tid == 0 else f"party {tid - 1}"
        meta.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": label},
        })
    out: Dict = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    if trace_id is not None:
        out["otherData"] = {"trace_id": trace_id}
    return out


def write_chrome_trace(
    path: str, spans: Union[Tracer, Iterable],
    trace_id: Optional[str] = None,
) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans, trace_id=trace_id), f, default=float)


# -----------------------------------------------------------------------------
# Wire metrics: party snapshots -> coordinator registry
# -----------------------------------------------------------------------------

class WireMetricsPublisher:
    """Publish per-party ``WireStats`` snapshots into a MetricsRegistry.

    Snapshots are cumulative per process; counters here advance by delta so
    any number of ``status()`` pulls is safe. Gauges (sequence watermarks,
    link liveness) are set to the latest value."""

    def __init__(self, registry: MetricsRegistry):
        m = registry
        self.frames = m.counter(
            "reflex_wire_frames_total",
            "Frames sent per directed link, by frame kind",
            ("party", "link", "kind"),
        )
        self.bytes = m.counter(
            "reflex_wire_bytes_total",
            "Body bytes sent per directed link, by frame kind "
            "(DATA bytes equal the ledger's analytic tallies by audit)",
            ("party", "link", "kind"),
        )
        self.send_s = m.counter(
            "reflex_wire_send_seconds_total",
            "Local send-path seconds per directed link (enqueue + flush)",
            ("party", "link"),
        )
        self.wait_s = m.counter(
            "reflex_wire_recv_wait_seconds_total",
            "Seconds blocked waiting for inbound frames per directed link",
            ("party", "link"),
        )
        self.rejects = m.counter(
            "reflex_wire_rejects_total",
            "Rejected inbound frames by reason (crc / seq / torn-frame)",
            ("party", "reason"),
        )
        self.retries = m.counter(
            "reflex_wire_connect_retries_total",
            "TCP dial attempts that had to be retried, per peer",
            ("party", "peer"),
        )
        self.backoff_s = m.counter(
            "reflex_wire_connect_backoff_seconds_total",
            "Seconds slept in (jittered) dial backoff, per peer",
            ("party", "peer"),
        )
        self.sent_seq = m.gauge(
            "reflex_wire_sent_seq",
            "Outbound sequence watermark per directed link",
            ("party", "link"),
        )
        self.recv_seq = m.gauge(
            "reflex_wire_recv_seq",
            "Inbound sequence watermark per directed link",
            ("party", "link"),
        )
        self.link_up = m.gauge(
            "reflex_wire_link_up",
            "1 if the directed link is registered and answering",
            ("party", "link"),
        )
        self.rtt = m.histogram(
            "reflex_ctrl_roundtrip_seconds",
            "Coordinator-observed control round-trip time per party",
            ("party",),
        )
        self._last: Dict = {}

    def _delta(self, key, new: float) -> float:
        old = self._last.get(key, 0.0)
        self._last[key] = new
        return max(new - old, 0.0)

    def publish(self, snapshot: Dict) -> None:
        """Fold one process's wire snapshot into the registry."""
        p = str(snapshot.get("party"))
        for e in snapshot.get("sent", ()):
            lk, kd = e["link"], e["kind"]
            self.frames.inc(
                self._delta(("sf", p, lk, kd), e["frames"]),
                party=p, link=lk, kind=kd,
            )
            self.bytes.inc(
                self._delta(("sb", p, lk, kd), e["bytes"]),
                party=p, link=lk, kind=kd,
            )
            self.send_s.inc(
                self._delta(("ss", p, lk, kd), e["seconds"]),
                party=p, link=lk,
            )
        for e in snapshot.get("recv", ()):
            lk = e["link"]
            self.wait_s.inc(
                self._delta(("rw", p, lk, e["kind"]), e["seconds"]),
                party=p, link=lk,
            )
        for e in snapshot.get("rejects", ()):
            self.rejects.inc(
                self._delta(("rj", p, e["reason"]), e["count"]),
                party=p, reason=e["reason"],
            )
        for e in snapshot.get("connects", ()):
            pr = str(e["peer"])
            self.retries.inc(
                self._delta(("cr", p, pr), e["retries"]),
                party=p, peer=pr,
            )
            self.backoff_s.inc(
                self._delta(("cb", p, pr), e["backoff_seconds"]),
                party=p, peer=pr,
            )
        for e in snapshot.get("links", ()):
            lk = e["link"]
            self.sent_seq.set(e["sent"], party=p, link=lk)
            self.recv_seq.set(e["recv"], party=p, link=lk)
            self.link_up.set(1.0, party=p, link=lk)

    def observe_roundtrip(self, party, seconds: float) -> None:
        self.rtt.observe(float(seconds), party=str(party))
