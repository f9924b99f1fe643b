"""Query lifecycle tracing: hierarchical spans with a thread-local stack.

Mirrors the :class:`~repro_torch.core.ledger.CommLedger` pattern: a
:class:`Tracer` is a context manager that pushes itself onto a thread-local
stack; the module-level helpers (:func:`span`, :func:`record`,
:func:`annotate`) log into the innermost active tracer and are **no-ops when
none is active**, so the engine's hot paths pay one truthiness check per node
when tracing is off.

Span taxonomy (DESIGN.md §14.1)::

    query                      one client submit/ticket, root of the tree
      compile                  SQL -> placed physical plan (cache-aware)
      admit                    accountant admission (+ intent journaling)
      schedule.wait            enqueue -> flush latency of a batched ticket
      batch.flush              one scheduler bucket -> engine pass
        execute                one Engine.execute / execute_batch pass
          node[<Op>]           one plan-node protocol (per slot when split)
      reveal                   result opening + post_reveal derivation
      record                   accountant record + calibration flush

Every attribute dict passes through :func:`repro_torch.obs.redact.public_view`
before it is stored — a span can never hold a secret-dependent value, no
matter what the instrumented call site passed (the redaction test suite
pins this). Dropped keys are counted in ``Tracer.redactions``.

Export is structured JSONL (:meth:`Tracer.to_jsonl` / :meth:`Tracer.write`):
one object per span with ``span_id``/``parent_id`` linkage, wall-clock
``ts``, duration ``seconds``, and the redacted ``attrs`` — validated in CI by
``benchmarks/validate_telemetry.py`` against ``benchmarks/telemetry_span_
schema.json``.

Cross-process propagation (DESIGN.md §17): a tracer optionally carries a
``trace_id`` — an opaque hex string naming the whole distributed trace. The
coordinator mints one per traced query (:meth:`Tracer.ensure_trace_id`),
ships it to the party processes in the ``execute`` control frame, and each
party's per-query tracer is constructed with the same id; when set, every
exported span line carries it, so merged multi-process streams stay
attributable to one query. Span ids remain tracer-local — the merge step
(:mod:`repro_torch.obs.distributed`) renumbers them into the coordinator's id
space and re-parents party roots under the coordinator's ``execute`` span.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional

from . import redact

__all__ = ["Span", "Tracer", "active_tracer", "span", "record", "annotate"]

_STATE = threading.local()


def _stack() -> List["Tracer"]:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


@dataclasses.dataclass
class Span:
    name: str
    span_id: int
    parent_id: Optional[int]
    ts: float  # wall-clock start (time.time)
    seconds: float = 0.0
    attrs: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "ts": self.ts,
            "seconds": self.seconds,
            "attrs": self.attrs,
        }


class Tracer:
    """Collects a tree of redacted spans for one traced region.

    ``party`` (optional) stamps every span with the RSS party id whose
    process produced it — the multi-party runtime gives each party server
    its own tracer, so exported span streams from a 3-process mesh can be
    merged and still attribute latency per party."""

    def __init__(
        self,
        party: Optional[int] = None,
        trace_id: Optional[str] = None,
    ) -> None:
        self.party = party
        self.trace_id = trace_id
        self.spans: List[Span] = []
        self.redactions: List[str] = []  # dropped attribute keys (audit trail)
        self._open: List[Span] = []
        self._next_id = 0

    def ensure_trace_id(self) -> str:
        """Mint the distributed trace id on first use (coordinator side).

        Party-side tracers never mint — they are constructed with the id the
        coordinator shipped, so all processes agree on one trace identity."""
        if self.trace_id is None:
            import os

            self.trace_id = os.urandom(8).hex()
        return self.trace_id

    # -- context management ---------------------------------------------------
    def __enter__(self) -> "Tracer":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        top = _stack().pop()
        assert top is self, "Tracer stack corrupted"

    # -- span lifecycle -------------------------------------------------------
    def _new_span(self, name: str, attrs: Dict) -> Span:
        self._next_id += 1
        if self.party is not None:
            attrs = {**attrs, "party": self.party}
        sp = Span(
            name=name,
            span_id=self._next_id,
            parent_id=self._open[-1].span_id if self._open else None,
            ts=time.time(),
            attrs=redact.public_view(attrs, self.redactions),
        )
        self.spans.append(sp)
        return sp

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        sp = self._new_span(name, attrs)
        self._open.append(sp)
        t0 = time.perf_counter()
        try:
            yield sp
        finally:
            sp.seconds = time.perf_counter() - t0
            popped = self._open.pop()
            assert popped is sp, "span stack corrupted"

    def record(self, name: str, seconds: float = 0.0, **attrs) -> Span:
        """A closed span whose duration was measured elsewhere (e.g. the
        scheduler's enqueue->flush wait, the engine's per-node timer)."""
        sp = self._new_span(name, attrs)
        sp.seconds = float(seconds)
        return sp

    def annotate(self, **attrs) -> None:
        """Merge (redacted) attributes into the innermost open span."""
        if self._open:
            self._open[-1].attrs.update(
                redact.public_view(attrs, self.redactions)
            )

    # -- export ---------------------------------------------------------------
    def to_jsonl(self) -> str:
        def line(s: Span) -> Dict:
            d = s.to_dict()
            if self.trace_id is not None:
                d["trace_id"] = self.trace_id
            return d

        return "\n".join(
            json.dumps(line(s), sort_keys=True, default=float)
            for s in self.spans
        )

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            txt = self.to_jsonl()
            f.write(txt + ("\n" if txt else ""))

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


def active_tracer() -> Optional[Tracer]:
    stack = _stack()
    return stack[-1] if stack else None


def span(name: str, **attrs):
    """``active_tracer().span(...)`` or a no-op context when tracing is off."""
    tr = active_tracer()
    if tr is None:
        return contextlib.nullcontext()
    return tr.span(name, **attrs)


def record(name: str, seconds: float = 0.0, **attrs) -> None:
    tr = active_tracer()
    if tr is not None:
        tr.record(name, seconds=seconds, **attrs)


def annotate(**attrs) -> None:
    tr = active_tracer()
    if tr is not None:
        tr.annotate(**attrs)
