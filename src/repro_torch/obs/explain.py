"""EXPLAIN / EXPLAIN ANALYZE: the placed plan as an annotated tree.

``EXPLAIN`` renders the physical plan with the cost model's *estimates*
(rows = the post-trim oblivious size the planner expects, bytes = the
per-node share of the analytic comm cost). ``EXPLAIN ANALYZE`` adds the
*actuals* from an :class:`~repro_torch.engine.executor.ExecutionReport`: per-node
oblivious output rows, wall seconds, MiB/party, synchronous rounds, and —
for Resize nodes — the resizer strategy with its trim outcome.

Every value printed here passes the disclosure audit
(:mod:`repro_torch.obs.redact`): estimated rows come from public catalog sizes and
already-disclosed calibration; actual rows are oblivious capacities; the trim
column shows only the revealed S / padded S the accountant charged for —
never the true cardinality T or the noise draw.

The engine fills reports in post-order (children before parents), which is
exactly a post-order walk of the plan tree — :func:`explain_text` zips the
two and renders pre-order with indentation.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..plan.nodes import PlanNode, Resize
from . import redact

__all__ = ["explain_text"]

_COLS = (
    ("est.rows", 9),
    ("act.rows", 9),
    ("sec", 9),
    ("MiB/party", 11),
    ("rounds", 8),
    ("offline", 9),
    ("net stall", 10),
)


def _post_order(plan: PlanNode) -> List[PlanNode]:
    out: List[PlanNode] = []

    def walk(n: PlanNode) -> None:
        for c in n.children():
            walk(c)
        out.append(n)

    walk(plan)
    return out


def _estimates(plan: PlanNode, cost_model) -> Dict[int, Dict]:
    """One bottom-up pass: id(node) -> {"n","t","cols","bytes","own_bytes"}
    (the registry's "bytes" is cumulative; own_bytes subtracts children)."""
    out: Dict[int, Dict] = {}
    if cost_model is None:
        return out

    def walk(node: PlanNode) -> Dict:
        children = [walk(c) for c in node.children()]
        from ..plan.registry import lookup

        est = lookup(type(node)).estimate(node, children, cost_model)
        if cost_model.calibration is not None:
            est = cost_model.calibration.refine(node, est, cost_model.noise)
        est = dict(est)
        est["own_bytes"] = max(
            est["bytes"] - sum(c["bytes"] for c in children), 0.0
        )
        out[id(node)] = est
        return est

    walk(plan)
    return out


def _offline_note(extra: Optional[Dict]) -> str:
    """Hot-vs-cold correlated-randomness column: how many of this node's
    pool fetches were served precomputed (hits) vs derived on demand
    (misses). Counts are cache bookkeeping over template-keyed material —
    see obs/redact.py for the disclosure argument."""
    if not extra:
        return "-"
    off = redact.public_view(extra).get("offline")
    if not off:
        return "-"
    h, m = int(off.get("hits", 0)), int(off.get("misses", 0))
    if m == 0:
        return f"hot {h}"
    if h == 0:
        return f"cold {m}"
    return f"{h}h/{m}c"


def _stall_note(extra: Optional[Dict]) -> str:
    """Network-attribution column (networked runs only): seconds this node's
    exchanges spent blocked on inbound frames, from the executor's
    per-node ``extra["wire"]`` delta. In-process runs have no wire and
    render "-". Stall is the report party's own view (party 0's in
    networked mode) — wall-clock, never part of the cross-party audit."""
    if not extra:
        return "-"
    wire = redact.public_view(extra).get("wire")
    if not wire:
        return "-"
    return f"{float(wire.get('stall_seconds', 0.0)):.3f}"


def _trim_note(node: PlanNode, extra: Optional[Dict]) -> str:
    """Resize annotation from the report's (redacted) reveal-and-trim info."""
    if not isinstance(node, Resize):
        return ""
    if extra is None:  # plain EXPLAIN: strategy only (it's in the label too)
        return node.cfg.describe()
    pub = redact.public_view(extra)
    if pub.get("skipped"):
        return "trim skipped (NoTrim: nothing disclosed)"
    s, sp = pub.get("s"), pub.get("s_padded")
    note = f"S={s}" if s is not None else "S=?"
    if sp is not None and sp != s:
        note += f" pad->{sp}"
    return note


def explain_text(
    plan: PlanNode,
    cost_model=None,
    report=None,
    title: Optional[str] = None,
    wire_audit: Optional[List[Dict]] = None,
) -> str:
    """Render ``plan`` as an indented tree with estimated vs actual columns.

    ``report`` is an :class:`ExecutionReport` whose ``nodes`` were filled by
    executing this exact plan (post-order); pass None for plain EXPLAIN.
    ``wire_audit`` (networked mode) appends a per-party wire trailer —
    bytes on the wire and total network stall per party — below TOTAL; it
    is omitted entirely when empty, so in-process output is unchanged.
    """
    order = _post_order(plan)
    actual: Dict[int, object] = {}
    if report is not None:
        if len(report.nodes) != len(order):
            raise ValueError(
                f"report has {len(report.nodes)} node entries for a plan "
                f"with {len(order)} nodes — not this plan's report"
            )
        actual = {id(n): s for n, s in zip(order, report.nodes)}
    est = _estimates(plan, cost_model)

    name_w = max(
        [42] + [len("  " * d + n.describe()) + 2 for n, d in _depths(plan)]
    )
    header = f"{'plan':<{name_w}}" + "".join(
        f"{h:>{w}}" for h, w in _COLS
    ) + "  resize"
    lines = [header] if title is None else [title, header]

    for node, depth in _depths(plan):
        label = "  " * depth + node.describe()
        e = est.get(id(node))
        a = actual.get(id(node))
        est_rows = f"{int(e['n'])}" if e else "-"
        act_rows = f"{a.n_out}" if a else "-"
        sec = f"{a.seconds:.3f}" if a else "-"
        mib = f"{a.bytes_per_party / 2**20:.3f}" if a else (
            f"~{e['own_bytes'] / 2**20:.3f}" if e else "-"
        )
        rounds = f"{a.rounds}" if a else "-"
        offline = _offline_note(a.extra if a else None)
        stall = _stall_note(a.extra if a else None)
        note = _trim_note(node, a.extra if a else None)
        lines.append(
            f"{label:<{name_w}}{est_rows:>9}{act_rows:>9}{sec:>9}"
            f"{mib:>11}{rounds:>8}{offline:>9}{stall:>10}  {note}".rstrip()
        )
    if report is not None:
        lines.append(
            f"{'TOTAL':<{name_w}}{'':>9}{'':>9}{report.total_seconds:>9.3f}"
            f"{report.total_bytes / 2**20:>11.3f}{report.total_rounds:>8}"
        )
    if wire_audit:
        parts = "  ".join(
            f"p{a['party']}: {a['wire_bytes']} B wire, "
            f"{a.get('stall_seconds', 0.0):.3f}s stall"
            for a in wire_audit
        )
        lines.append(f"wire: {parts}")
    return "\n".join(lines)


def _depths(plan: PlanNode, depth: int = 0):
    yield plan, depth
    for c in plan.children():
        yield from _depths(c, depth + 1)
