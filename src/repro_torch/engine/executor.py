"""Query execution engine.

Executes a plan tree bottom-up, eagerly. Every operator protocol runs on
static shapes; the only place a public size changes is a ``Resize`` node's
reveal-and-trim. Each node runs under its own :class:`CommLedger` and the
engine records a per-node report: wall seconds (on the card, after a
``torch.cuda.synchronize()``), the ledger's (rounds, bytes/party), and the
input/output oblivious sizes. The engine's ``RuntimeConfig`` holds for the
whole execution (:func:`~repro_torch.config.use_config`; ``None`` leaves the
``REPRO_*`` environment fallback in effect), as in the reference. A port of
``repro.engine.executor``.

Batched execution (DESIGN.md §11): :meth:`Engine.execute_batch` runs K
structurally identical plans as one engine pass. Each stateless node's
protocol runs once under ``torch.func.vmap`` over the K slots' tables,
stacked along a new leading axis; the protocol keeps per-slot shapes, so
its PRF draws are per-slot draws, unbatched and the same for every slot,
and each kernel launch serves all K slots (the kernels' batch rules,
:mod:`repro_torch.kernels`). Every slot's shares and per-node ledger are
therefore bit-identical to a serial :meth:`execute` of that query. Resize
nodes run per slot, each with its own noise counter; if the revealed trim
sizes diverge, the batch splits into per-slot execution for the rest of the
plan.

The reference's per-operator jit cache (``jit_ops``) has no counterpart
yet: it waits for CUDA graphs (ROADMAP.md, Queue 2, "CUDA graphs over
host-bound loops").
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from ..config import RuntimeConfig, resolve_device, use_config
from ..core import material, threefry
from ..core.ledger import CommLedger, active_exchange, batched_tally
from ..core.prf import PRFSetup, setup_prf
from ..obs import redact
from ..obs import trace as obs_trace
from ..ops.table import SecretTable
from ..plan.nodes import PlanNode
from ..plan.registry import infer_schema, lookup, plan_batchable
from ..sql.catalog import Catalog

__all__ = ["Engine", "ExecutionReport", "NodeStats"]


@dataclasses.dataclass
class NodeStats:
    node: str
    n_in: int  # first input's oblivious size
    n_out: int
    seconds: float
    bytes_per_party: int
    rounds: int
    n_ins: List[int] = dataclasses.field(default_factory=list)  # all inputs
    extra: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ExecutionReport:
    nodes: List[NodeStats] = dataclasses.field(default_factory=list)

    @property
    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.nodes)

    @property
    def total_bytes(self) -> int:
        return sum(s.bytes_per_party for s in self.nodes)

    @property
    def total_rounds(self) -> int:
        return sum(s.rounds for s in self.nodes)

    def to_dict(self) -> Dict:
        """JSON-safe per-node report (the machine-readable twin of
        :meth:`summary`)."""

        def safe(v):
            if isinstance(v, dict):
                return {k: safe(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [safe(x) for x in v]
            if hasattr(v, "item"):  # numpy / torch scalars
                return v.item()
            return v

        return {
            "nodes": [
                {
                    "node": s.node,
                    "n_in": int(s.n_in),
                    "n_ins": [int(n) for n in s.n_ins],
                    "n_out": int(s.n_out),
                    "seconds": float(s.seconds),
                    "bytes_per_party": int(s.bytes_per_party),
                    "rounds": int(s.rounds),
                    "extra": safe(s.extra),
                }
                for s in self.nodes
            ],
            "total_seconds": float(self.total_seconds),
            "total_bytes": int(self.total_bytes),
            "total_rounds": int(self.total_rounds),
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict) -> "ExecutionReport":
        """Rebuild a report from :meth:`to_dict` output (the wire form a
        party returns to the coordinator)."""
        return cls(
            nodes=[
                NodeStats(
                    node=n["node"],
                    n_in=int(n["n_in"]),
                    n_ins=[int(x) for x in n.get("n_ins", [])],
                    n_out=int(n["n_out"]),
                    seconds=float(n["seconds"]),
                    bytes_per_party=int(n["bytes_per_party"]),
                    rounds=int(n["rounds"]),
                    extra=dict(n.get("extra", {})),
                )
                for n in d.get("nodes", [])
            ]
        )

    def summary(self) -> str:
        def ins(s: NodeStats) -> str:
            # all inputs, not just the first: a join reads "512x128"
            return "x".join(str(n) for n in s.n_ins) if s.n_ins else "-"

        def note(s: NodeStats) -> str:
            if not s.extra:
                return ""
            pub = redact.public_view(s.extra)
            if pub.get("skipped"):
                return "trim skipped"
            parts = []
            if pub.get("s") is not None:
                parts.append(f"S={pub['s']}")
            sp = pub.get("s_padded")
            if sp is not None and sp != pub.get("s"):
                parts.append(f"pad->{sp}")
            return " ".join(parts)

        lines = [
            f"{'node':<42}{'n_ins':>11}{'n_out':>9}{'sec':>9}"
            f"{'MiB/party':>11}{'rounds':>8}  extra"
        ]
        for s in self.nodes:
            lines.append(
                (
                    f"{s.node:<42}{ins(s):>11}{s.n_out:>9}{s.seconds:>9.3f}"
                    f"{s.bytes_per_party / 2**20:>11.3f}{s.rounds:>8}  {note(s)}"
                ).rstrip()
            )
        lines.append(
            f"{'TOTAL':<42}{'':>11}{'':>9}{self.total_seconds:>9.3f}"
            f"{self.total_bytes / 2**20:>11.3f}{self.total_rounds:>8}"
        )
        return "\n".join(lines)


# -----------------------------------------------------------------------------
# Batched-execution plumbing
# -----------------------------------------------------------------------------

def _stack_tables(tables: Sequence[SecretTable]) -> SecretTable:
    """K structurally identical tables -> one table whose leaves carry a new
    leading batch axis (shares become ``(K, 3, n)``)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *tables)


def _broadcast_table(table: SecretTable, k: int) -> SecretTable:
    """One shared table viewed as a K-slot batch (a broadcast, no copy)."""
    return pytree.tree_map(lambda x: x.unsqueeze(0).expand((k,) + tuple(x.shape)), table)


def _unstack_table(stacked: SecretTable, i: int) -> SecretTable:
    return pytree.tree_map(lambda x: x[i], stacked)


@dataclasses.dataclass
class _BatchVal:
    """A plan node's output across the batch: one stacked table (the vmapped
    path) or a per-slot list (after the batch split on divergent Resize trim
    sizes)."""

    k: int
    stacked: Optional[SecretTable] = None
    slots: Optional[List[SecretTable]] = None

    def to_slots(self) -> List[SecretTable]:
        if self.slots is None:
            self.slots = [_unstack_table(self.stacked, i) for i in range(self.k)]
        return self.slots

    def slot_n(self, i: int) -> int:
        if self.slots is not None:
            return self.slots[i].n
        return int(self.stacked.valid.shares.shape[-1])


def _physical_sig(plan: PlanNode) -> tuple:
    """Preorder tuple of operator class names: the physical plan shape
    (logical fingerprints collapse physical join variants by design)."""
    return (plan.label,) + tuple(s for c in plan.children() for s in _physical_sig(c))


def _count_resizes(plan: PlanNode) -> int:
    """Noise-counter consumers per plan (post-order Resize count)."""
    n = sum(_count_resizes(c) for c in plan.children())
    return n + (1 if lookup(type(plan)).provides_resize_info else 0)


@dataclasses.dataclass
class _BatchCtx:
    """Per-``execute_batch`` state threaded through the plan walk."""

    k: int
    reports: List[ExecutionReport]
    ctr_base: int  # engine._resize_ctr before the batch started
    resizes_per_slot: int  # Resize nodes per plan (post-order count)
    resize_idx: int = 0  # next Resize node's post-order index

    def next_resize_index(self) -> int:
        j = self.resize_idx
        self.resize_idx += 1
        return j

    def slot_ctr_before(self, slot: int, resize_index: int) -> int:
        """The counter engine._resize_ctr must hold before this slot runs its
        ``resize_index``-th Resize, so the fold matches a serial run of the
        K queries in submission order: slot i's j-th resize consumes
        ``base + i * R + j + 1``."""
        return self.ctr_base + slot * self.resizes_per_slot + resize_index


class Engine:
    """Executes plans over a set of secret-shared base tables.

    ``device`` (default ``"cuda"``; raises without a card unless ``"cpu"``)
    must be where the tables' shares lie. ``key`` is a (2,) threefry key;
    the PRF setup derives from ``fold_in(key, 7)`` as in the reference,
    unless ``prf`` is given. ``bucket_fn`` pads every revealed size S to
    ``max(bucket_fn(S), S)``; ``validate`` schema-checks each plan before
    any MPC work. ``jit_ops=True`` (the reference's per-operator jit cache)
    is not available in the port yet.
    """

    def __init__(
        self,
        tables: Dict[str, SecretTable],
        key: Optional[torch.Tensor] = None,
        prf: Optional[PRFSetup] = None,
        bucket_fn: Optional[Callable[[int], int]] = None,
        jit_ops: bool = False,
        validate: bool = True,
        config: Optional[RuntimeConfig] = None,
        device=None,
    ):
        if jit_ops:
            raise NotImplementedError(
                "jit_ops: the per-operator jit cache has no port yet; it waits for "
                "CUDA graphs (ROADMAP.md, Queue 2, 'CUDA graphs over host-bound loops')"
            )
        self.device = resolve_device(device)
        for name, t in tables.items():
            if t.device.type != self.device.type:
                raise ValueError(f"table {name!r} lies on {t.device}, the engine runs on {self.device}")
        self.tables = tables
        self.key = key if key is not None else threefry.PRNGKey(0)
        self.prf = prf if prf is not None else setup_prf(threefry.fold_in(self.key, 7))
        self.bucket_fn = bucket_fn
        self.jit_ops = jit_ops
        self.validate = validate
        self.config = config  # None: the environment fallback (current_config)
        self._resize_ctr = 0
        self._last_resize_info: Optional[Dict] = None
        self.last_batch_stats: Dict = {}
        # revealed-size feedback: called as hook(node, info) after every
        # non-skipped Resize reveal-and-trim (serial and per batch slot)
        self.reveal_hook: Optional[Callable[[PlanNode, Dict], None]] = None

    def execute(self, plan: PlanNode) -> tuple[SecretTable, ExecutionReport]:
        if self.validate:
            # unknown columns raise PlanSchemaError here, before any MPC work
            infer_schema(plan, Catalog.from_tables(self.tables))
        report = ExecutionReport()
        self._last_resize_info = None  # never carry info across runs
        with use_config(self.config), obs_trace.span("execute"):
            out = self._run(plan, report)
        return out, report

    def _block(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _run_node_slot(self, node: PlanNode, children: List[SecretTable]) -> Tuple[SecretTable, NodeStats]:
        """Execute one node for one slot under its own ledger and return the
        output with its report entry: the single accounting path of serial
        ``_run``, the batch's split tail and per-slot Resize. Consumes the
        resize info the node produced."""
        d = lookup(type(node))
        led = CommLedger()
        src = material.active_source()
        h0, m0 = (src.hits, src.misses) if src is not None else (0, 0)
        drv = active_exchange()
        if drv is not None:
            x0 = (drv.count, drv.stall_seconds, drv.wire_bytes)
        t0 = time.perf_counter()
        with led:
            out = d.apply(self, node, children)
        self._block()
        dt = time.perf_counter() - t0
        tally = led.tally()
        n_ins = [t.n for t in children]
        extra = {}
        if src is not None and (src.hits - h0 or src.misses - m0):
            # how much of this node's correlated randomness came from a pool
            extra["offline"] = {"hits": src.hits - h0, "misses": src.misses - m0}
        if drv is not None and drv.count > x0[0]:
            # this node's share of the ring exchanges (networked mode only)
            extra["wire"] = {
                "exchanges": drv.count - x0[0],
                "stall_seconds": round(drv.stall_seconds - x0[1], 6),
                "wire_bytes": drv.wire_bytes - x0[2],
            }
        if d.provides_resize_info:
            info = self._last_resize_info or {}
            self._last_resize_info = None
            if self.reveal_hook is not None and info and not info.get("skipped"):
                self.reveal_hook(node, info)
            extra = {**info, **extra}
        stats = NodeStats(
            node=node.describe(),
            n_in=n_ins[0] if n_ins else 0,
            n_ins=n_ins,
            n_out=out.n,
            seconds=dt,
            bytes_per_party=int(tally["bytes_per_party"]),
            rounds=int(tally["rounds"]),
            extra=extra,
        )
        tr = obs_trace.active_tracer()
        if tr is not None:
            # `extra` passes the redaction boundary inside record(): the
            # resizer's t/p/eta never reach the span, S and padding do
            tr.record(
                f"node[{node.label}]",
                seconds=dt,
                op=node.describe(),
                n_ins=n_ins,
                n_out=stats.n_out,
                bytes_per_party=stats.bytes_per_party,
                rounds=stats.rounds,
                **extra,
            )
        return out, stats

    def _run(self, node: PlanNode, report: ExecutionReport) -> SecretTable:
        children = [self._run(c, report) for c in node.children()]
        out, stats = self._run_node_slot(node, children)
        report.nodes.append(stats)
        return out

    # ------------------------------------------------------------------
    # Batched execution: K same-shape queries, one engine pass
    # ------------------------------------------------------------------

    def execute_batch(self, plans: Sequence[PlanNode]) -> List[Tuple[SecretTable, ExecutionReport]]:
        """Execute K structurally identical plans as one stacked engine pass.

        Every plan must have the same fingerprint (``plan.pretty()``) and
        physical operators. Slot i's result and per-node ledger tallies are
        bit-identical to ``execute(plans[i])`` had the K queries run serially
        in order. Plans with a non-batchable operator, and batches of one,
        run serially.

        ``last_batch_stats`` afterwards holds the physical cost of the pass:
        every slot's bytes move, but stacked nodes share their rounds.
        """
        plans = list(plans)
        if not plans:
            return []
        if len(plans) == 1 or not plan_batchable(plans[0]):
            results = [self.execute(p) for p in plans]
            # serial execution shares nothing: the physical pass is the sum
            self.last_batch_stats = {
                "slots": len(plans),
                "stacked_nodes": 0,
                "split_nodes": 0,
                "physical_bytes_per_party": sum(r.total_bytes for _, r in results),
                "physical_rounds": sum(r.total_rounds for _, r in results),
            }
            return results
        fp = plans[0].pretty()
        psig = _physical_sig(plans[0])
        for p in plans[1:]:
            if p.pretty() != fp or _physical_sig(p) != psig:
                raise ValueError(
                    "execute_batch requires structurally identical plans; "
                    "bucket by full plan fingerprint (and physical operator "
                    "signature) before batching"
                )
        if self.validate:
            infer_schema(plans[0], Catalog.from_tables(self.tables))

        k = len(plans)
        resizes = _count_resizes(plans[0])
        ctx = _BatchCtx(
            k=k,
            reports=[ExecutionReport() for _ in range(k)],
            ctr_base=self._resize_ctr,
            resizes_per_slot=resizes,
        )
        self._last_resize_info = None
        self.last_batch_stats = {
            "slots": k,
            "stacked_nodes": 0,
            "split_nodes": 0,
            "physical_bytes_per_party": 0,
            "physical_rounds": 0,
        }
        try:
            with use_config(self.config), obs_trace.span("execute", slots=k, batched=True):
                out = self._run_batch(plans[0], ctx)
        finally:
            # the batch owns the counter range [base+1, base+k*R]; skip past
            # all of it even on failure, so no later query refolds a counter
            # whose noise some slot may already have revealed
            self._resize_ctr = ctx.ctr_base + k * resizes
        return list(zip(out.to_slots(), ctx.reports))

    def _run_batch(self, node: PlanNode, ctx: _BatchCtx) -> _BatchVal:
        children = [self._run_batch(c, ctx) for c in node.children()]
        d = lookup(type(node))
        if d.batch_apply is not None:
            return d.batch_apply(self, node, children, ctx)
        if all(c.stacked is not None for c in children):
            return self._run_batch_stacked(node, children, ctx)
        return self._run_batch_split(node, children, ctx)

    def _run_batch_stacked(self, node: PlanNode, children: List[_BatchVal], ctx: _BatchCtx) -> _BatchVal:
        """One vmapped pass for all K slots. The ledger records the per-slot
        cost (the protocol keeps per-slot shapes), replayed into every slot's
        report; the physical tally charges bytes K times and rounds once."""
        d = lookup(type(node))
        led = CommLedger()
        src = material.active_source()
        h0, m0 = (src.hits, src.misses) if src is not None else (0, 0)
        t0 = time.perf_counter()
        with led:
            out = vmap(lambda *ts: d.apply(self, node, list(ts)))(*[c.stacked for c in children])
        self._block()
        dt = time.perf_counter() - t0
        tally = led.tally()
        val = _BatchVal(k=ctx.k, stacked=out)
        n_ins = [c.slot_n(0) for c in children]
        extra = {}
        if src is not None and (src.hits - h0 or src.misses - m0):
            # one pass serves all K slots: its pool traffic goes to each
            extra["offline"] = {"hits": src.hits - h0, "misses": src.misses - m0}
        for report in ctx.reports:
            report.nodes.append(
                NodeStats(
                    node=node.describe(),
                    n_in=n_ins[0] if n_ins else 0,
                    n_ins=list(n_ins),
                    n_out=val.slot_n(0),
                    seconds=dt / ctx.k,  # amortized wall share
                    bytes_per_party=int(tally["bytes_per_party"]),
                    rounds=int(tally["rounds"]),
                    extra=dict(extra),
                )
            )
        tr = obs_trace.active_tracer()
        if tr is not None:
            tr.record(
                f"node[{node.label}]",
                seconds=dt,
                op=node.describe(),
                n_ins=list(n_ins),
                n_out=val.slot_n(0),
                bytes_per_party=int(tally["bytes_per_party"]),
                rounds=int(tally["rounds"]),
                slots=ctx.k,
                stacked=True,
                **extra,
            )
        phys = batched_tally(tally, ctx.k)
        bs = self.last_batch_stats
        bs["stacked_nodes"] += 1
        bs["physical_bytes_per_party"] += int(phys["bytes_per_party"])
        bs["physical_rounds"] += int(phys["rounds"])
        return val

    def _run_batch_split(self, node: PlanNode, children: List[_BatchVal], ctx: _BatchCtx) -> _BatchVal:
        """Per-slot execution through the serial path: after a Resize split
        (divergent trim sizes make the slots un-stackable)."""
        slot_children = [c.to_slots() for c in children]
        outs: List[SecretTable] = []
        bs = self.last_batch_stats
        bs["split_nodes"] += 1
        for i in range(ctx.k):
            out, stats = self._run_node_slot(node, [sc[i] for sc in slot_children])
            ctx.reports[i].nodes.append(stats)
            bs["physical_bytes_per_party"] += stats.bytes_per_party
            bs["physical_rounds"] += stats.rounds
            outs.append(out)
        return _BatchVal(k=ctx.k, slots=outs)

    # -- stateful batch hooks (dispatched via OperatorDef.batch_apply) -------

    def _batch_scan(self, node: PlanNode, ctx: _BatchCtx) -> _BatchVal:
        """All slots read the same secret-shared base table: a broadcast
        along the batch axis stands in for K stacked copies."""
        table = self.tables[node.table]
        for report in ctx.reports:
            report.nodes.append(
                NodeStats(
                    node=node.describe(), n_in=0, n_ins=[], n_out=table.n,
                    seconds=0.0, bytes_per_party=0, rounds=0,
                )
            )
        obs_trace.record(
            f"node[{node.label}]", op=node.describe(), n_ins=[],
            n_out=table.n, bytes_per_party=0, rounds=0,
            slots=ctx.k, stacked=True,
        )
        return _BatchVal(k=ctx.k, stacked=_broadcast_table(table, ctx.k))

    def _batch_resize(self, node: PlanNode, children: List[_BatchVal], ctx: _BatchCtx) -> _BatchVal:
        """Per-slot reveal-and-trim: slot i's j-th Resize folds exactly the
        noise counter a serial run would have (fresh noise per query, one
        observation each). Slots whose revealed sizes agree are re-stacked
        so the rest of the plan stays vmapped; divergent sizes split."""
        j = ctx.next_resize_index()
        slots_in = children[0].to_slots()
        outs: List[SecretTable] = []
        bs = self.last_batch_stats
        for i, tbl in enumerate(slots_in):
            self._resize_ctr = ctx.slot_ctr_before(i, j)
            out, stats = self._run_node_slot(node, [tbl])
            ctx.reports[i].nodes.append(stats)
            bs["physical_bytes_per_party"] += stats.bytes_per_party
            bs["physical_rounds"] += stats.rounds
            outs.append(out)
        if all(o.n == outs[0].n for o in outs):
            return _BatchVal(k=ctx.k, stacked=_stack_tables(outs))
        return _BatchVal(k=ctx.k, slots=outs)
