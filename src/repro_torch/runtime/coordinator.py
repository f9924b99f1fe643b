"""Coordinator: drives three party servers and reassembles revealed results
(a port of ``repro.runtime.coordinator``).

The coordinator compiles and admits queries exactly like the single-process
service (it IS the service — :class:`RemoteEngine` plugs in below
``AnalyticsService`` via its ``engine_factory`` hook), but execution is
remote: the pickled plan is broadcast to the three parties, each runs it
over the real data mesh, and the coordinator

1. collects each party's **own share slice** of the output and restacks the
   canonical triple ``(p0's s0, p1's s1, p2's s2)`` on its own device —
   bit-exact iff the three parties computed identical triples (every DATA
   exchange already cross-checked slices en route, so a divergence fails at
   the exact op, not here);
2. asserts the three execution reports agree field for field on the
   protocol-determined columns (ledger bytes, rounds, oblivious sizes);
3. audits **wire bytes == ledger bytes**: each party's transport counted
   the DATA body bytes it actually sent; that figure must equal the
   exchange log's sum and the report's ledger total.

Any violation raises :class:`~repro_torch.errors.TransportError`, which
rides the service's failure path (``charge_failed``: the budget is charged
conservatively for a query that died mid-execution).

Topologies: :func:`launch_loopback_mesh` runs the three party servers on
threads over an in-process :class:`LoopbackMesh` (on one card, their device
work serialises on its default stream); :func:`connect_tcp` dials party
processes listening on TCP (``python -m repro_torch.runtime.run_parties``).
"""
from __future__ import annotations

import pickle
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import RuntimeConfig
from ..core.ring import from_numpy
from ..core.sharing import AShare, BShare
from ..engine.executor import Engine, ExecutionReport
from ..errors import TransportError
from ..obs import distributed as obs_dist
from ..obs import trace as obs_trace
from ..ops.table import SecretTable
from ..plan.nodes import PlanNode
from ..plan.registry import infer_schema, lookup
from ..sql.catalog import Catalog
from .party import PartyServer, encode_table
from .transport import (
    COORD,
    CTRL,
    LoopbackMesh,
    LoopbackTransport,
    TcpTransport,
    Transport,
)

__all__ = [
    "Coordinator",
    "RemoteEngine",
    "launch_loopback_mesh",
    "connect_tcp",
]

PARTIES = (0, 1, 2)


class Coordinator:
    """Control-plane client for a 3-party mesh (any transport)."""

    def __init__(self, ctrl: Transport, *, request_timeout: float = 120.0):
        self.ctrl = ctrl
        self.request_timeout = request_timeout
        self._lock = threading.Lock()
        # shipped-exchange-log cap: past this many entries the party reply
        # carries the deterministic summary instead of the full per-op list
        self.exchange_log_cap = 256
        # per-party control-frame clock stamps of the most recent broadcast,
        # on the coordinator's clock — the NTP-style offset inputs (§17)
        self.last_rpc: List[Dict] = []
        # the party threads of a loopback mesh, joined by close(): a thread
        # that ran torch work must not outlive the interpreter
        self.party_threads: List[threading.Thread] = []

    # -- control RPC ----------------------------------------------------------
    def _request_all(self, msg: Dict) -> List[Dict]:
        """Broadcast one control message and gather one reply per party."""
        body = pickle.dumps(msg)
        with self._lock:
            rpc = []
            for p in PARTIES:
                t_send = time.time()
                self.ctrl.send(p, msg["type"], body, kind=CTRL)
                rpc.append({"party": p, "t_send": t_send, "t_recv": None})
            replies = []
            for p in PARTIES:
                frame = self.ctrl.recv(p, timeout=self.request_timeout)
                rpc[p]["t_recv"] = time.time()
                replies.append(pickle.loads(frame.body))
            self.last_rpc = rpc
        for p, r in zip(PARTIES, replies):
            if r.get("type") == "error":
                raise TransportError(
                    f"party {p} failed: {r.get('error')}",
                    party=p, reason=r.get("reason", "execution"),
                )
        return replies

    def hello(self) -> None:
        self._request_all({"type": "hello"})

    def load_tables(
        self,
        tables: Dict[str, SecretTable],
        key_seed: int,
        config: Optional[RuntimeConfig] = None,
    ) -> None:
        msg = {
            "type": "load_tables",
            "tables": {n: encode_table(t) for n, t in tables.items()},
            "key_seed": int(key_seed),
            "config": config.to_dict() if config is not None else None,
        }
        self._request_all(msg)

    def execute_plan(
        self,
        plan: PlanNode,
        resize_ctr_base: int,
        trace: Optional[obs_dist.TraceContext] = None,
    ) -> List[Dict]:
        msg = {
            "type": "execute",
            "plan": pickle.dumps(plan),
            "resize_ctr_base": int(resize_ctr_base),
            "exchange_log_cap": int(self.exchange_log_cap),
        }
        if trace is not None:
            msg["trace"] = trace.to_dict()
        return self._request_all(msg)

    def stats(self) -> Dict:
        """Mesh-health snapshot: each party's cumulative wire counters plus
        the coordinator's own control-link view and per-party control RTTs."""
        replies = self._request_all({"type": "stats"})
        rpc = {e["party"]: e for e in self.last_rpc}
        return {
            "parties": [
                {"party": r["party"], "queries": r["queries"],
                 "wire": r["wire"]}
                for r in replies
            ],
            "coordinator": self.ctrl.wire_snapshot(),
            "rtt_seconds": {
                p: round(rpc[p]["t_recv"] - rpc[p]["t_send"], 6)
                for p in PARTIES
                if rpc.get(p, {}).get("t_recv") is not None
            },
        }

    def shutdown(self) -> None:
        try:
            self._request_all({"type": "shutdown"})
        except TransportError:
            pass  # a party that already died cannot say goodbye

    def close(self) -> None:
        """Close the control link (a loopback party sees its coordinator
        gone and stops serving) and join this process's party threads."""
        self.ctrl.close()
        for th in self.party_threads:
            th.join(timeout=self.request_timeout)


def _post_order(plan: PlanNode) -> List[PlanNode]:
    out: List[PlanNode] = []

    def walk(node: PlanNode) -> None:
        for c in node.children():
            walk(c)
        out.append(node)

    walk(plan)
    return out


class RemoteEngine(Engine):
    """Engine whose ``execute`` dispatches to a 3-party mesh.

    Everything above it — admission, plan cache, scheduler, calibration
    hooks, metrics — is unchanged ``AnalyticsService`` machinery; everything
    below the plan boundary happens in the parties. Batched execution runs
    serial remote passes (slot *i*'s noise counters line up with a serial
    run by construction, so results stay bit-exact with the single-process
    scheduler path). The reassembled output lies on this engine's device."""

    def __init__(self, tables, coordinator: Coordinator, **kwargs):
        kwargs.setdefault("jit_ops", False)
        if kwargs.get("jit_ops"):
            raise ValueError(
                "networked execution requires jit_ops=False (jit replay "
                "skips the Python protocol bodies and their exchange "
                "boundaries)"
            )
        super().__init__(tables, **kwargs)
        self.coordinator = coordinator
        self.last_wire_audit: List[Dict] = []

    # -- remote execution -----------------------------------------------------
    def execute(self, plan: PlanNode) -> Tuple[SecretTable, ExecutionReport]:
        if self.validate:
            infer_schema(plan, Catalog.from_tables(self.tables))
        tr = obs_trace.active_tracer()
        if tr is not None:
            # traced path (DESIGN.md §17): ship (trace_id, parent span) in
            # the execute frame, collect each party's redacted spans from
            # the reply, and merge them — clock-offset-normalized and
            # party-attributed — under this coordinator-side execute span.
            with tr.span("execute", parties=3) as sp:
                ctx = obs_dist.TraceContext(tr.ensure_trace_id(), sp.span_id)
                results = self.coordinator.execute_plan(
                    plan, self._resize_ctr, trace=ctx
                )
                self._audit(results)
                rpc = {e["party"]: e for e in self.coordinator.last_rpc}
                shipments = [
                    {
                        "party": r["party"],
                        "trace_id": r.get("trace_id"),
                        "spans": r.get("spans", []),
                        "clock": r.get("clock", {}),
                        "t_send": rpc[r["party"]]["t_send"],
                        "t_ack": rpc[r["party"]]["t_recv"],
                    }
                    for r in results
                ]
                merged = obs_dist.merge_party_spans(tr, sp, shipments)
                sp.attrs["merged"] = merged
        else:
            results = self.coordinator.execute_plan(plan, self._resize_ctr)
            self._audit(results)
        report = ExecutionReport.from_dict(results[0]["report"])
        out = self._reassemble(results)
        self._resize_ctr = int(results[0]["resize_ctr"])
        self._last_resize_info = None
        if self.reveal_hook is not None:
            # replay revealed-size feedback from the report: report.nodes is
            # the plan's post-order (the serial _run order), so entries map
            # 1:1 onto plan nodes ("offline"/"wire" extras are telemetry,
            # not revealed sizes)
            for node, stats in zip(_post_order(plan), report.nodes):
                if not lookup(type(node)).provides_resize_info:
                    continue
                info = {
                    k: v
                    for k, v in stats.extra.items()
                    if k not in ("offline", "wire")
                }
                if info and not info.get("skipped"):
                    self.reveal_hook(node, info)
        return out, report

    def execute_batch(
        self, plans: Sequence[PlanNode]
    ) -> List[Tuple[SecretTable, ExecutionReport]]:
        plans = list(plans)
        results = [self.execute(p) for p in plans]
        self.last_batch_stats = {
            "slots": len(plans),
            "stacked_nodes": 0,
            "split_nodes": 0,
            "physical_bytes_per_party": sum(r.total_bytes for _, r in results),
            "physical_rounds": sum(r.total_rounds for _, r in results),
        }
        return results

    # -- verification ---------------------------------------------------------
    def _audit(self, results: List[Dict]) -> None:
        """Cross-party report equality + the wire-vs-ledger byte audit."""
        def ledger_view(r):
            return [
                (
                    n["node"], n["n_ins"], n["n_out"],
                    n["bytes_per_party"], n["rounds"],
                )
                for n in r["report"]["nodes"]
            ]

        base = ledger_view(results[0])
        for r in results[1:]:
            if ledger_view(r) != base:
                raise TransportError(
                    f"party {r['party']} execution report diverges from "
                    f"party 0's (per-node ledger tallies differ)",
                    party=r["party"], reason="divergence",
                )
        if results[0]["exchange_log"] != results[1]["exchange_log"] or \
                results[1]["exchange_log"] != results[2]["exchange_log"]:
            raise TransportError(
                "parties disagree on the exchange log",
                reason="divergence",
            )
        self.last_wire_audit = []
        for r in results:
            ledger_bytes = sum(
                n["bytes_per_party"] for n in r["report"]["nodes"]
            )
            lg = r["exchange_log"]
            if isinstance(lg, dict):  # capped reply: deterministic summary
                log_bytes = lg["bytes"]
                exchanges = lg["entries"]
            else:
                log_bytes = sum(e["bytes"] for e in lg)
                exchanges = len(lg)
            audit = {
                "party": r["party"],
                "ledger_bytes": ledger_bytes,
                "exchange_bytes": log_bytes,
                "wire_bytes": r["wire_bytes"],
                "exchanges": exchanges,
                "stall_seconds": round(r.get("stall_seconds", 0.0), 6),
                "payload_exchanges": r["payload_exchanges"],
                "d2h_bytes": r["d2h_bytes"],
                "body_seconds": round(r["body_seconds"], 6),
            }
            self.last_wire_audit.append(audit)
            if not (ledger_bytes == log_bytes == r["wire_bytes"]):
                raise TransportError(
                    f"party {r['party']}: wire bytes {r['wire_bytes']} != "
                    f"exchange-log bytes {log_bytes} != ledger bytes "
                    f"{ledger_bytes}",
                    party=r["party"], reason="divergence",
                )

    def _reassemble(self, results: List[Dict]) -> SecretTable:
        """The canonical triples from the three parties' own slices, on this
        engine's device."""
        def triple(slices):
            return from_numpy(np.stack(slices), self.device)

        cols = {}
        for name, (kind, _) in results[0]["cols"].items():
            sh = triple([r["cols"][name][1] for r in results])
            cols[name] = AShare(sh) if kind == "a" else BShare(sh)
        return SecretTable(cols, BShare(triple([r["valid"] for r in results])))


# -----------------------------------------------------------------------------
# Mesh launchers
# -----------------------------------------------------------------------------

def launch_loopback_mesh(
    *,
    device=None,
    fault_after: Optional[Dict[int, int]] = None,
    exchange_timeout: float = 60.0,
    request_timeout: float = 120.0,
) -> Tuple[Coordinator, List[PartyServer], List[threading.Thread]]:
    """Three party servers on daemon threads over an in-process loopback
    mesh, their engines on ``device`` (``"cuda"`` unless ``"cpu"`` is asked
    for). The threads take turns: one computes while the other two wait for
    its frames. ``fault_after`` maps party id -> exchange count at which that
    party's driver simulates a crash."""
    mesh = LoopbackMesh()
    turn = threading.Lock()  # the parties compute one at a time
    servers = []
    threads = []
    for p in PARTIES:
        tr = LoopbackTransport(mesh, p)
        srv = PartyServer(
            p, tr, tr,
            fault_after=(fault_after or {}).get(p),
            exchange_timeout=exchange_timeout,
            device=device,
            turn=turn,
        )
        th = threading.Thread(target=srv.serve, daemon=True, name=f"party-{p}")
        th.start()
        servers.append(srv)
        threads.append(th)
    coord = Coordinator(
        LoopbackTransport(mesh, COORD), request_timeout=request_timeout
    )
    coord.party_threads = threads
    coord.hello()
    return coord, servers, threads


def connect_tcp(
    endpoints: Dict[int, Tuple[str, int]],
    *,
    request_timeout: float = 300.0,
    connect_retries: int = 80,
) -> Coordinator:
    """Dial three party processes listening on TCP (run them with
    ``python -m repro_torch.runtime.run_parties``) and return a connected
    Coordinator."""
    tr = TcpTransport(COORD, endpoints, connect_retries=connect_retries)
    for p in PARTIES:
        tr.dial(p)
    coord = Coordinator(tr, request_timeout=request_timeout)
    coord.hello()
    return coord
