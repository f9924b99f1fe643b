"""PartyServer: one RSS party's execution loop (a port of
``repro.runtime.party``).

A party server owns two transports:

* a **control link** to the coordinator (CTRL frames carrying pickled
  messages: hello / load_tables / execute / stats / shutdown), and
* a **data mesh** to the other two parties (DATA frames: one per ledger
  sync point, driven by :class:`~repro_torch.runtime.exchange.RingExchange`).

On ``execute`` it runs its local :class:`~repro_torch.engine.Engine` on its
device (``"cuda"`` unless the server was built for the CPU) over the
shipped plan, under the mesh-wide :class:`~repro_torch.config.RuntimeConfig`
the coordinator shipped, with the ring exchange installed, so every ledger
entry is a real framed wire exchange verified against the peer. It replies
with its *own share slice* of the output columns as numpy ``uint32`` (party
``p`` contributes canonical share ``s_p``; the coordinator reassembles the
triple from three distinct slices, which is bit-exact only if all three
parties computed identical triples), the execution report, the per-op
exchange log (or its capped deterministic summary) for the wire-vs-ledger
audit, the network stall total, the payload exchanges' device-to-host
copies, the seconds spent making frame bodies, and — when the coordinator shipped a trace context — this party's
redacted spans plus the control-frame clock stamps the coordinator uses for
clock-offset normalization (DESIGN.md §17).

Tables travel as numpy ``uint32`` share triples, the reference's encoding,
so a table encoded by either package decodes in the other.

The same class serves both process topologies:
``python -m repro_torch.runtime.run_parties`` runs it standalone over
:class:`TcpTransport`; the loopback mesh runs it on a thread over
:class:`LoopbackTransport`. Thread-local ledger, config, fusion and tracer
state keep three party threads in one process isolated, and a shared
``turn`` lock makes them compute one at a time (see :class:`RingExchange`).
"""
from __future__ import annotations

import contextlib
import pickle
import threading
import time
import traceback
from typing import Dict, Optional

from ..config import RuntimeConfig, resolve_device
from ..core import threefry
from ..core.ledger import exchange_scope
from ..core.ring import from_numpy, to_numpy
from ..core.sharing import AShare, BShare
from ..engine.executor import Engine
from ..errors import TransportError
from ..obs import trace as obs_trace
from ..ops.table import SecretTable
from .exchange import RingExchange
from .transport import COORD, CTRL, Transport

__all__ = ["PartyServer", "encode_table", "decode_table"]


def encode_table(table: SecretTable) -> Dict:
    """SecretTable -> picklable dict of full canonical share triples as numpy
    ``uint32`` (the replicated-simulation contract: every party holds the
    whole triple; see DESIGN.md §16.3)."""
    cols = {}
    for name in list(table.cols):
        c = table.col(name)  # materializes lazy views
        cols[name] = ("a" if isinstance(c, AShare) else "b", to_numpy(c.shares))
    return {"cols": cols, "valid": to_numpy(table.valid.shares)}


def decode_table(d: Dict, device=None) -> SecretTable:
    """The inverse of :func:`encode_table` (either package's), as ``int32``
    ring words on ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    cols = {}
    for name, (kind, arr) in d["cols"].items():
        sh = from_numpy(arr, device)
        cols[name] = AShare(sh) if kind == "a" else BShare(sh)
    return SecretTable(cols, BShare(from_numpy(d["valid"], device)))


class PartyServer:
    def __init__(
        self,
        party: int,
        ctrl: Transport,
        data: Transport,
        *,
        fault_after: Optional[int] = None,
        exchange_timeout: float = 60.0,
        device=None,
        turn: Optional[threading.Lock] = None,
    ):
        self.party = party
        # the lock party threads of one process take turns on (see
        # RingExchange); None for a party alone in its process
        self.turn = turn
        self.ctrl = ctrl
        self.data = data
        self.fault_after = fault_after
        self.exchange_timeout = exchange_timeout
        self.device = resolve_device(device)
        self.engine: Optional[Engine] = None
        self.queries = 0

    # -- control-message helpers ---------------------------------------------
    def _reply(self, msg: Dict) -> None:
        self.ctrl.send(COORD, msg["type"], pickle.dumps(msg), kind=CTRL)

    def _handle_load_tables(self, msg: Dict) -> Dict:
        tables = {name: decode_table(d, self.device) for name, d in msg["tables"].items()}
        cfg = (
            RuntimeConfig.from_dict(msg["config"])
            if msg.get("config") is not None
            else None
        )
        self.engine = Engine(
            tables,
            key=threefry.PRNGKey(int(msg["key_seed"])),
            jit_ops=False,
            config=cfg,
            device=self.device,
        )
        return {
            "type": "load_ack",
            "party": self.party,
            "tables": sorted(tables),
        }

    def _handle_execute(self, msg: Dict) -> Dict:
        t_recv = time.time()  # control-frame receipt on THIS party's clock
        if self.engine is None:
            return {
                "type": "error",
                "party": self.party,
                "error": "execute before load_tables",
                "reason": "protocol",
            }
        plan = pickle.loads(msg["plan"])
        base = msg.get("resize_ctr_base")
        if base is not None and self.engine._resize_ctr != base:
            # lockstep invariant: every party must fold the same noise
            # counters, or Resize draws diverge silently
            return {
                "type": "error",
                "party": self.party,
                "error": (
                    f"resize counter desync: party at "
                    f"{self.engine._resize_ctr}, coordinator at {base}"
                ),
                "reason": "divergence",
            }
        drv = RingExchange(
            self.data,
            self.party,
            timeout=self.exchange_timeout,
            fault_after=self.fault_after,
            turn=self.turn,
        )
        # trace-context propagation (DESIGN.md §17): a traced coordinator
        # ships (trace_id, parent_span_id); this query runs under a fresh
        # per-query tracer carrying that id, and the reply ships the
        # party's redacted spans back for the coordinator-side merge. An
        # untraced execute runs with no tracer at all.
        tctx = msg.get("trace")
        tracer = (
            obs_trace.Tracer(party=self.party, trace_id=tctx["trace_id"])
            if tctx is not None
            else None
        )
        cm = tracer if tracer is not None else contextlib.nullcontext()
        wire_before = self.data.sent_bytes  # counters span queries; audit per
        with cm, exchange_scope(drv):
            out, report = self.engine.execute(plan)
        self.queries += 1
        slices = {}
        for name in list(out.cols):
            c = out.col(name)
            slices[name] = (
                "a" if isinstance(c, AShare) else "b",
                to_numpy(c.shares[self.party]),
            )
        # cap the shipped exchange log: large plans produce thousands of
        # per-op entries; past the cap the reply carries the deterministic
        # summary (exact byte/round totals) instead of the full list
        cap = int(msg.get("exchange_log_cap") or 0)
        log = drv.log if not (cap and len(drv.log) > cap) else drv.log_summary()
        reply = {
            "type": "result",
            "party": self.party,
            "cols": slices,
            "valid": to_numpy(out.valid.shares[self.party]),
            "report": report.to_dict(),
            "exchange_log": log,
            "wire_bytes": self.data.sent_bytes - wire_before,
            "stall_seconds": drv.stall_seconds,
            "payload_exchanges": drv.payload_exchanges,
            "d2h_bytes": drv.d2h_bytes,
            "body_seconds": drv.body_seconds,
            "resize_ctr": self.engine._resize_ctr,
            "clock": {"t_recv": t_recv, "t_reply": time.time()},
        }
        if tracer is not None:
            reply["trace_id"] = tracer.trace_id
            reply["spans"] = [s.to_dict() for s in tracer.spans]
            reply["redactions"] = len(tracer.redactions)
        return reply

    def _handle_stats(self) -> Dict:
        """Mesh-health snapshot for the ``stats`` control verb: this party's
        cumulative wire counters (data mesh + control link) and query count.
        Read-only — never touches engine state."""
        wire = self.data.wire_snapshot()
        if self.ctrl is not self.data:
            extra = self.ctrl.wire_snapshot()
            for k in ("sent", "recv", "rejects", "connects", "links"):
                wire[k] = wire[k] + extra[k]
        return {
            "type": "stats",
            "party": self.party,
            "queries": self.queries,
            "wire": wire,
            "clock": {"t_recv": time.time(), "t_reply": time.time()},
        }

    # -- main loop ------------------------------------------------------------
    def _handle(self, mtype: str, msg: Dict) -> bool:
        """Answer one control message; True after ``shutdown``."""
        if mtype == "hello":
            self._reply({"type": "hello_ack", "party": self.party})
        elif mtype == "load_tables":
            self._reply(self._handle_load_tables(msg))
        elif mtype == "execute":
            self._reply(self._handle_execute(msg))
        elif mtype == "stats":
            self._reply(self._handle_stats())
        elif mtype == "shutdown":
            self._reply({"type": "bye", "party": self.party})
            return True
        else:
            self._reply({
                "type": "error",
                "party": self.party,
                "error": f"unknown message type {mtype!r}",
                "reason": "protocol",
            })
        return False

    def serve(self) -> None:
        """Process control messages until shutdown (or a fatal transport
        failure). Execution errors are reported to the coordinator and the
        loop continues; an injected crash (``fault_after``) tears the whole
        server down the way a dead process would."""
        while True:
            try:
                frame = self.ctrl.recv(COORD, timeout=None)
            except TransportError:
                return  # coordinator is gone; nothing to serve
            msg = pickle.loads(frame.body)
            mtype = msg.get("type")
            try:
                with self.turn if self.turn is not None else contextlib.nullcontext():
                    done = self._handle(mtype, msg)
                if done:
                    return
            except TransportError as e:
                if e.reason == "crashed" and self.fault_after is not None:
                    return  # injected crash: die silently, like a real one
                try:
                    self._reply({
                        "type": "error",
                        "party": self.party,
                        "error": str(e),
                        "reason": e.reason,
                    })
                except TransportError:
                    return
            except Exception as e:  # report, keep serving
                self._reply({
                    "type": "error",
                    "party": self.party,
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc(),
                    "reason": "execution",
                })

    def close(self) -> None:
        self.ctrl.close()
        self.data.close()
