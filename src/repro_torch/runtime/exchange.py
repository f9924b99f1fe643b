"""RingExchange: the bridge from ledger sync points to real wire traffic (a
port of ``repro.runtime.exchange``).

Execution model (DESIGN.md §16.3): every party runs the SAME deterministic
simulation — same engine key, hence identical canonical share triples,
identical noise draws, and an identical stream of ledger entries. What
differs per party is what crosses the wire: at each top-level
:class:`~repro_torch.core.ledger.CommLedger` entry the installed
:class:`RingExchange` sends exactly ``bytes_per_party`` bytes around the
resharing ring (party ``p`` sends to ``(p+2) % 3`` — its predecessor, the
direction of the mul/AND resharing hop — and receives from ``(p+1) % 3``)
and blocks until the matching frame arrives, so the wire carries the
ledger's byte count op for op and the parties advance in lockstep.

Frame bodies are *verifiable*: when the protocol layer handed the ledger a
``payload`` (the canonical ``(3, ...)`` share tensor at that sync point —
mul/AND reshares, reveal openings, ``reveal_k``), the body is this party's
own share slice and the receiver checks it bit for bit against the slice it
derived locally, so any divergence between the parties fails as
``TransportError(reason="divergence")`` at the exact op. The payload lies on
the engine's device: each payload exchange copies this party's slice and the
peer's to the host once (counted in ``payload_exchanges`` and
``d2h_bytes``). The port's ring-32 words are ``int32``, whose bytes are the
reference's little-endian ``uint32``, so the bodies equal the reference's.
Entries without a payload (fused circuit rounds, sort stages) carry a
deterministic SHA-256 filler derived from (src, op, link seq) that the
receiver reproduces and checks the same way.

``turn`` (optional) is a lock the three party threads of one process share:
a party holds it while it computes and lets go of it only while it waits
for a frame, so the threads take turns instead of contending for the
interpreter lock at every tensor operation. Under it a party's stall also
counts the time the other two parties computed.

``fault_after`` (die after N exchanges) exists for the party-crash tests:
the driver closes the transport mid-query, so peers observe a dropped link,
not a tidy farewell.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import List, Optional

import torch

from ..errors import TransportError
from .transport import DATA, Transport

__all__ = ["RingExchange"]


def _filler(src: int, op: str, seq: int, nbytes: int) -> bytes:
    """Deterministic pseudo-random body both link ends can derive: a SHA-256
    counter stream keyed by the link-visible (src, op, seq) identity."""
    seed = f"{src}|{op}|{seq}".encode()
    sha = hashlib.sha256
    blocks = [sha(seed + ctr.to_bytes(8, "big")).digest() for ctr in range(-(-nbytes // 32))]
    return b"".join(blocks)[:nbytes]


def _payload_body(raw: bytes, nbytes: int, src: int, op: str, seq: int) -> bytes:
    """One party's share slice, normalised to exactly ``nbytes`` (the
    ledger's logical byte count): truncated when longer, padded with filler
    when shorter. Both ends apply the same rule, as in the reference."""
    if len(raw) >= nbytes:
        return raw[:nbytes]
    return raw + _filler(src, op + "#pad", seq, nbytes - len(raw))


class RingExchange:
    """Exchange driver installed via
    :func:`repro_torch.core.ledger.exchange_scope` on a party's execution
    thread."""

    def __init__(
        self,
        transport: Transport,
        party: int,
        *,
        timeout: float = 60.0,
        fault_after: Optional[int] = None,
        turn: Optional[threading.Lock] = None,
    ):
        self.transport = transport
        self.turn = turn
        self.party = party
        self.send_to = (party + 2) % 3  # the resharing hop's direction
        self.recv_from = (party + 1) % 3
        self.timeout = timeout
        self.fault_after = fault_after
        self.count = 0
        # per-exchange (op, wire bytes, rounds) — the coordinator audits this
        # against the execution report's ledger tallies op by op
        self.log: List[dict] = []
        self.wire_bytes = 0
        # network stall: seconds this party spent blocked waiting for the
        # inbound frame at sync points (everything else is local compute).
        # Per-party, never audited for equality.
        self.stall_seconds = 0.0
        # exchanges that carried shares, and the bytes they copied from the
        # engine's device to the host (this party's slice and the peer's)
        self.payload_exchanges = 0
        self.d2h_bytes = 0
        # seconds spent making this party's body and the expected one
        # (filler hashing, payload copies): host work the wire adds
        self.body_seconds = 0.0

    def _slices(self, payload: torch.Tensor) -> tuple:
        """This party's and the peer's share slice as host bytes: one copy of
        the two rows off the device."""
        rows = payload[[self.party, self.recv_from]].contiguous().cpu()
        self.payload_exchanges += 1
        self.d2h_bytes += rows.numel() * rows.element_size()
        arr = rows.numpy()
        return arr[0].tobytes(), arr[1].tobytes()

    def exchange(self, op: str, rounds: int, nbytes, payload=None) -> None:
        nbytes = int(nbytes)
        if self.fault_after is not None and self.count >= self.fault_after:
            # simulate a party dying mid-protocol: drop every link, then
            # fail the local execution
            self.transport.close()
            raise TransportError(
                f"party {self.party}: injected crash after "
                f"{self.count} exchanges",
                party=self.party, op=op, reason="crashed",
            )
        seq = self.count
        t_body = time.perf_counter()
        if payload is not None:
            own, peer = self._slices(payload)
            body = _payload_body(own, nbytes, self.party, op, seq)
            expect = _payload_body(peer, nbytes, self.recv_from, op, seq)
        else:
            body = _filler(self.party, op, seq, nbytes)
            expect = _filler(self.recv_from, op, seq, nbytes)
        t0 = time.perf_counter()
        self.body_seconds += t0 - t_body
        self.transport.send(self.send_to, op, body, kind=DATA)
        if self.turn is None:
            got = self.transport.recv(self.recv_from, timeout=self.timeout)
        else:
            self.turn.release()
            try:
                got = self.transport.recv(self.recv_from, timeout=self.timeout)
            finally:
                self.turn.acquire()
        self.stall_seconds += time.perf_counter() - t0
        if got.op != op:
            raise TransportError(
                f"party {self.party}: exchange {seq} expected op {op!r}, "
                f"peer {self.recv_from} sent {got.op!r} — parties diverged",
                party=self.party, peer=self.recv_from, seq=seq, op=op,
                reason="divergence",
            )
        if len(got.body) != nbytes or got.body != expect:
            raise TransportError(
                f"party {self.party}: exchange {seq} ({op}) body mismatch "
                f"({len(got.body)} bytes vs expected {nbytes}) — parties "
                f"diverged",
                party=self.party, peer=self.recv_from, seq=seq, op=op,
                reason="divergence",
            )
        self.count += 1
        self.wire_bytes += nbytes
        self.log.append({"op": op, "bytes": nbytes, "rounds": int(rounds)})

    def by_op(self) -> dict:
        agg: dict = {}
        for e in self.log:
            a = agg.setdefault(e["op"], {"bytes": 0, "exchanges": 0})
            a["bytes"] += e["bytes"]
            a["exchanges"] += 1
        return agg

    def log_summary(self) -> dict:
        """Compact deterministic form of the exchange log for capped execute
        replies: exact byte/round/entry totals plus the per-op aggregation
        and the first few entries. Pure functions of the full log, so the
        summaries of lockstepped parties are equal iff their logs are."""
        return {
            "summary": True,
            "entries": len(self.log),
            "bytes": self.wire_bytes,
            "rounds": sum(e["rounds"] for e in self.log),
            "by_op": self.by_op(),
            "head": self.log[:8],
        }
