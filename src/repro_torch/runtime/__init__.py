"""Multi-party runtime: real party threads or processes, real framed bytes,
one client API (a port of ``repro.runtime``).

Layers (DESIGN.md §16):

* :mod:`~repro_torch.runtime.transport` — length-prefixed CRC-checked
  framing over loopback queues or TCP, with per-link sequence numbers; the
  reference's wire format byte for byte.
* :mod:`~repro_torch.runtime.exchange` — the ring-exchange driver that turns
  every :class:`~repro_torch.core.ledger.CommLedger` sync point into a
  verified wire exchange.
* :mod:`~repro_torch.runtime.party` — one RSS party's server loop, its
  engine on the card unless asked for the CPU.
* :mod:`~repro_torch.runtime.coordinator` — drives three parties, audits
  wire-vs-ledger bytes, reassembles results (:class:`RemoteEngine`).
* :mod:`~repro_torch.runtime.client` — :class:`ReflexClient`, the unified
  facade over in-process and networked execution.
* :mod:`~repro_torch.runtime.run_parties` — ``python -m`` launcher of the
  party processes over TCP.
"""
from .client import ReflexClient
from .coordinator import (
    Coordinator,
    RemoteEngine,
    connect_tcp,
    launch_loopback_mesh,
)
from .exchange import RingExchange
from .party import PartyServer, decode_table, encode_table
from .transport import (
    COORD,
    CTRL,
    DATA,
    Frame,
    LoopbackMesh,
    LoopbackTransport,
    TcpTransport,
    Transport,
    decode_frame,
    encode_frame,
)

__all__ = [
    "ReflexClient",
    "Coordinator",
    "RemoteEngine",
    "connect_tcp",
    "launch_loopback_mesh",
    "RingExchange",
    "PartyServer",
    "encode_table",
    "decode_table",
    "Transport",
    "LoopbackMesh",
    "LoopbackTransport",
    "TcpTransport",
    "Frame",
    "encode_frame",
    "decode_frame",
    "DATA",
    "CTRL",
    "COORD",
]
