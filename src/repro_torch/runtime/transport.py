"""Framed party-to-party transports for the multi-party runtime (a port of
``repro.runtime.transport``: pure Python, and the wire format is the
reference's byte for byte, so either package reads the other's frames).

One :class:`Frame` is one length-prefixed message on a *directed link*
``src -> dst``. The wire format (DESIGN.md §16.2)::

    MAGIC  b"RFLX"            4 bytes
    ver    0x01               1 byte
    kind   DATA=0 | CTRL=1    1 byte
    src    party id           1 byte   (0..2 parties, 3 = coordinator)
    dst    party id           1 byte
    seq    uint64 BE          8 bytes  (contiguous per directed link)
    oplen  uint8              1 byte
    blen   uint32 BE          4 bytes  (body length — the ledger's bytes)
    crc    uint32 BE          4 bytes  (crc32 of body)
    op     oplen bytes        (utf-8 ledger op, e.g. "mul", "reveal_k")
    body   blen bytes

Receivers verify magic/version (anything else is a torn or misaligned
frame), the crc (payload corruption), and that ``seq`` is exactly the next
sequence number for the link (reordering/duplication). Violations raise
:class:`repro_torch.errors.TransportError` with a machine-readable ``reason``.

Two implementations share that framing:

* :class:`LoopbackTransport` — an in-process mesh of queues. Frames are
  still encoded to bytes and decoded on receipt, so loopback exercises the
  exact framing/validation path TCP uses (and tests can inject corrupt
  bytes); it is the fast path for in-process party threads.
* :class:`TcpTransport` — one TCP socket per peer pair carrying both
  directions. Dial-side connects with jittered exponential retry/backoff;
  each socket gets a writer thread (sends never block the protocol thread —
  three parties sending simultaneously on a ring cannot deadlock) and a
  reader thread demuxing frames into per-source queues.

Every transport keeps a :class:`WireStats` ledger of its own wire activity
(per-directed-link frames/bytes/latency, rejected inbound frames, dial
retries and backoff sleeps); ``wire_snapshot()`` is the JSON-safe view the
``stats`` control verb ships to the coordinator (DESIGN.md §17).
"""
from __future__ import annotations

import queue
import random
import socket
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..errors import TransportError

__all__ = [
    "Frame",
    "DATA",
    "CTRL",
    "COORD",
    "encode_frame",
    "decode_frame",
    "WireStats",
    "Transport",
    "LoopbackMesh",
    "LoopbackTransport",
    "TcpTransport",
]

MAGIC = b"RFLX"
VERSION = 1
DATA = 0
CTRL = 1
COORD = 3  # the coordinator's id on control links (parties are 0..2)

_HDR = struct.Struct(">4sBBBBQBII")  # magic ver kind src dst seq oplen blen crc


@dataclass
class Frame:
    kind: int
    src: int
    dst: int
    seq: int
    op: str
    body: bytes


def encode_frame(f: Frame) -> bytes:
    op = f.op.encode("utf-8")
    if len(op) > 255:
        raise ValueError(f"op too long: {f.op!r}")
    hdr = _HDR.pack(
        MAGIC, VERSION, f.kind, f.src, f.dst, f.seq,
        len(op), len(f.body), zlib.crc32(f.body) & 0xFFFFFFFF,
    )
    return hdr + op + f.body


def decode_frame(buf: bytes, *, party: Optional[int] = None) -> Frame:
    """Decode one complete frame; raises TransportError on any violation."""
    if len(buf) < _HDR.size:
        raise TransportError(
            f"short frame: {len(buf)} < header {_HDR.size}",
            party=party, reason="torn-frame",
        )
    magic, ver, kind, src, dst, seq, oplen, blen, crc = _HDR.unpack_from(buf)
    if magic != MAGIC or ver != VERSION:
        raise TransportError(
            f"bad magic/version {magic!r}/{ver}", party=party,
            reason="torn-frame",
        )
    if len(buf) != _HDR.size + oplen + blen:
        raise TransportError(
            f"frame length {len(buf)} != header-declared "
            f"{_HDR.size + oplen + blen}",
            party=party, seq=seq, reason="torn-frame",
        )
    op = buf[_HDR.size:_HDR.size + oplen].decode("utf-8")
    body = buf[_HDR.size + oplen:]
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise TransportError(
            f"crc mismatch on {op!r} frame (seq {seq})",
            party=party, peer=src, seq=seq, op=op, reason="torn-frame",
        )
    return Frame(kind=kind, src=src, dst=dst, seq=seq, op=op, body=body)


class _Closed:
    """Inbound-queue sentinel: the link died. Carries the error to raise."""

    def __init__(self, err: TransportError):
        self.err = err


_KIND_NAMES = {DATA: "data", CTRL: "ctrl"}


class WireStats:
    """Per-directed-link wire counters, kept by every transport.

    Plain locked dicts — party processes have no metrics registry; they
    ship :meth:`snapshot` (a JSON-safe dict whose keys come from the public
    telemetry vocabulary, see ``obs/redact.py``) to the coordinator through
    the ``stats`` control verb, and the coordinator's
    :class:`~repro_torch.obs.distributed.WireMetricsPublisher` turns the
    cumulative totals into ``reflex_wire_*`` metric deltas.

    Tracked per (link, kind): frames, body bytes, seconds (send-path time
    for outbound; blocked-on-recv wait for inbound). Plus inbound-frame
    rejections by reason (``crc`` / ``seq`` / ``torn-frame`` / ...), and
    TCP dial retries with the jittered backoff seconds they slept.
    """

    def __init__(self, party: int):
        self.party = party
        self._lock = threading.Lock()
        # (link, kindname) -> [frames, bytes, seconds]
        self._sent: Dict[Tuple[str, str], list] = {}
        self._recv: Dict[Tuple[str, str], list] = {}
        self._rejects: Dict[str, int] = {}
        self._connects: Dict[int, list] = {}  # peer -> [retries, backoff_s]

    @staticmethod
    def _kind(kind: int) -> str:
        return _KIND_NAMES.get(kind, str(kind))

    def record_send(self, dst: int, kind: int, nbytes: int,
                    seconds: float) -> None:
        key = (f"{self.party}->{dst}", self._kind(kind))
        with self._lock:
            st = self._sent.setdefault(key, [0, 0, 0.0])
            st[0] += 1
            st[1] += int(nbytes)
            st[2] += float(seconds)

    def record_recv(self, src: int, kind: int, nbytes: int,
                    wait_seconds: float) -> None:
        key = (f"{src}->{self.party}", self._kind(kind))
        with self._lock:
            st = self._recv.setdefault(key, [0, 0, 0.0])
            st[0] += 1
            st[1] += int(nbytes)
            st[2] += float(wait_seconds)

    def record_reject(self, reason: str) -> None:
        with self._lock:
            self._rejects[reason] = self._rejects.get(reason, 0) + 1

    def record_connect(self, peer: int, retries: int,
                       backoff_seconds: float) -> None:
        with self._lock:
            st = self._connects.setdefault(peer, [0, 0.0])
            st[0] += int(retries)
            st[1] += float(backoff_seconds)

    def snapshot(self, send_seq: Dict[int, int],
                 recv_seq: Dict[int, int]) -> Dict:
        """JSON-safe cumulative totals + the transport's seq watermarks."""
        with self._lock:
            sent = [
                {"link": lk, "kind": kd, "frames": f, "bytes": b,
                 "seconds": s}
                for (lk, kd), (f, b, s) in sorted(self._sent.items())
            ]
            recv = [
                {"link": lk, "kind": kd, "frames": f, "bytes": b,
                 "seconds": s}
                for (lk, kd), (f, b, s) in sorted(self._recv.items())
            ]
            rejects = [
                {"reason": r, "count": c}
                for r, c in sorted(self._rejects.items())
            ]
            connects = [
                {"peer": p, "retries": r, "backoff_seconds": s}
                for p, (r, s) in sorted(self._connects.items())
            ]
        peers = sorted(set(send_seq) | set(recv_seq))
        links = [
            {"link": f"{self.party}<->{p}",
             "sent": int(send_seq.get(p, 0)),
             "recv": int(recv_seq.get(p, 0))}
            for p in peers
        ]
        return {
            "party": self.party,
            "sent": sent,
            "recv": recv,
            "rejects": rejects,
            "connects": connects,
            "links": links,
        }


class Transport:
    """Base: per-directed-link sequence numbering + validation.

    Subclasses implement ``_push(dst, data: bytes)`` (enqueue encoded bytes
    for delivery) and fill ``self._inbox[src]`` queues with raw bytes (or
    :class:`_Closed`). ``send``/``recv`` here do the framing, sequencing,
    and validation once for both implementations.
    """

    def __init__(self, party: int):
        self.party = party
        self._send_seq: Dict[int, int] = {}
        self._recv_seq: Dict[int, int] = {}
        self._inbox: Dict[int, "queue.Queue"] = {}
        self._lock = threading.Lock()
        self.sent_frames = 0
        self.sent_bytes = 0  # body bytes only: the wire-vs-ledger figure
        self.wire = WireStats(party)

    def _inbox_for(self, src: int) -> "queue.Queue":
        with self._lock:
            q = self._inbox.get(src)
            if q is None:
                q = self._inbox[src] = queue.Queue()
            return q

    def send(self, dst: int, op: str, body: bytes, kind: int = DATA) -> None:
        with self._lock:
            seq = self._send_seq.get(dst, 0)
            self._send_seq[dst] = seq + 1
        f = Frame(kind=kind, src=self.party, dst=dst, seq=seq, op=op, body=body)
        t0 = time.perf_counter()
        self._push(dst, encode_frame(f))
        self.wire.record_send(dst, kind, len(body),
                              time.perf_counter() - t0)
        self.sent_frames += 1
        if kind == DATA:
            self.sent_bytes += len(body)

    def recv(self, src: int, timeout: Optional[float] = 30.0) -> Frame:
        q = self._inbox_for(src)
        t0 = time.perf_counter()
        try:
            item = q.get(timeout=timeout)
        except queue.Empty:
            self.wire.record_reject("timeout")
            raise TransportError(
                f"party {self.party}: no frame from {src} within {timeout}s",
                party=self.party, peer=src, reason="timeout",
            ) from None
        wait = time.perf_counter() - t0
        if isinstance(item, _Closed):
            q.put(item)  # subsequent recvs fail the same way
            raise item.err
        try:
            f = decode_frame(item, party=self.party)
        except TransportError as e:
            # finer rejection taxonomy for the wire metrics than the error's
            # stable `reason` vocabulary: crc corruption vs torn framing
            self.wire.record_reject(
                "crc" if "crc mismatch" in str(e) else e.reason
            )
            raise
        if f.src != src:
            self.wire.record_reject("seq")
            raise TransportError(
                f"frame from {f.src} on link {src}->{self.party}",
                party=self.party, peer=src, seq=f.seq, op=f.op,
                reason="bad-seq",
            )
        expect = self._recv_seq.get(src, 0)
        if f.seq != expect:
            self.wire.record_reject("seq")
            raise TransportError(
                f"out-of-order frame from {src}: seq {f.seq}, expected "
                f"{expect}",
                party=self.party, peer=src, seq=f.seq, op=f.op,
                reason="bad-seq",
            )
        self._recv_seq[src] = expect + 1
        self.wire.record_recv(src, f.kind, len(f.body), wait)
        return f

    def wire_snapshot(self) -> Dict:
        """This transport's cumulative wire stats + seq watermarks (the
        per-party payload of the ``stats`` control verb)."""
        with self._lock:
            ss, rs = dict(self._send_seq), dict(self._recv_seq)
        return self.wire.snapshot(ss, rs)

    def _push(self, dst: int, data: bytes) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


# -----------------------------------------------------------------------------
# Loopback: in-process mesh of queues, framed
# -----------------------------------------------------------------------------

class LoopbackMesh:
    """Shared rendezvous for in-process parties: one byte-queue per directed
    pair. Create one mesh, then one :class:`LoopbackTransport` per
    participant."""

    def __init__(self):
        self._queues: Dict[Tuple[int, int], "queue.Queue"] = {}
        self._lock = threading.Lock()

    def queue_for(self, src: int, dst: int) -> "queue.Queue":
        with self._lock:
            q = self._queues.get((src, dst))
            if q is None:
                q = self._queues[(src, dst)] = queue.Queue()
            return q

    def inject(self, src: int, dst: int, data: bytes) -> None:
        """Deliver raw bytes on a link, bypassing framing — the torn-frame
        and corruption tests use this to simulate a broken peer."""
        self.queue_for(src, dst).put(data)


class LoopbackTransport(Transport):
    def __init__(self, mesh: LoopbackMesh, party: int):
        super().__init__(party)
        self.mesh = mesh
        self._closed = False

    def _push(self, dst: int, data: bytes) -> None:
        if self._closed:
            raise TransportError(
                f"party {self.party}: send on closed transport",
                party=self.party, peer=dst, reason="closed",
            )
        self.mesh.queue_for(self.party, dst).put(data)

    def _inbox_for(self, src: int) -> "queue.Queue":
        # the mesh queue IS the inbox — no copy thread needed in-process
        return self.mesh.queue_for(src, self.party)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # wake peers blocked on us: a closed loopback party delivers the
        # same "peer died" failure a dropped TCP connection would
        err = TransportError(
            f"party {self.party} closed its transport",
            party=self.party, reason="crashed",
        )
        with self.mesh._lock:
            links = [k for k in self.mesh._queues if k[0] == self.party]
        for src, dst in links:
            self.mesh.queue_for(src, dst).put(_Closed(err))


# -----------------------------------------------------------------------------
# TCP: one socket per peer pair, writer thread per socket
# -----------------------------------------------------------------------------

def _read_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes; b"" on clean EOF at a frame boundary (returns
    short data otherwise so the caller can flag a torn frame)."""
    chunks = []
    got = 0
    while got < n:
        b = sock.recv(min(n - got, 1 << 20))
        if not b:
            break
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


class TcpTransport(Transport):
    """Socket transport: ``listen()`` accepts inbound peers, ``dial(peer)``
    connects outbound with retry/backoff. Either way the socket serves both
    directions of the pair."""

    def __init__(
        self,
        party: int,
        endpoints: Dict[int, Tuple[str, int]],
        *,
        connect_retries: int = 40,
        backoff_s: float = 0.05,
        backoff_cap_s: float = 1.0,
        jitter_seed: Optional[int] = None,
    ):
        super().__init__(party)
        self.endpoints = dict(endpoints)
        self.connect_retries = connect_retries
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        # jittered backoff: parties restarted in lockstep must not hammer
        # the listener in lockstep too (seedable for deterministic tests)
        self._rng = random.Random(jitter_seed)
        self._socks: Dict[int, socket.socket] = {}
        self._outq: Dict[int, "queue.Queue"] = {}
        self._threads: list = []
        self._listener: Optional[socket.socket] = None
        self._closing = False

    # -- link establishment ---------------------------------------------------
    def listen(self) -> Tuple[str, int]:
        host, port = self.endpoints[self.party]
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(8)
        self._listener = srv
        self.endpoints[self.party] = srv.getsockname()[:2]
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self.endpoints[self.party]

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            # the dialer introduces itself with one hello frame
            try:
                hello = self._read_frame(sock, peer=None)
            except TransportError:
                sock.close()
                continue
            self._register(hello.src, sock)

    def dial(self, peer: int) -> None:
        host, port = self.endpoints[peer]
        delay = self.backoff_s
        last: Optional[Exception] = None
        retries = 0
        slept = 0.0
        for _ in range(self.connect_retries):
            try:
                sock = socket.create_connection((host, port), timeout=5.0)
                sock.settimeout(None)  # connect deadline only — links idle
                break
            except OSError as e:
                last = e
                retries += 1
                # full-range jitter around the exponential schedule
                # (0.5x..1.5x): simultaneous restarts decorrelate instead of
                # colliding on every attempt
                pause = delay * (0.5 + self._rng.random())
                time.sleep(pause)
                slept += pause
                delay = min(delay * 1.6, self.backoff_cap_s)
        else:
            self.wire.record_connect(peer, retries, slept)
            raise TransportError(
                f"party {self.party}: cannot connect to party {peer} at "
                f"{host}:{port} after {self.connect_retries} attempts",
                party=self.party, peer=peer, reason="connect",
            ) from last
        if retries:
            self.wire.record_connect(peer, retries, slept)
        sock.sendall(encode_frame(
            Frame(kind=CTRL, src=self.party, dst=peer, seq=0, op="hello",
                  body=b"")
        ))
        self._register(peer, sock)

    def _register(self, peer: int, sock: socket.socket) -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._lock:
            self._socks[peer] = sock
            outq = self._outq[peer] = queue.Queue()
        tw = threading.Thread(
            target=self._writer_loop, args=(peer, sock, outq), daemon=True
        )
        tr = threading.Thread(
            target=self._reader_loop, args=(peer, sock), daemon=True
        )
        tw.start()
        tr.start()
        self._threads += [tw, tr]

    def wait_for(self, peer: int, timeout: float = 10.0) -> None:
        """Block until an inbound connection from ``peer`` is registered."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if peer in self._socks:
                    return
            time.sleep(0.005)
        raise TransportError(
            f"party {self.party}: no connection from {peer} within {timeout}s",
            party=self.party, peer=peer, reason="connect",
        )

    # -- IO loops -------------------------------------------------------------
    def _writer_loop(self, peer, sock, outq) -> None:
        while True:
            data = outq.get()
            if data is None:
                return
            try:
                sock.sendall(data)
            except OSError:
                return  # reader side reports the failure

    def _read_frame(self, sock, peer) -> Frame:
        try:
            return self._read_frame_inner(sock, peer)
        except OSError as e:
            # socket torn down under the reader (peer reset, local close)
            raise TransportError(
                f"party {self.party}: link to {peer} dropped ({e})",
                party=self.party, peer=peer,
                reason="closed" if self._closing else "crashed",
            ) from e

    def _read_frame_inner(self, sock, peer) -> Frame:
        hdr = _read_exact(sock, _HDR.size)
        if not hdr:
            raise TransportError(
                f"party {self.party}: peer {peer} closed the connection",
                party=self.party, peer=peer,
                reason="closed" if self._closing else "crashed",
            )
        if len(hdr) < _HDR.size:
            raise TransportError(
                f"party {self.party}: torn header from {peer} "
                f"({len(hdr)}/{_HDR.size} bytes)",
                party=self.party, peer=peer, reason="torn-frame",
            )
        magic, ver, kind, src, dst, seq, oplen, blen, crc = _HDR.unpack(hdr)
        if magic != MAGIC or ver != VERSION:
            raise TransportError(
                f"party {self.party}: bad magic/version from {peer}",
                party=self.party, peer=peer, reason="torn-frame",
            )
        rest = _read_exact(sock, oplen + blen)
        if len(rest) < oplen + blen:
            raise TransportError(
                f"party {self.party}: torn body from {peer} "
                f"({len(rest)}/{oplen + blen} bytes)",
                party=self.party, peer=peer, seq=seq, reason="torn-frame",
            )
        return decode_frame(hdr + rest, party=self.party)

    def _reader_loop(self, peer, sock) -> None:
        while True:
            try:
                f = self._read_frame(sock, peer)
            except TransportError as e:
                self._inbox_for(peer).put(_Closed(e))
                return
            # re-encode for the shared validation path in Transport.recv
            # (cheap: header + memoryview of body)
            self._inbox_for(f.src).put(encode_frame(f))

    # -- Transport hooks ------------------------------------------------------
    def _push(self, dst: int, data: bytes) -> None:
        with self._lock:
            outq = self._outq.get(dst)
        if outq is None:
            raise TransportError(
                f"party {self.party}: no link to {dst}",
                party=self.party, peer=dst, reason="closed",
            )
        outq.put(data)

    def close(self) -> None:
        self._closing = True
        with self._lock:
            outqs = list(self._outq.values())
            socks = list(self._socks.values())
            self._outq.clear()
            self._socks.clear()
        for q in outqs:
            q.put(None)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
