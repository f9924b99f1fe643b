"""The port's framed transports (``repro_torch.runtime.transport``): the
reference's transport cases (wire format, sequencing, failure taxonomy over
the loopback mesh and real TCP sockets), and the two packages against each
other — the same ``Frame`` encodes to the same bytes, each package decodes
the other's frames and rejects the other's corrupt ones with the same
``reason``, and their wire statistics agree.

The TCP give-up case drives the dial loop with a connect that raises
``ConnectionRefusedError``: whether a connect to a closed loopback port
fails depends on the host's network stack, and the case is about the retry
loop, not the host."""
import socket
import threading
import time

import pytest

pytest.importorskip("jax")

from repro.runtime import transport as jtransport  # noqa: E402
from repro_torch.errors import ReflexError, TransportError  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    COORD,
    CTRL,
    DATA,
    Frame,
    LoopbackMesh,
    LoopbackTransport,
    TcpTransport,
    decode_frame,
    encode_frame,
)
from repro_torch.runtime import transport as ttransport  # noqa: E402

# -----------------------------------------------------------------------------
# Frame codec
# -----------------------------------------------------------------------------


def test_frame_round_trip():
    f = Frame(kind=DATA, src=0, dst=2, seq=7, op="mul", body=b"\x01" * 33)
    g = decode_frame(encode_frame(f))
    assert (g.kind, g.src, g.dst, g.seq, g.op, g.body) == (
        DATA, 0, 2, 7, "mul", b"\x01" * 33,
    )


def test_frame_round_trip_empty_body_and_ctrl():
    f = Frame(kind=CTRL, src=3, dst=1, seq=0, op="hello", body=b"")
    g = decode_frame(encode_frame(f))
    assert g.kind == CTRL and g.op == "hello" and g.body == b""


def test_decode_rejects_bad_magic():
    buf = bytearray(encode_frame(Frame(DATA, 0, 1, 0, "mul", b"xy")))
    buf[:4] = b"NOPE"
    with pytest.raises(TransportError) as ei:
        decode_frame(bytes(buf))
    assert ei.value.reason == "torn-frame"


def test_decode_rejects_truncated_frame():
    buf = encode_frame(Frame(DATA, 0, 1, 0, "mul", b"hello world"))
    with pytest.raises(TransportError) as ei:
        decode_frame(buf[:-3])
    assert ei.value.reason == "torn-frame"


def test_decode_rejects_corrupt_body_crc():
    buf = bytearray(encode_frame(Frame(DATA, 0, 1, 0, "mul", b"hello")))
    buf[-1] ^= 0xFF
    with pytest.raises(TransportError) as ei:
        decode_frame(bytes(buf))
    assert ei.value.reason == "torn-frame"


def test_decode_rejects_overlong_op():
    with pytest.raises(ValueError):
        encode_frame(Frame(DATA, 0, 1, 0, "x" * 300, b""))


def test_transport_error_is_typed():
    e = TransportError("boom", party=1, peer=2, seq=9, op="mul",
                       reason="bad-seq")
    assert isinstance(e, ReflexError) and isinstance(e, RuntimeError)
    assert (e.party, e.peer, e.seq, e.op, e.reason) == (1, 2, 9, "mul",
                                                        "bad-seq")


# -----------------------------------------------------------------------------
# Loopback semantics (shared validation path)
# -----------------------------------------------------------------------------


def make_pair():
    mesh = LoopbackMesh()
    return mesh, LoopbackTransport(mesh, 0), LoopbackTransport(mesh, 1)


def test_loopback_send_recv_orders_frames():
    _, a, b = make_pair()
    for i in range(5):
        a.send(1, "mul", bytes([i]) * 4)
    for i in range(5):
        f = b.recv(0, timeout=1.0)
        assert f.seq == i and f.body == bytes([i]) * 4
    assert a.sent_frames == 5 and a.sent_bytes == 20


def test_loopback_sent_bytes_counts_data_only():
    _, a, b = make_pair()
    a.send(1, "hello", b"\x00" * 100, kind=CTRL)
    a.send(1, "mul", b"\x00" * 7, kind=DATA)
    b.recv(0, timeout=1.0)
    b.recv(0, timeout=1.0)
    assert a.sent_bytes == 7  # the wire-vs-ledger figure excludes control


def test_loopback_recv_timeout():
    _, _a, b = make_pair()
    with pytest.raises(TransportError) as ei:
        b.recv(0, timeout=0.05)
    assert ei.value.reason == "timeout"


def test_out_of_order_frame_rejected():
    mesh, a, b = make_pair()
    mesh.inject(0, 1, encode_frame(Frame(DATA, 0, 1, 1, "mul", b"zz")))
    with pytest.raises(TransportError) as ei:
        b.recv(0, timeout=1.0)
    assert ei.value.reason == "bad-seq" and ei.value.seq == 1


def test_duplicated_frame_rejected():
    mesh, a, b = make_pair()
    buf = encode_frame(Frame(DATA, 0, 1, 0, "mul", b"zz"))
    mesh.inject(0, 1, buf)
    mesh.inject(0, 1, buf)  # replay
    assert b.recv(0, timeout=1.0).seq == 0
    with pytest.raises(TransportError) as ei:
        b.recv(0, timeout=1.0)
    assert ei.value.reason == "bad-seq"


def test_torn_frame_rejected_on_recv():
    mesh, _a, b = make_pair()
    buf = encode_frame(Frame(DATA, 0, 1, 0, "mul", b"full frame body"))
    mesh.inject(0, 1, buf[: len(buf) - 4])
    with pytest.raises(TransportError) as ei:
        b.recv(0, timeout=1.0)
    assert ei.value.reason == "torn-frame"


def test_misrouted_frame_rejected():
    mesh, _a, b = make_pair()
    mesh.inject(0, 1, encode_frame(Frame(DATA, 2, 1, 0, "mul", b"zz")))
    with pytest.raises(TransportError) as ei:
        b.recv(0, timeout=1.0)
    assert ei.value.reason == "bad-seq"


def test_closed_loopback_peer_raises_crashed_and_sticks():
    _, a, b = make_pair()
    a.send(1, "mul", b"ok")
    assert b.recv(0, timeout=1.0).op == "mul"
    a.close()
    for _ in range(2):  # sticky: every later recv fails the same way
        with pytest.raises(TransportError) as ei:
            b.recv(0, timeout=1.0)
        assert ei.value.reason == "crashed"
    with pytest.raises(TransportError) as ei:
        a.send(1, "mul", b"more")
    assert ei.value.reason == "closed"


# -----------------------------------------------------------------------------
# TCP
# -----------------------------------------------------------------------------


def tcp_pair(base_port):
    eps = {0: ("127.0.0.1", base_port), 1: ("127.0.0.1", base_port + 1)}
    a = TcpTransport(0, eps)
    eps[0] = a.listen()  # resolve the OS-assigned port before b copies eps
    b = TcpTransport(1, eps)
    b.dial(0)
    a.wait_for(1, timeout=10.0)
    return a, b


def test_tcp_round_trip_both_directions():
    a, b = tcp_pair(0)  # port 0: OS-assigned, collision-free
    try:
        for i in range(10):
            b.send(0, "mul", bytes([i]) * 16)
        for i in range(10):
            f = a.recv(1, timeout=10.0)
            assert f.seq == i and f.body == bytes([i]) * 16
        a.send(1, "reveal", b"result", kind=DATA)
        assert b.recv(0, timeout=10.0).op == "reveal"
    finally:
        a.close()
        b.close()


def test_tcp_large_frame_survives_segmentation():
    a, b = tcp_pair(0)
    try:
        body = bytes(range(256)) * 4096  # 1 MiB >> socket buffers
        b.send(0, "mul", body)
        assert a.recv(1, timeout=30.0).body == body
    finally:
        a.close()
        b.close()


def test_tcp_dial_retries_until_listener_appears():
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    eps = {0: ("127.0.0.1", port), 1: ("127.0.0.1", 0)}
    a = TcpTransport(0, eps)
    b = TcpTransport(1, eps, connect_retries=300, backoff_s=0.02)

    def listen_late():
        time.sleep(0.25)
        a.listen()

    t = threading.Thread(target=listen_late)
    t.start()
    b.dial(0)  # backoff loop must ride out the listener-less window
    t.join(timeout=10.0)
    assert not t.is_alive()
    a.wait_for(1, timeout=10.0)
    try:
        b.send(0, "mul", b"late but delivered")
        assert a.recv(1, timeout=10.0).body == b"late but delivered"
    finally:
        a.close()
        b.close()


def test_tcp_dial_gives_up_with_connect_reason(monkeypatch):
    attempts = []

    def refuse(addr, timeout=None):
        attempts.append(addr)
        raise ConnectionRefusedError(111, "Connection refused")

    monkeypatch.setattr(ttransport.socket, "create_connection", refuse)
    t = TcpTransport(1, {0: ("127.0.0.1", 9), 1: ("127.0.0.1", 0)},
                     connect_retries=3, backoff_s=0.01)
    with pytest.raises(TransportError) as ei:
        t.dial(0)
    assert ei.value.reason == "connect" and ei.value.peer == 0
    assert isinstance(ei.value.__cause__, ConnectionRefusedError)
    assert attempts == [("127.0.0.1", 9)] * 3
    assert t.wire_snapshot()["connects"][0]["retries"] == 3


def test_tcp_peer_crash_surfaces_as_crashed_link():
    a, b = tcp_pair(0)
    try:
        b.send(0, "mul", b"last words")
        assert a.recv(1, timeout=10.0).body == b"last words"
        b.close()  # peer process dies
        with pytest.raises(TransportError) as ei:
            a.recv(1, timeout=10.0)
        assert ei.value.reason in ("crashed", "closed")
    finally:
        a.close()


# -----------------------------------------------------------------------------
# Wire statistics (the transport half of the reference's distributed-obs
# cases)
# -----------------------------------------------------------------------------


def test_rejected_frames_counted_in_wire_stats():
    mesh = LoopbackMesh()
    a = LoopbackTransport(mesh, 0)
    b = LoopbackTransport(mesh, 1)
    a.send(1, "mul", b"ok")
    assert b.recv(0, timeout=1.0).body == b"ok"
    mesh.inject(0, 1, encode_frame(Frame(DATA, 0, 1, 9, "mul", b"skip")))
    with pytest.raises(TransportError):
        b.recv(0, timeout=1.0)
    torn = encode_frame(Frame(DATA, 0, 1, 1, "mul", b"torn apart"))
    mesh.inject(0, 1, torn[:-4])
    with pytest.raises(TransportError):
        b.recv(0, timeout=1.0)
    snap = b.wire_snapshot()
    rejects = {r["reason"]: r["count"] for r in snap["rejects"]}
    assert rejects.get("seq") == 1
    assert rejects.get("torn-frame") == 1
    recv_data = [e for e in snap["recv"] if e["kind"] == "data"]
    assert recv_data and recv_data[0]["frames"] == 1  # only the good frame


@pytest.fixture()
def dead_endpoint():
    """A port that refuses every connect: bound but never listening (and
    held, so the OS cannot hand it out as an ephemeral port)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    yield sock.getsockname()
    sock.close()


def test_tcp_dial_failure_counts_retries_and_jittered_backoff(dead_endpoint):
    t = TcpTransport(1, {0: dead_endpoint, 1: ("127.0.0.1", 0)},
                     connect_retries=3, backoff_s=0.01, jitter_seed=7)
    with pytest.raises(TransportError) as ei:
        t.dial(0)
    assert ei.value.reason == "connect"
    connects = {c["peer"]: c for c in t.wire_snapshot()["connects"]}
    assert connects[0]["retries"] == 3
    assert connects[0]["backoff_seconds"] > 0.0


def test_tcp_backoff_jitter_seeded_and_decorrelated(dead_endpoint):
    def failed_dial_backoff(seed):
        t = TcpTransport(1, {0: dead_endpoint, 1: ("127.0.0.1", 0)},
                         connect_retries=3, backoff_s=0.01, jitter_seed=seed)
        with pytest.raises(TransportError):
            t.dial(0)
        return t.wire_snapshot()["connects"][0]["backoff_seconds"]

    assert failed_dial_backoff(7) == failed_dial_backoff(7)
    assert failed_dial_backoff(7) != failed_dial_backoff(8)


# -----------------------------------------------------------------------------
# Against the reference: one wire format
# -----------------------------------------------------------------------------

OPS = ("mul", "reveal_k", "hello", "bitonic_sort")
BODY_SIZES = (0, 1, 33, 4096)


@pytest.mark.parametrize("kind", [DATA, CTRL], ids=["data", "ctrl"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("nbytes", BODY_SIZES)
def test_encode_frame_is_the_references_bytes(kind, op, nbytes):
    body = bytes((7 * i + nbytes) & 0xFF for i in range(nbytes))
    for src, dst, seq in ((0, 2, 0), (COORD, 1, 2**40 + 3)):
        mine = encode_frame(Frame(kind, src, dst, seq, op, body))
        ref = jtransport.encode_frame(jtransport.Frame(kind, src, dst, seq, op, body))
        assert mine == ref


PACKAGES = {
    "repro_to_port": (jtransport, ttransport),
    "port_to_repro": (ttransport, jtransport),
}


@pytest.mark.parametrize("direction", sorted(PACKAGES))
def test_each_package_decodes_the_others_frames(direction):
    enc, dec = PACKAGES[direction]
    for kind, op, body in ((enc.DATA, "and", b"\x00\xff" * 50), (enc.CTRL, "execute", b"")):
        got = dec.decode_frame(enc.encode_frame(enc.Frame(kind, 1, 3, 11, op, body)))
        assert (got.kind, got.src, got.dst, got.seq, got.op, got.body) == (kind, 1, 3, 11, op, body)


def _corrupt(buf: bytes, how: str) -> bytes:
    b = bytearray(buf)
    if how == "magic":
        b[:4] = b"NOPE"
    elif how == "version":
        b[4] = 2
    elif how == "crc":
        b[-1] ^= 0xFF
    elif how == "truncated":
        del b[-3:]
    elif how == "short":
        del b[10:]
    return bytes(b)


@pytest.mark.parametrize("direction", sorted(PACKAGES))
@pytest.mark.parametrize("how", ["magic", "version", "crc", "truncated", "short"])
def test_corrupt_frames_are_rejected_as_the_reference_rejects_them(direction, how):
    enc, dec = PACKAGES[direction]
    bad = _corrupt(enc.encode_frame(enc.Frame(enc.DATA, 0, 1, 5, "mul", b"hello world")), how)
    reasons = []
    for mod in (dec, enc):  # the decoder under test, and the encoder's own
        with pytest.raises(mod.TransportError) as ei:
            mod.decode_frame(bad, party=1)
        reasons.append((type(ei.value).__name__, ei.value.reason, ei.value.seq))
    assert reasons[0] == reasons[1]


def test_loopback_wire_snapshot_equals_the_references():
    def drive(mod):
        mesh = mod.LoopbackMesh()
        a, b = mod.LoopbackTransport(mesh, 0), mod.LoopbackTransport(mesh, 1)
        a.send(1, "hello", b"\x01" * 9, kind=mod.CTRL)
        for i in range(3):
            a.send(1, "mul", bytes([i]) * (4 + i))
        for _ in range(4):
            b.recv(0, timeout=1.0)
        mesh.inject(0, 1, mod.encode_frame(mod.Frame(mod.DATA, 0, 1, 9, "mul", b"x")))
        with pytest.raises(Exception):
            b.recv(0, timeout=1.0)

        def timeless(snap):  # seconds are the clock's; frames and bytes are the wire's
            for side in ("sent", "recv"):
                for e in snap[side]:
                    e.pop("seconds")
            return snap

        return timeless(a.wire_snapshot()), timeless(b.wire_snapshot()), a.sent_bytes, a.sent_frames

    assert drive(ttransport) == drive(jtransport)
