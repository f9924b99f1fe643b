"""The port's multi-party runtime (``repro_torch.runtime``) on the CPU.

The reference's runtime cases on the port: over the loopback mesh (three
party threads) networked execution is bit-exact with the single-process
oracle, wire bytes equal ledger bytes per party, and failures (a party
crash, a lockstep desync) surface as typed ``TransportError``s that ride the
service's failed-execution budget path. Then the port against the
reference: over the same tables and key seed, the port's networked client
equals ``repro``'s in the reassembled share triples, the per-node ledger,
S and rows, each party's exchange log and wire bytes, and a SHA-256 over
each party's DATA frame bodies in send order. A party with one tampered
share word fails at a payload-carrying exchange in both packages alike.
Every comparison is exact. (The TCP mesh is in
``tests/test_torch_run_parties.py``.)"""
import hashlib
import re
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.runtime as jruntime  # noqa: E402
from repro.data import generate_healthlnk as jgenerate  # noqa: E402
from repro.errors import TransportError as JTransportError  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.config import RuntimeConfig  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.ledger import CommLedger, exchange_scope, fused_scope, log_comm  # noqa: E402
from repro_torch.data import QUERY_SQL, generate_healthlnk  # noqa: E402
from repro_torch.errors import TransportError  # noqa: E402
from repro_torch.plan.nodes import JoinSortMerge  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    PartyServer,
    ReflexClient,
    RemoteEngine,
    decode_table,
    encode_table,
    launch_loopback_mesh,
)
from repro_torch.runtime import transport as ttransport  # noqa: E402
from repro_torch.sql.catalog import Catalog  # noqa: E402

DATA = dict(n=16, seed=3, aspirin_frac=0.5, icd_heart_frac=0.4)
JOIN_GOLDEN = QUERY_SQL["dosage_study"]      # join + resize + reveal_k
GROUPBY_GOLDEN = QUERY_SQL["med_dosage_sum"]  # shuffle/sort groupby
CPU = "cpu"
TIMEOUT = 30.0  # a bound no passing case reaches: never the runtime's 60 s / 120 s defaults


@pytest.fixture(scope="module")
def data():
    return generate_healthlnk(**DATA, device=CPU)


def _networked(tables, exchange_timeout=TIMEOUT, **kw):
    """A networked client over a loopback mesh on the CPU, with short
    timeouts."""
    coord, _servers, _threads = launch_loopback_mesh(
        device=CPU, exchange_timeout=exchange_timeout, request_timeout=TIMEOUT
    )
    return ReflexClient.networked(tables, coordinator=coord, device=CPU, **kw)


def _close(client):
    client.close()
    assert not any(t.is_alive() for t in client.coordinator.party_threads)


@pytest.fixture(scope="module")
def clients(data):
    tables, _ = data
    oracle = ReflexClient.in_process(tables, key=threefry.PRNGKey(0), offline="off", device=CPU)
    networked = _networked(tables, key_seed=0)
    yield oracle, networked
    _close(networked)
    oracle.close()


def assert_same_result(a, b):
    assert set(a.rows) == set(b.rows)
    for k in a.rows:
        np.testing.assert_array_equal(a.rows[k], b.rows[k])


def _tallies(res):
    return [(s.node, s.n_ins, s.n_out, s.bytes_per_party, s.rounds, s.extra.get("s"))
            for s in res.report.nodes]


def _report_nodes(reply):
    """A party's report nodes without what the clock decides."""
    out = []
    for n in reply["report"]["nodes"]:
        n = {k: v for k, v in n.items() if k != "seconds"}
        extra = dict(n.get("extra") or {})
        if "wire" in extra:
            extra["wire"] = {k: v for k, v in extra["wire"].items() if k != "stall_seconds"}
        n["extra"] = extra
        out.append(n)
    return out


# -----------------------------------------------------------------------------
# Bit-exactness vs the single-process oracle
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("sql", [JOIN_GOLDEN, GROUPBY_GOLDEN], ids=["join_resize", "groupby"])
def test_networked_matches_oracle(clients, sql):
    oracle, networked = clients
    want = oracle.submit("tenant", sql)
    got = networked.submit("tenant", sql)
    assert_same_result(want, got)
    assert _tallies(want) == _tallies(got)
    for k in want.table.cols:
        assert np.array_equal(want.table.col(k).shares.numpy(), got.table.col(k).shares.numpy())
    assert got.table.device.type == CPU


def test_wire_bytes_equal_ledger_bytes_per_party(clients):
    _oracle, networked = clients
    res = networked.submit("tenant", JOIN_GOLDEN)
    audit = networked.service.engine.last_wire_audit
    assert [a["party"] for a in audit] == [0, 1, 2]
    total = res.report.to_dict()["total_bytes"]
    for a in audit:
        assert a["wire_bytes"] == a["exchange_bytes"] == a["ledger_bytes"] == total
        assert a["exchanges"] > a["payload_exchanges"] > 0
        assert a["d2h_bytes"] > 0


def test_networked_batched_drain_matches_oracle(clients):
    oracle, networked = clients
    for c in (oracle, networked):
        c.enqueue("t1", GROUPBY_GOLDEN)
        c.enqueue("t2", GROUPBY_GOLDEN)
    want = oracle.drain()
    got = networked.drain()
    assert len(want) == len(got) == 2
    for w, g in zip(want, got):
        assert_same_result(w, g)
        assert _tallies(w) == _tallies(g)
    # the remote engine runs a batch as serial passes
    assert networked.service.engine.last_batch_stats["stacked_nodes"] == 0


def test_networked_explain_analyze_and_status(clients):
    _oracle, networked = clients
    text, res = networked.explain_analyze("tenant", GROUPBY_GOLDEN)
    assert "act.rows" in text and res.rows
    st = networked.status()
    assert st["runtime"]["mode"] == "networked"
    assert st["runtime"]["wire_audit"]


def test_networked_config_is_shipped_to_parties(data):
    tables, plain = data
    cfg = RuntimeConfig(join_algo="sortmerge")
    mult = {t: {"pid": int(np.bincount(cols["pid"]).max())} for t, cols in plain.items()}
    catalog = Catalog.from_tables(tables, multiplicity=mult)
    oracle = ReflexClient.in_process(tables, key=threefry.PRNGKey(0), offline="off", config=cfg,
                                     catalog=catalog, device=CPU)
    networked = _networked(tables, key_seed=0, config=cfg, catalog=catalog)
    try:
        want = oracle.submit("tenant", JOIN_GOLDEN)
        got = networked.submit("tenant", JOIN_GOLDEN)

        def walk(n):
            yield n
            for c in n.children():
                yield from walk(c)

        assert any(isinstance(n, JoinSortMerge) for n in walk(got.plan))
        assert_same_result(want, got)
        assert _tallies(want) == _tallies(got)
    finally:
        _close(networked)
        oracle.close()


# -----------------------------------------------------------------------------
# Failure taxonomy
# -----------------------------------------------------------------------------


def test_party_crash_mid_query_raises_and_charges_budget(data):
    tables, _ = data
    coord, _servers, threads = launch_loopback_mesh(
        device=CPU, fault_after={1: 5}, exchange_timeout=2.0, request_timeout=TIMEOUT
    )
    client = ReflexClient.networked(tables, coordinator=coord, key_seed=0, device=CPU)
    acct = client.service.accountant
    assert acct.status() == []
    with pytest.raises(TransportError):
        client.submit("tenant", JOIN_GOLDEN)
    st = acct.status()
    assert st and all(s["observed"] >= 1 for s in st)
    client.service.close()
    coord.close()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()


def test_lockstep_desync_is_rejected(data):
    tables, _ = data
    networked = _networked(tables, key_seed=0)
    try:
        networked.submit("tenant", JOIN_GOLDEN)
        networked.service.engine._resize_ctr = 999
        with pytest.raises(TransportError) as ei:
            networked.submit("tenant", JOIN_GOLDEN)
        assert ei.value.reason == "divergence"
        assert "desync" in str(ei.value)
    finally:
        _close(networked)


def test_remote_engine_rejects_jit_ops(data):
    tables, _ = data
    with pytest.raises(ValueError, match="jit_ops"):
        RemoteEngine(tables, coordinator=None, jit_ops=True, device=CPU)


@pytest.mark.parametrize("kwarg", [
    {"jit_ops": True}, {"offline": "on"}, {"engine_factory": object},
])
def test_networked_client_pins_constructor_args(data, kwarg):
    tables, _ = data
    with pytest.raises(ValueError, match="pinned"):
        ReflexClient.networked(tables, device=CPU, **kwarg)


# -----------------------------------------------------------------------------
# Table shipping
# -----------------------------------------------------------------------------


def test_encode_decode_table_round_trip(data):
    tables, _ = data
    for t in tables.values():
        enc = encode_table(t)
        assert all(arr.dtype == np.uint32 for _, arr in enc["cols"].values())
        back = decode_table(enc, device=CPU)
        assert list(back.cols) == list(t.cols)
        assert np.array_equal(back.valid.shares.numpy(), t.valid.shares.numpy())
        for col in t.cols:
            a, b = t.col(col), back.col(col)
            assert type(a) is type(b)
            assert np.array_equal(a.shares.numpy(), b.shares.numpy())


def test_a_table_encoded_by_repro_decodes_in_the_port(data):
    tables, _ = data
    jtables, _ = jgenerate(**DATA)
    for name, jt in jtables.items():
        enc = jruntime.encode_table(jt)
        back = decode_table(enc, device=CPU)
        mine = encode_table(tables[name])
        assert list(back.cols) == list(mine["cols"])
        for col, (kind, arr) in enc["cols"].items():
            assert mine["cols"][col][0] == kind
            assert np.array_equal(mine["cols"][col][1], arr)
            assert np.array_equal(back.col(col).shares.numpy().view(np.uint32), arr)
        assert np.array_equal(mine["valid"], enc["valid"])
        # and back: the port's encoding decodes in the reference
        jback = jruntime.decode_table(mine)
        assert np.array_equal(np.asarray(jback.valid.shares), enc["valid"])


# -----------------------------------------------------------------------------
# Against the reference's networked client
# -----------------------------------------------------------------------------


@pytest.fixture()
def wire_bodies(monkeypatch):
    """Every DATA frame body each party sends, in send order, per package."""
    bodies = {"repro": {}, "port": {}}
    for tag, mod in (("repro", jruntime.transport), ("port", ttransport)):
        orig = mod.LoopbackTransport.send

        def send(self, dst, op, body, kind=mod.DATA, _orig=orig, _tag=tag, _data=mod.DATA):
            if kind == _data:
                bodies[_tag].setdefault(self.party, []).append(bytes(body))
            return _orig(self, dst, op, body, kind)

        monkeypatch.setattr(mod.LoopbackTransport, "send", send)
    return bodies


def _recording(client):
    """Keep every party reply of the client's engine passes, full exchange
    logs included."""
    replies = []
    coord = client.coordinator
    coord.exchange_log_cap = 0
    orig = coord.execute_plan

    def execute_plan(*a, **k):
        r = orig(*a, **k)
        replies.append(r)
        return r

    coord.execute_plan = execute_plan
    return replies


@pytest.mark.parametrize("query", ["dosage_study", "med_dosage_sum"])
def test_networked_client_equals_the_references(data, wire_bodies, query):
    tables, _ = data
    jtables, _ = jgenerate(**DATA)
    ref = jruntime.ReflexClient.networked(jtables, key_seed=0)
    mine = _networked(tables, key_seed=0)
    try:
        ref_replies, my_replies = _recording(ref), _recording(mine)
        want = ref.submit("tenant", QUERY_SQL[query])
        got = mine.submit("tenant", QUERY_SQL[query])
    finally:
        _close(mine)
        ref.close()
    assert_same_result(want, got)
    assert _tallies(want) == _tallies(got)
    assert list(want.table.column_names()) == list(got.table.cols)
    for k in got.table.cols:
        assert np.array_equal(np.asarray(want.table.col(k).shares),
                              got.table.col(k).shares.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(want.table.valid.shares),
                          got.table.valid.shares.numpy().view(np.uint32))
    (jr,), (tr,) = ref_replies, my_replies
    for a, b in zip(jr, tr):
        assert a["party"] == b["party"]
        assert a["exchange_log"] == b["exchange_log"] and len(a["exchange_log"]) > 0
        assert a["wire_bytes"] == b["wire_bytes"]
        assert _report_nodes(a) == _report_nodes(b)
    audit = [{k: a[k] for k in ("party", "ledger_bytes", "exchange_bytes", "wire_bytes", "exchanges")}
             for a in mine.service.engine.last_wire_audit]
    assert audit == [{k: a[k] for k in audit[0]} for a in ref.service.engine.last_wire_audit]
    for p in range(3):
        digest = {tag: hashlib.sha256(b"".join(wire_bodies[tag][p])).hexdigest() for tag in wire_bodies}
        assert len(wire_bodies["port"][p]) == len(jr[p]["exchange_log"])
        assert digest["port"] == digest["repro"]


# -----------------------------------------------------------------------------
# The payload repair: shares ride the wire and are checked
# -----------------------------------------------------------------------------

PAYLOAD_OPS = ("reveal", "mul", "and", "reveal_k")


def _tampered_divergence(monkeypatch, party_server_cls, make_client, tables, flip):
    """Flip every bit of one word of party 0's copy of share 1 of
    ``diagnoses.icd9`` after it loads the tables; return the client and the
    error of the first submit. (A single flipped bit can vanish in the
    equality's AND tree, whose gates multiply it by random share bits; a
    whole word reaches the filter's first AND.)"""
    orig = party_server_cls._handle_load_tables

    def load(self, msg):
        ack = orig(self, msg)
        if self.party == 0:
            cols = self.engine.tables["diagnoses"].cols
            cols["icd9"] = flip(cols["icd9"])
        return ack

    monkeypatch.setattr(party_server_cls, "_handle_load_tables", load)
    client = make_client(tables)
    try:
        client.submit("tenant", JOIN_GOLDEN)
    except Exception as e:  # noqa: BLE001 — returned to the caller to inspect
        return client, e
    return client, None


def test_a_tampered_share_fails_at_a_payload_exchange_as_in_the_reference(data, monkeypatch):
    tables, _ = data
    jtables, _ = jgenerate(**DATA)
    def flip(col):
        sh = col.shares.clone()
        sh[1, 3] ^= -1
        return type(col)(sh)

    def jflip(col):
        return type(col)(col.shares.at[1, 3].set(~col.shares[1, 3]))

    mine, err = _tampered_divergence(
        monkeypatch, PartyServer, lambda t: _networked(t, exchange_timeout=2.0, key_seed=0), tables, flip)
    _close(mine)
    ref, jerr = _tampered_divergence(
        monkeypatch, jruntime.PartyServer,
        lambda t: jruntime.ReflexClient.networked(
            t, coordinator=jruntime.launch_loopback_mesh(exchange_timeout=2.0)[0], key_seed=0),
        jtables, jflip,
    )
    ref.close()
    assert isinstance(err, TransportError) and isinstance(jerr, JTransportError)
    assert err.reason == jerr.reason == "divergence"
    where = re.search(r"exchange (\d+) \((\w+)\) body mismatch", str(err))
    assert where and where.group(2) in PAYLOAD_OPS, str(err)
    assert str(err) == str(jerr)


class _Driver:
    def __init__(self):
        self.calls = []
        self.count, self.stall_seconds, self.wire_bytes = 0, 0.0, 0

    def exchange(self, op, rounds, nbytes, payload=None):
        self.calls.append((op, rounds, nbytes, payload))


def test_log_comm_hands_the_payload_to_the_driver_outside_fused_blocks():
    import torch

    payload = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    drv = _Driver()
    with CommLedger() as led, exchange_scope(drv):
        log_comm("reveal", 1, 16, payload=payload)
        with fused_scope("lt", rounds=2):
            log_comm("and", 1, 16, payload=payload)
            log_comm("and", 1, 16, payload=payload)
        log_comm("mul", 1, 16)
    assert [c[:3] for c in drv.calls] == [("reveal", 1, 16), ("lt", 2, 32), ("mul", 1, 16)]
    assert drv.calls[0][3] is payload
    assert drv.calls[1][3] is None and drv.calls[2][3] is None
    assert led.tally() == {"bytes_per_party": 64, "rounds": 4}
    # no driver installed: the ledger tallies the same and nothing reads the payload
    with CommLedger() as led2:
        log_comm("reveal", 1, 16, payload=payload)
    assert led2.tally() == {"bytes_per_party": 16, "rounds": 1}


# -----------------------------------------------------------------------------
# Launch accounting under three party threads
# -----------------------------------------------------------------------------


def test_launch_counts_from_three_threads_are_exact():
    per_thread = 20_000
    kernels.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels.record_launch("rss_gate") for _ in range(per_thread)])
                   for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert kernels.launch_counts() == {"rss_gate": 3 * per_thread}
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {}


def test_build_holds_an_exclusive_lock_from_check_to_link(tmp_path, monkeypatch):
    """``kernels.build`` runs the staleness check, the compiles and the link
    under an exclusive ``flock``: another process's build waits, so party
    processes that start together never link a half-written object."""
    import fcntl

    monkeypatch.setattr(kernels, "_BUILD", tmp_path)
    held = []

    def probe():
        with open(tmp_path / "build.lock", "w") as other:  # a second open file, as another process has
            try:
                fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:
                held.append(True)
        return tmp_path / "lib.so"

    monkeypatch.setattr(kernels, "_build_locked", probe)
    assert kernels.build() == tmp_path / "lib.so"
    assert held == [True]
    with open(tmp_path / "build.lock", "w") as after:  # released once build returns
        fcntl.flock(after, fcntl.LOCK_EX | fcntl.LOCK_NB)

