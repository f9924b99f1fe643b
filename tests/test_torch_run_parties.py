"""The port's multi-party runtime over TCP, on the CPU: three party servers
on threads over ``TcpTransport`` on OS-assigned ports, and three party
processes started by ``python -m repro_torch.runtime.run_parties --party
all --base-port 0``; each serves a coordinator from ``connect_tcp`` /
``Coordinator`` and gives the single-process oracle's result (rows and
per-node ledger, exact), with wire bytes equal to ledger bytes."""
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from repro_torch.core import threefry
from repro_torch.data import QUERY_SQL, generate_healthlnk
from repro_torch.runtime import (
    COORD,
    Coordinator,
    PartyServer,
    ReflexClient,
    TcpTransport,
    connect_tcp,
)

ROOT = Path(__file__).resolve().parents[1]
DATA = dict(n=16, seed=3, aspirin_frac=0.5, icd_heart_frac=0.4)
JOIN_GOLDEN = QUERY_SQL["dosage_study"]
CPU = "cpu"
TIMEOUT = 30.0  # a bound no passing case reaches


def _fresh_oracle(tables):
    return ReflexClient.in_process(tables, key=threefry.PRNGKey(0), offline="off", device=CPU)


def assert_same_result(a, b):
    assert set(a.rows) == set(b.rows)
    for k in a.rows:
        np.testing.assert_array_equal(a.rows[k], b.rows[k])


def _tallies(res):
    return [(s.node, s.n_ins, s.n_out, s.bytes_per_party, s.rounds, s.extra.get("s"))
            for s in res.report.nodes]


def test_tcp_mesh_of_party_threads_equals_the_oracle():
    """Three party servers over TcpTransport on OS-assigned ports (the
    process topology of run_parties, on threads): the oracle's result."""
    tables, _ = generate_healthlnk(**DATA, device=CPU)
    oracle = _fresh_oracle(tables)
    parties = [TcpTransport(p, {p: ("127.0.0.1", 0)}) for p in range(3)]
    endpoints = {p: tr.listen() for p, tr in enumerate(parties)}
    for p, tr in enumerate(parties):
        tr.endpoints.update(endpoints)
        for q in range(p):
            tr.dial(q)
    for p, tr in enumerate(parties):
        for q in range(p + 1, 3):
            tr.wait_for(q, timeout=TIMEOUT)
    servers = [PartyServer(p, tr, tr, exchange_timeout=TIMEOUT, device=CPU) for p, tr in enumerate(parties)]
    threads = [threading.Thread(target=s.serve, daemon=True) for s in servers]
    for t in threads:
        t.start()
    ctrl = TcpTransport(COORD, endpoints)
    for p in range(3):
        ctrl.dial(p)
    coord = Coordinator(ctrl, request_timeout=TIMEOUT)
    coord.hello()
    client = ReflexClient.networked(tables, coordinator=coord, key_seed=0, device=CPU)
    try:
        got = client.submit("tenant", JOIN_GOLDEN)
        want = oracle.submit("tenant", JOIN_GOLDEN)
        assert_same_result(want, got)
        assert _tallies(want) == _tallies(got)
        audit = client.service.engine.last_wire_audit
        assert all(a["wire_bytes"] == a["ledger_bytes"] for a in audit)
        mesh = client.status()["runtime"]["mesh"]
        assert mesh["ok"] and [p["party"] for p in mesh["parties"]] == [0, 1, 2]
    finally:
        client.close()
        oracle.close()
        for s in servers:
            s.close()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()


def _endpoints_from(proc, timeout: float):
    """Read ``[party p] listening on HOST:PORT`` lines until all three parties
    listen."""
    endpoints = {}
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    try:
        while len(endpoints) < 3:
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError("the party launcher exited before its parties listened")
            m = re.match(r"\[party (\d)\] listening on (.+):(\d+)", line)
            if m:
                endpoints[int(m.group(1))] = (m.group(2), int(m.group(3)))
    finally:
        timer.cancel()
    return endpoints


def test_run_parties_all_serves_a_tcp_mesh():
    """``python -m repro_torch.runtime.run_parties --party all`` on free
    ports: three party processes serve the coordinator, give the oracle's
    result, and the launcher exits 0 after shutdown."""
    tables, _ = generate_healthlnk(**DATA, device=CPU)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.runtime.run_parties", "--party", "all",
         "--base-port", "0", "--device", CPU],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    )
    try:
        endpoints = _endpoints_from(proc, timeout=60.0)
        coord = connect_tcp(endpoints, request_timeout=30.0)
        client = ReflexClient.networked(tables, coordinator=coord, key_seed=0, device=CPU)
        try:
            got = client.submit("tenant", JOIN_GOLDEN)
        finally:
            client.close()
        oracle = _fresh_oracle(tables)
        want = oracle.submit("tenant", JOIN_GOLDEN)
        oracle.close()
        assert_same_result(want, got)
        assert _tallies(want) == _tallies(got)
        assert proc.wait(timeout=30.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10.0)
        proc.stdout.close()
