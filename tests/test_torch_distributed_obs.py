"""Distributed observability over the port's networked runtime, on the CPU:
the networked cases of the reference's distributed-obs tests. Tracing a
networked query changes nothing about its execution (bit-identical shares
and per-node ledger tallies vs an untraced run); the merged trace spans the
three parties under one id and passes the disclosure audit; EXPLAIN ANALYZE
attributes network stall per node and per party; ``status()`` reports mesh
health and publishes ``reflex_wire_*`` metrics without double counting; a
capped exchange log keeps the wire audit exact."""
import json

import numpy as np
import pytest

from repro_torch.core import threefry
from repro_torch.core.noise import NoTrim
from repro_torch.data import generate_healthlnk
from repro_torch.obs import Tracer, redact
from repro_torch.runtime import ReflexClient, launch_loopback_mesh

GROUP_SQL = "SELECT major_icd9, COUNT(*) AS c FROM diagnoses GROUP BY major_icd9"
CPU = "cpu"
TIMEOUT = 30.0  # a bound no passing case reaches


@pytest.fixture(scope="module")
def tables():
    t, _ = generate_healthlnk(n=16, seed=3, aspirin_frac=0.5, device=CPU)
    return t


def _networked(tables):
    coord, _servers, _threads = launch_loopback_mesh(
        device=CPU, exchange_timeout=TIMEOUT, request_timeout=TIMEOUT
    )
    return ReflexClient.networked(
        tables, coordinator=coord, key_seed=2, noise=NoTrim(), placement="none", device=CPU
    )


@pytest.fixture(scope="module")
def mesh_clients(tables):
    """Two identically seeded loopback meshes: one driven untraced, one
    always driven under a Tracer — their executions must stay bit-exact."""
    plain, traced = _networked(tables), _networked(tables)
    yield plain, traced
    plain.close()
    traced.close()


def _tallies(res):
    return [(s.node, s.n_ins, s.n_out, s.bytes_per_party, s.rounds) for s in res.report.nodes]


def test_traced_networked_run_bit_identical_to_untraced(mesh_clients):
    plain, traced = mesh_clients
    want = plain.submit("alice", GROUP_SQL)
    with Tracer():
        got = traced.submit("alice", GROUP_SQL)
    assert _tallies(want) == _tallies(got)
    assert set(want.rows) == set(got.rows)
    for k in want.rows:
        assert np.array_equal(want.rows[k], got.rows[k])
    for k in want.table.cols:
        assert np.array_equal(want.table.col(k).shares.numpy(), got.table.col(k).shares.numpy())


def test_merged_trace_spans_three_parties_under_one_id(mesh_clients):
    _plain, traced = mesh_clients
    with Tracer() as tr:
        traced.submit("alice", GROUP_SQL)
    lines = [json.loads(ln) for ln in tr.to_jsonl().splitlines()]
    assert {s["trace_id"] for s in lines} == {tr.trace_id}
    parties = {s["attrs"]["party"] for s in lines if "party" in s["attrs"]}
    assert parties == {0, 1, 2}
    ids = {s["span_id"]: s for s in lines}
    assert len(ids) == len(lines)  # renumbering left no collisions
    execute = next(s for s in lines if s["name"] == "execute")
    assert execute["attrs"]["merged"] > 0
    for s in lines:
        if s["parent_id"] is not None:
            assert s["parent_id"] in ids
        if "party" in s["attrs"]:
            hop = s
            while hop["parent_id"] is not None:
                hop = ids[hop["parent_id"]]
            assert hop["parent_id"] is None


def test_party_shipped_spans_survive_disclosure_audit(mesh_clients):
    _plain, traced = mesh_clients
    with Tracer() as tr:
        traced.submit("alice", GROUP_SQL)
    party_spans = [s for s in tr.spans if "party" in s.attrs]
    assert party_spans
    for s in party_spans:
        redact.assert_emittable(s.attrs, where=f"merged span {s.name}")


def test_networked_explain_analyze_net_attribution(mesh_clients):
    plain, _traced = mesh_clients
    text, _res = plain.explain_analyze("alice", GROUP_SQL)
    lines = text.splitlines()
    assert "net stall" in lines[1]
    trailer = lines[-1]
    assert trailer.startswith("wire:")
    for p in range(3):
        assert f"p{p}:" in trailer and "stall" in trailer


def test_in_process_explain_analyze_has_no_wire_trailer(tables):
    client = ReflexClient.in_process(
        tables, noise=NoTrim(), placement="none", key=threefry.PRNGKey(2), device=CPU
    )
    text, res = client.explain_analyze("alice", GROUP_SQL)
    assert "net stall" in text.splitlines()[1]
    assert "wire:" not in text
    assert len(text.splitlines()) == len(res.report.nodes) + 3
    client.close()


def test_status_reports_mesh_health_and_publishes_wire_metrics(mesh_clients):
    plain, _traced = mesh_clients
    plain.submit("alice", GROUP_SQL)
    mesh = plain.status()["runtime"]["mesh"]
    assert mesh["ok"] is True
    assert [p["party"] for p in mesh["parties"]] == [0, 1, 2]
    for p in mesh["parties"]:
        assert p["up"] and p["queries"] >= 1
        assert p["bytes"]["sent"] > 0 and p["links"]
    wire = plain.service.metrics.snapshot()["reflex_wire_bytes_total"]
    assert wire["kind"] == "counter"
    assert {"0", "1", "2"} <= {s["labels"].get("party") for s in wire["samples"]}
    assert all(s["value"] > 0 for s in wire["samples"])


def test_in_process_status_has_no_mesh_section(tables):
    client = ReflexClient.in_process(tables, key=threefry.PRNGKey(2), device=CPU)
    assert "mesh" not in client.status()["runtime"]
    client.close()


def test_repeated_status_pulls_do_not_double_count(mesh_clients):
    plain, _traced = mesh_clients
    plain.submit("alice", GROUP_SQL)
    plain.status()

    def data_bytes():
        snap = plain.service.metrics.snapshot()
        return sum(s["value"] for s in snap["reflex_wire_bytes_total"]["samples"]
                   if s["labels"].get("kind") == "data")

    first = data_bytes()
    plain.status()  # no queries in between: only ctrl traffic moves
    assert data_bytes() == first


def test_exchange_log_cap_keeps_audit_exact(mesh_clients):
    plain, _traced = mesh_clients
    old = plain.coordinator.exchange_log_cap
    try:
        plain.coordinator.exchange_log_cap = 1  # force the summary path
        res = plain.submit("alice", GROUP_SQL)
        audit = plain.service.engine.last_wire_audit
        assert [a["party"] for a in audit] == [0, 1, 2]
        total = sum(s.bytes_per_party for s in res.report.nodes)
        for a in audit:
            assert a["exchanges"] > 1
            assert a["ledger_bytes"] == a["exchange_bytes"] == a["wire_bytes"] == total
            assert a["stall_seconds"] >= 0.0
    finally:
        plain.coordinator.exchange_log_cap = old
