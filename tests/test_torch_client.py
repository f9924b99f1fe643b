"""The port's ReflexClient facade (``repro_torch.runtime.client``): the
reference's client cases on the port — an identical verb surface and
identical behaviour (results, EXPLAIN output, typed errors) over the
in-process oracle and the networked 3-party loopback mesh, on the CPU."""
import numpy as np
import pytest

from repro_torch.core import threefry
from repro_torch.core.noise import ConstantNoise
from repro_torch.data import QUERY_SQL, generate_healthlnk
from repro_torch.errors import BudgetRefused, PlanSchemaError
from repro_torch.runtime import ReflexClient, launch_loopback_mesh
from repro_torch.service import AnalyticsService, PrivacyAccountant
from repro_torch.sql.lexer import SqlError

GROUPBY = QUERY_SQL["med_dosage_sum"]
DOSAGE = QUERY_SQL["dosage_study"]
CPU = "cpu"
TIMEOUT = 30.0  # a bound no passing case reaches

VERBS = ("submit", "enqueue", "drain", "explain", "explain_analyze",
         "status", "session", "cache_stats", "close")


@pytest.fixture(scope="module")
def data():
    return generate_healthlnk(n=16, seed=3, aspirin_frac=0.5, icd_heart_frac=0.4, device=CPU)


def _networked(tables, **kw):
    coord, _servers, _threads = launch_loopback_mesh(
        device=CPU, exchange_timeout=TIMEOUT, request_timeout=TIMEOUT
    )
    return ReflexClient.networked(tables, coordinator=coord, device=CPU, **kw)


def make_clients(tables, **kw):
    return (
        ReflexClient.in_process(tables, key=threefry.PRNGKey(0), offline="off", device=CPU, **kw),
        _networked(tables, key_seed=0, **kw),
    )


def test_verb_surface_is_identical(data):
    tables, _ = data
    local, net = make_clients(tables)
    try:
        for verb in VERBS:
            assert callable(getattr(local, verb))
            assert callable(getattr(net, verb))
        assert local.mode == "in_process" and net.mode == "networked"
    finally:
        net.close()
        local.close()


def test_submit_and_session_agree_across_modes(data):
    tables, _ = data
    local, net = make_clients(tables)
    try:
        a = local.session("alice").submit(GROUPBY)
        b = net.session("alice").submit(GROUPBY)
        assert a.rows.keys() == b.rows.keys()
        for k in a.rows:
            np.testing.assert_array_equal(a.rows[k], b.rows[k])
        assert a.tenant == b.tenant == "alice"
    finally:
        net.close()
        local.close()


def test_explain_is_identical_across_modes(data):
    tables, _ = data
    local, net = make_clients(tables)
    try:
        # EXPLAIN never executes: the rendered plan and estimates are
        # byte-identical whatever the topology
        assert local.explain(DOSAGE) == net.explain(DOSAGE)
    finally:
        net.close()
        local.close()


def test_status_carries_runtime_section(data):
    tables, _ = data
    local, net = make_clients(tables)
    try:
        assert local.status()["runtime"] == {"mode": "in_process"}
        net.submit("t", GROUPBY)
        st = net.status()["runtime"]
        assert st["mode"] == "networked"
        assert len(st["wire_audit"]) == 3
    finally:
        net.close()
        local.close()


def test_bad_sql_raises_same_type_in_both_modes(data):
    tables, _ = data
    local, net = make_clients(tables)
    try:
        for client in (local, net):
            with pytest.raises(SqlError):
                client.submit("t", "SELECT nonexistent FROM diagnoses")
    finally:
        net.close()
        local.close()


def test_plan_schema_error_is_typed_in_both_modes(data):
    """A plan that sneaks past SQL compilation but references a column the
    schema cannot provide fails as PlanSchemaError in either topology (the
    coordinator validates before shipping anything to the mesh)."""
    from repro_torch.ops import Predicate
    from repro_torch.plan.nodes import Filter, Scan

    tables, _ = data
    local, net = make_clients(tables)
    bad = Filter(Scan("diagnoses"), [Predicate("no_such_col", "eq", 1)])
    try:
        for client in (local, net):
            with pytest.raises(PlanSchemaError):
                client.service.engine.execute(bad)
    finally:
        net.close()
        local.close()


def test_budget_refusal_is_typed_in_both_modes(data):
    tables, _ = data
    kw = dict(noise=ConstantNoise(0.2), addition="sequential", placement="after_joins")
    local = ReflexClient.in_process(
        tables, key=threefry.PRNGKey(0), offline="off", device=CPU,
        accountant=PrivacyAccountant(policy="refuse"), **kw,
    )
    net = _networked(tables, key_seed=0, accountant=PrivacyAccountant(policy="refuse"), **kw)
    try:
        for client in (local, net):
            client.submit("alice", DOSAGE)
            with pytest.raises(BudgetRefused) as ei:
                client.submit("mallory", DOSAGE)
            assert "CRT budget exhausted" in str(ei.value)
    finally:
        net.close()
        local.close()


def test_client_context_manager_closes(data):
    tables, _ = data
    with ReflexClient.networked(tables, key_seed=0, device=CPU) as client:
        client.submit("t", GROUPBY)
    assert not any(t.is_alive() for t in client.coordinator.party_threads)
    # the mesh is down: further queries fail fast rather than hanging
    with pytest.raises(Exception):
        client.submit("t", GROUPBY)


def test_in_process_wraps_plain_service(data):
    tables, _ = data
    svc = AnalyticsService(tables, key=threefry.PRNGKey(0), offline="off", device=CPU)
    client = ReflexClient(svc)
    assert client.mode == "in_process" and client.service is svc
    res = client.submit("t", GROUPBY)
    assert res.rows
    client.close()
