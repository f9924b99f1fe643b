"""The port's multi-tenant service (``repro_torch.service``) against
``repro.service``.

The same SQL sequence from several tenants goes through both packages'
``AnalyticsService`` over the same tables and key, under three
configurations: the service's defaults (Shrinkwrap's TLap noise, parallel
addition, cost-based placement, the escalating accountant, the offline
pool, durable state), and TLap(eps=3) noise, whose budget of two
observations runs out within the sequence, under the escalating and under
the refusing accountant. Every submission gives
the same rows, per-node ledger and S, plan, cache outcome and escalations,
or the same refusal; afterwards the accountant, the plan cache, the pool
and ``stats`` agree, and ``render_metrics`` equals the reference's but for
the jit-cache gauge the port leaves out. A state directory written by
``repro``'s service is read by the port's with the same refusals. The port
runs on the CPU; every comparison is exact.
"""
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import noise as jnoise  # noqa: E402
from repro.data import generate_healthlnk as jgenerate  # noqa: E402
from repro.service import AnalyticsService as JService  # noqa: E402
from repro.service import PrivacyAccountant as JAccountant  # noqa: E402
from repro.service import QueryRefused as JRefused  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.data import QUERY_SQL, generate_healthlnk, plaintext_oracle, revealed_answer  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.errors import BudgetRefused, ReflexError  # noqa: E402
from repro_torch.service import AnalyticsService, PrivacyAccountant, QueryRefused  # noqa: E402

DATA = dict(n=16, seed=3, aspirin_frac=0.5, icd_heart_frac=0.4)
DOSAGE = QUERY_SQL["dosage_study"]
COUNT_325 = "SELECT COUNT(*) FROM medications WHERE dosage = 325"

SEQUENCES = {
    "defaults": [
        ("alice", DOSAGE),
        ("bob", QUERY_SQL["aspirin_count"]),
        ("carol", QUERY_SQL["comorbidity"]),
        ("alice", DOSAGE.replace("390", "414")),  # a plan-cache rebind
        ("bob", DOSAGE),  # a plan-cache hit, the same plan object
        ("dave", COUNT_325),
        ("dave", COUNT_325.replace("325", "81")),
        ("eve", "SELECT AVG(dosage) AS d FROM medications WHERE med = 1"),
    ],
    "escalate": [("mallory", DOSAGE)] * 7 + [("trent", QUERY_SQL["aspirin_count"])],
    "refuse": [("mallory", DOSAGE)] * 6 + [("trent", QUERY_SQL["aspirin_count"])] * 2,
}


def _config(name, port: bool):
    noise = tnoise if port else jnoise
    acct = PrivacyAccountant if port else JAccountant
    if name == "defaults":
        return {}
    tlap = noise.TruncatedLaplace(eps=3.0, delta=5e-5, sensitivity=1)  # a budget of 2
    return dict(noise=tlap, addition="sequential", placement="after_joins",
                accountant=acct(policy="escalate" if name == "escalate" else "refuse"))


def _summary(res):
    return {
        "tenant": res.tenant,
        "rows": {k: np.asarray(v).tolist() for k, v in res.rows.items()},
        "ledger": [(s.node, s.n_ins, s.n_out, s.rounds, s.bytes_per_party, s.extra.get("s"),
                    s.extra.get("skipped"), s.extra.get("offline")) for s in res.report.nodes],
        "plan": res.plan.pretty(),
        "cache_hit": res.cache_hit,
        "escalations": res.escalations,
        "batch_slots": res.batch_slots,
    }


def _drive(svc, tenant, sql, refused):
    """(summary, result): the result is None for a refused query."""
    try:
        res = svc.session(tenant).submit(sql)
    except refused as e:
        return {"refused": (e.signature, e.observed, e.budget)}, None
    return _summary(res), res


@pytest.fixture(scope="module", params=list(SEQUENCES))
def runs(request, tmp_path_factory):
    """Both services through one sequence, with durable state and the pool
    on; the provisioner refills after the first submit (an idle window)."""
    name = request.param
    jtables, _ = jgenerate(**DATA)
    ttables, plain = generate_healthlnk(device="cpu", **DATA)
    jsvc = JService(jtables, key=jax.random.PRNGKey(9), state_dir=str(tmp_path_factory.mktemp("ref")),
                    **_config(name, port=False))
    tsvc = AnalyticsService(ttables, key=threefry.PRNGKey(9), state_dir=str(tmp_path_factory.mktemp("port")),
                            device="cpu", **_config(name, port=True))
    got, want, results = [], [], []
    for i, (tenant, sql) in enumerate(SEQUENCES[name]):
        want.append(_drive(jsvc, tenant, sql, JRefused)[0])
        summary, res = _drive(tsvc, tenant, sql, BudgetRefused)
        got.append(summary)
        results.append(res)
        if i == 0:
            jsvc.drain()
            tsvc.drain()
    return name, tsvc, jsvc, got, want, (plain, results)


@pytest.mark.parametrize("step", range(8))
def test_each_submission_equals_the_reference(runs, step):
    _, _, _, got, want, _ = runs
    assert len(got) == len(want) == 8
    assert got[step] == want[step]


def test_answers_equal_the_oracle(runs):
    name, _, _, _, _, (plain, results) = runs
    checked = 0
    for (_, sql), res in zip(SEQUENCES[name], results):
        for query in ("dosage_study", "aspirin_count", "comorbidity"):
            if res is not None and sql == QUERY_SQL[query]:
                assert revealed_answer(query, res.plan, res.table) == plaintext_oracle(query, plain)
                checked += 1
    assert checked


def test_accountant_state_equals_the_reference(runs):
    name, tsvc, jsvc, got, _, _ = runs
    assert tsvc.accountant.status() == jsvc.accountant.status()
    assert tsvc.accountant.escalation_count == jsvc.accountant.escalation_count
    assert tsvc.accountant.refusal_count == jsvc.accountant.refusal_count
    assert tsvc.accountant.budget_metrics() == jsvc.accountant.budget_metrics()
    if name == "escalate":
        assert tsvc.accountant.escalation_count > 0
    if name == "refuse":
        assert any("refused" in r for r in got)


def test_stats_cache_and_pool_equal_the_reference(runs):
    _, tsvc, jsvc, _, _, _ = runs
    assert tsvc.stats == jsvc.stats
    assert tsvc.cache_stats() == jsvc.cache_stats()
    assert tsvc.pool.stats() == jsvc.pool.stats()
    assert tsvc.scheduler.stats == jsvc.scheduler.stats
    assert tsvc.calibration.status()["entries"] == jsvc.calibration.status()["entries"]
    assert tsvc.calibration._stats == jsvc.calibration._stats


def _status_view(st):
    st = dict(st)
    st.pop("jit_cache", None)
    prov = dict(st["offline"].pop("provisioner"))
    prov.pop("last_refill_seconds")
    st["offline"]["provisioner"] = prov
    for journal in ("ledger", "calibration"):
        store = st["state"][journal] if journal == "ledger" else st["state"][journal]["store"]
        for k in ("directory", "session"):
            store.pop(k)
    st["state"].pop("dir")
    return st


def test_status_equals_the_reference_without_the_jit_cache(runs):
    _, tsvc, jsvc, _, _, _ = runs
    port, ref = tsvc.status(), jsvc.status()
    assert "jit_cache" not in port and "jit_cache" in ref
    assert _status_view(port) == _status_view(ref)


def _metric_lines(text):
    """Prometheus lines without timing values: a latency histogram keeps its
    observation count; the jit-cache gauge (the port has none) is dropped."""
    keep = []
    for line in text.splitlines():
        if "reflex_jit_cache_logical" in line:
            continue
        m = re.match(r"(\w+?)(_bucket|_sum|_count)?(\{.*\})? ", line)
        if m and m.group(1).endswith("_seconds") and m.group(2) in ("_bucket", "_sum"):
            continue
        keep.append(line)
    return keep


def test_render_metrics_equals_the_reference_but_the_jit_gauge(runs):
    _, tsvc, jsvc, _, _, _ = runs
    port, ref = tsvc.render_metrics(), jsvc.render_metrics()
    assert "reflex_jit_cache_logical" not in port and "reflex_jit_cache_logical" in ref
    assert _metric_lines(port) == _metric_lines(ref)
    assert set(tsvc.metrics_snapshot()) <= set(jsvc.metrics_snapshot())


# -----------------------------------------------------------------------------
# Durable state across the packages
# -----------------------------------------------------------------------------

def test_port_reads_a_reference_state_dir_with_the_same_refusals(tmp_path):
    """repro's service spends a ConstantNoise signature's budget (one
    observation) and is refused; the port's service over the same state
    directory refuses the same query with the same fields, admits a fresh
    signature, and its accountant equals a restarted reference's."""
    jtables, _ = jgenerate(**DATA)
    ttables, plain = generate_healthlnk(device="cpu", **DATA)

    def kw(port):
        noise = (tnoise if port else jnoise).ConstantNoise(0.2)
        acct = (PrivacyAccountant if port else JAccountant)(policy="refuse")
        return dict(noise=noise, addition="sequential", placement="after_joins", accountant=acct,
                    state_dir=str(tmp_path))

    jsvc = JService(jtables, key=jax.random.PRNGKey(9), **kw(False))
    jsvc.session("alice").submit(DOSAGE)
    with pytest.raises(JRefused) as jerr:
        jsvc.session("mallory").submit(DOSAGE)
    tsvc = AnalyticsService(ttables, key=threefry.PRNGKey(11), device="cpu", **kw(True))
    with pytest.raises(QueryRefused) as err:
        tsvc.session("mallory").submit(DOSAGE)
    assert (err.value.signature, err.value.observed, err.value.budget) == \
        (jerr.value.signature, jerr.value.observed, jerr.value.budget)
    assert isinstance(err.value, (BudgetRefused, ReflexError, RuntimeError))
    res = tsvc.session("trent").submit(QUERY_SQL["aspirin_count"])
    assert revealed_answer("aspirin_count", res.plan, res.table) == plaintext_oracle("aspirin_count", plain)
    jfresh = JService(jtables, key=jax.random.PRNGKey(12), **kw(False))
    assert tsvc.accountant.status() == jfresh.accountant.status()
    with pytest.raises(JRefused):
        jfresh.session("trent").submit(QUERY_SQL["aspirin_count"])


# -----------------------------------------------------------------------------
# The service's surface on the port
# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    return generate_healthlnk(device="cpu", **DATA)


def test_service_runs_exactly_the_engines_plan(data):
    """A submit's output shares equal Engine.execute of the admitted plan on
    a fresh engine with the same key: the service adds no work of its own."""
    tables, _ = data
    svc = AnalyticsService(tables, key=threefry.PRNGKey(9), device="cpu", offline="off")
    res = svc.session("a").submit(DOSAGE)
    out, report = Engine(tables, key=threefry.PRNGKey(9), device="cpu").execute(res.plan)
    assert [(s.node, s.rounds, s.bytes_per_party) for s in report.nodes] == \
        [(s.node, s.rounds, s.bytes_per_party) for s in res.report.nodes]
    for name in out.cols:
        assert np.array_equal(out.col(name).shares.numpy(), res.table.col(name).shares.numpy())


def test_service_defaults_to_cuda(data):
    import torch

    tables, _ = data
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        AnalyticsService(tables)


def test_jit_ops_raises_as_the_engine_does(data):
    tables, _ = data
    with pytest.raises(NotImplementedError, match="CUDA graphs"):
        AnalyticsService(tables, jit_ops=True, device="cpu")


def test_plan_cache_hits_rebinds_and_shares_plan_objects(data):
    tables, plain = data
    svc = AnalyticsService(tables, noise=tnoise.NoTrim(), addition="sequential", placement="after_joins",
                           key=threefry.PRNGKey(9), device="cpu", offline="off")
    s = svc.session("alice")
    r1, r2, r3 = s.submit(COUNT_325), s.submit(COUNT_325.replace("325", "81")), s.submit(COUNT_325)
    assert not r1.cache_hit and r2.cache_hit and r3.cache_hit
    assert svc.stats["plan_cache_rebinds"] == 1 and r3.plan is r1.plan
    m = plain["medications"]
    assert int(r1.rows["cnt"][0]) == int((m["dosage"] == 325).sum())
    assert int(r2.rows["cnt"][0]) == int((m["dosage"] == 81).sum())


def test_refusal_is_typed_and_cross_tenant(data):
    tables, _ = data
    svc = AnalyticsService(tables, noise=tnoise.ConstantNoise(0.2), addition="sequential",
                           placement="after_joins", accountant=PrivacyAccountant(policy="refuse"),
                           key=threefry.PRNGKey(9), device="cpu", offline="off")
    svc.session("alice").submit(DOSAGE)
    with pytest.raises(BudgetRefused) as e:
        svc.session("mallory").submit(DOSAGE)
    assert "CRT budget exhausted" in str(e.value) and isinstance(e.value, RuntimeError)
    assert e.value.observed == e.value.budget == 1
    assert svc.accountant.status()[0]["remaining"] == 0 and svc.stats["refusals"] == 1


def test_explain_renders_the_placed_plan(data):
    tables, _ = data
    svc = AnalyticsService(tables, key=threefry.PRNGKey(9), device="cpu", offline="off")
    text = svc.explain(DOSAGE)
    assert text.splitlines()[0].startswith("EXPLAIN") and "Join" in text
    text, res = svc.explain_analyze("a", DOSAGE)
    assert "EXPLAIN ANALYZE" in text and res.rows is not None


# -----------------------------------------------------------------------------
# The config fallback the service's config=None goes through
# -----------------------------------------------------------------------------

ENVS = [
    {},
    {"REPRO_FUSE_CIRCUITS": "0"},
    {"REPRO_JOIN_TILE": "64", "REPRO_JOIN_ALGO": "sortmerge"},
    {"REPRO_USE_PALLAS": "1", "REPRO_JOIN_ALGO": "product"},
]


@pytest.mark.parametrize("env", ENVS)
def test_config_from_env_equals_the_reference(env):
    from repro.config import RuntimeConfig as JConfig
    from repro_torch.config import RuntimeConfig

    got, want = RuntimeConfig.from_env(env), JConfig.from_env(env)
    assert {k: v for k, v in want.to_dict().items() if k != "use_pallas"} == got.to_dict()
    assert RuntimeConfig.from_dict(want.to_dict()) == got
    assert RuntimeConfig.from_dict(got.to_dict()) == got


def test_config_rejects_what_the_reference_rejects():
    from repro_torch.config import RuntimeConfig

    for env in ({"REPRO_JOIN_TILE": "x"}, {"REPRO_JOIN_TILE": "0"}, {"REPRO_JOIN_ALGO": "hash"}):
        with pytest.raises(ValueError):
            RuntimeConfig.from_env(env)


def test_current_config_follows_the_environment_and_use_config(monkeypatch):
    from repro_torch.config import RuntimeConfig, current_config, use_config
    from repro_torch.kernels import fusion_enabled, override_fusion

    monkeypatch.setenv("REPRO_FUSE_CIRCUITS", "0")
    assert current_config().fuse_circuits is False and not fusion_enabled()
    with use_config(RuntimeConfig(fuse_circuits=True)):
        assert fusion_enabled()
        with override_fusion(False):  # a block override beats the config
            assert not fusion_enabled()
    with use_config(None):
        assert not fusion_enabled()
    monkeypatch.setenv("REPRO_FUSE_CIRCUITS", "1")
    assert current_config().fuse_circuits and fusion_enabled()


def test_service_without_config_reads_the_environment(data, monkeypatch):
    """config=None: the planner's join selection follows REPRO_JOIN_ALGO, as
    the reference's does; an explicit config wins."""
    from repro_torch.config import RuntimeConfig
    from repro_torch.plan.nodes import JoinSortMerge
    from repro_torch.sql import Catalog

    tables, plain = data
    mult = {t: {"pid": int(np.bincount(cols["pid"]).max())} for t, cols in plain.items()}
    catalog = Catalog.from_tables(tables, multiplicity=mult)

    def joins(svc):
        plan, _, _ = svc.compile(DOSAGE)
        found = []

        def walk(node):
            for c in node.children():
                walk(c)
            if node.label.startswith("Join"):
                found.append(type(node) is JoinSortMerge)

        walk(plan)
        return found

    kw = dict(catalog=catalog, key=threefry.PRNGKey(9), device="cpu", offline="off")
    monkeypatch.setenv("REPRO_JOIN_ALGO", "sortmerge")
    assert joins(AnalyticsService(tables, **kw)) == [True]
    assert joins(AnalyticsService(tables, config=RuntimeConfig(join_algo="product"), **kw)) == [False]
    monkeypatch.setenv("REPRO_JOIN_ALGO", "product")
    assert joins(AnalyticsService(tables, **kw)) == [False]
