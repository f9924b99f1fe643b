"""The port's batched admission (``repro_torch.service.QueryScheduler``)
against ``repro``'s, and against the port's own serial submits.

Tenants ``enqueue`` queries and ``drain`` runs each shape bucket as one
stacked ``Engine.execute_batch`` pass. For each scenario, the port's
batched results equal the reference's batched results slot by slot (rows,
output shares, per-node ledger, S and the pool's per-node attribution,
escalations, batch sizes), and the port's serial submits of the same
queries in the same order (rows, shares, ledger and S). The scenarios: a
fully stacked GroupBy, a join whose Resizes diverge and split the batch,
a projection, a mixed stream with a non-batchable aggregate that falls
back to a serial pass, and a window whose queued queries share one
signature's last observation. The port runs on the CPU; every comparison is exact.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import noise as jnoise  # noqa: E402
from repro.data import generate_healthlnk as jgenerate  # noqa: E402
from repro.service import AnalyticsService as JService  # noqa: E402
from repro.service import PrivacyAccountant as JAccountant  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.data import generate_healthlnk  # noqa: E402
from repro_torch.service import AnalyticsService, PrivacyAccountant, QueryScheduler  # noqa: E402

DATA = dict(n=8, seed=3, aspirin_frac=0.5, icd_heart_frac=0.4)
JOIN_SQL = (
    "SELECT DISTINCT d.pid FROM diagnoses d, medications m "
    "WHERE d.pid = m.pid AND d.icd9 = 390 AND m.med = 1"
)
GROUP_SQL = "SELECT major_icd9, COUNT(*) AS c FROM diagnoses GROUP BY major_icd9"
PROJECT_SQL = "SELECT pid, icd9 FROM diagnoses WHERE icd9 = 390"
COUNT_SQL = "SELECT COUNT(*) FROM medications WHERE med = 1"

# name -> (noise factory (module -> strategy), placement, queries); the
# shared-budget window first learns its signature's budget of two from one
# serial submit (a signature's first budget is learned at execution), so of
# the three queued queries one spends the last observation and two escalate
SCENARIOS = {
    "stacked": (lambda m: m.NoTrim(), "none", [GROUP_SQL] * 3),
    "resize_split": (lambda m: m.TruncatedLaplace(eps=0.5, sensitivity=4), "after_joins", [JOIN_SQL] * 3),
    "project": (lambda m: m.TruncatedLaplace(eps=0.5, sensitivity=4), "all_internal", [PROJECT_SQL] * 4),
    "mixed": (lambda m: m.TruncatedLaplace(eps=0.5, sensitivity=4), "after_joins",
              [JOIN_SQL, PROJECT_SQL, COUNT_SQL, JOIN_SQL, PROJECT_SQL]),
    "shared_budget": (lambda m: m.TruncatedLaplace(eps=3.0, delta=5e-5, sensitivity=1), "after_joins",
                      [JOIN_SQL] * 3),
}


def _service(port: bool, tables, name):
    noise, placement, _ = SCENARIOS[name]
    kw = dict(noise=noise(tnoise if port else jnoise), addition="sequential", placement=placement,
              batch_wait_s=60.0)
    if port:
        return AnalyticsService(tables, accountant=PrivacyAccountant(policy="escalate"), key=threefry.PRNGKey(9),
                                device="cpu", **kw)
    return JService(tables, accountant=JAccountant(policy="escalate"), key=jax.random.PRNGKey(9), **kw)


def _slot(res, with_offline=True):
    nodes = res.report.to_dict()["nodes"]
    strip = (lambda e: e) if with_offline else (lambda e: {k: v for k, v in e.items() if k != "offline"})
    return {
        "tenant": res.tenant,
        "rows": {k: np.asarray(v).tolist() for k, v in res.rows.items()},
        "shares": {c: np.asarray(res.table.col(c).shares).view(np.uint32).tolist() for c in res.table.cols},
        "valid": np.asarray(res.table.valid.shares).view(np.uint32).tolist(),
        "ledger": [(n["node"], n["n_ins"], n["n_out"], n["bytes_per_party"], n["rounds"], strip(n["extra"]))
                   for n in nodes],
        "escalations": res.escalations,
    }


@pytest.fixture(scope="module", params=list(SCENARIOS))
def runs(request):
    name = request.param
    queries = SCENARIOS[name][2]
    jtables, _ = jgenerate(**DATA)
    ttables, _ = generate_healthlnk(device="cpu", **DATA)
    out = {}
    for label, port, tables in (("ref", False, jtables), ("port", True, ttables)):
        svc = _service(port, tables, name)
        if name == "shared_budget":
            svc.submit("warm", queries[0])
        tickets = [svc.enqueue(f"t{i}", sql) for i, sql in enumerate(queries)]
        results = svc.drain()
        out[label] = dict(svc=svc, tickets=tickets, results=results)
    serial = _service(True, ttables, name)
    if name == "shared_budget":
        serial.submit("warm", queries[0])
    out["serial"] = dict(svc=serial, results=[serial.submit(f"t{i}", sql) for i, sql in enumerate(queries)])
    return name, out


def test_batched_slots_equal_the_reference_batch(runs):
    _, out = runs
    port, ref = out["port"], out["ref"]
    assert [(t.id, t.tenant, t.batched) for t in port["tickets"]] == \
        [(t.id, t.tenant, t.batched) for t in ref["tickets"]]
    assert [r.batch_slots for r in port["results"]] == [r.batch_slots for r in ref["results"]]
    assert [_slot(r) for r in port["results"]] == [_slot(r) for r in ref["results"]]


def test_batched_slots_equal_the_ports_serial_submits(runs):
    """Pool temperature varies with grouping (the per-node hit/miss split),
    the material itself does not: everything else is bit for bit.

    In the shared-budget window only the first slot is compared: the
    reference buckets and stacks plans by ``plan.pretty()``, which names a
    Resize's noise strategy but not its parameters, so the two slots the
    accountant escalated to TLap(eps=1.5) stack with the first and run its
    TLap(eps=3) Resize; a serial submit runs the escalated one. The port
    keeps the reference's behavior (the slots equal the reference's batch,
    above); ROADMAP.md, Queue 3, logs it."""
    name, out = runs
    batched = [_slot(r, with_offline=False) for r in out["port"]["results"]]
    serial = [_slot(r, with_offline=False) for r in out["serial"]["results"]]
    if name == "shared_budget":
        assert batched[0] == serial[0]
        executed = [[n.cfg.noise.eps for n in _resizes(r.plan)] for r in out["port"]["results"]]
        assert executed == [[3.0], [1.5], [1.5]]  # admitted; the stacked pass ran slot 0's Resize
        return
    assert batched == serial
    assert out["port"]["svc"].engine._resize_ctr == out["serial"]["svc"].engine._resize_ctr


def _resizes(plan):
    for c in plan.children():
        yield from _resizes(c)
    if plan.label == "Resize":
        yield plan


def test_batch_stats_and_scheduler_counters_equal_the_reference(runs):
    name, out = runs
    port, ref = out["port"]["svc"], out["ref"]["svc"]
    assert port.engine.last_batch_stats == ref.engine.last_batch_stats
    assert port.scheduler.stats == ref.scheduler.stats
    assert port.stats == ref.stats and port.cache_stats() == ref.cache_stats()
    assert port.pool.stats() == ref.pool.stats()
    assert port.scheduler.n_pending == 0 and not port.scheduler._planned
    if name == "stacked":
        assert port.engine.last_batch_stats["split_nodes"] == 0
        assert port.engine.last_batch_stats["stacked_nodes"] >= 1
    if name == "mixed":
        assert [t.batched for t in out["port"]["tickets"]] == [True, True, False, True, True]


def test_accountant_charges_each_slot_as_the_reference(runs):
    name, out = runs
    port, ref, serial = out["port"]["svc"], out["ref"]["svc"], out["serial"]["svc"]
    assert port.accountant.status() == ref.accountant.status() == serial.accountant.status()
    assert port.accountant.escalation_count == ref.accountant.escalation_count
    if name == "shared_budget":
        # one observation left: the first queued slot spends it, the others escalate
        assert [len(r.escalations) for r in out["port"]["results"]] == [0, 1, 1]
        assert [len(r.escalations) for r in out["serial"]["results"]] == [0, 1, 1]


def test_scheduler_standalone_over_the_port_service():
    """A QueryScheduler built directly over a service (its own window and
    batch size) gives the service's own batched results."""
    tables, _ = generate_healthlnk(device="cpu", **DATA)
    svc = _service(True, tables, "project")
    sched = QueryScheduler(svc, max_batch=2)
    tickets = [sched.submit(f"t{i}", PROJECT_SQL) for i in range(4)]
    assert sched.n_pending == 0  # two full buckets flushed on submit
    results = sched.drain()
    assert [r.batch_slots for r in results] == [2, 2, 2, 2]
    assert sched.stats["full_flushes"] == 2 and [t.id for t in tickets] == [0, 1, 2, 3]
    ref = _service(True, tables, "project")
    serial = [ref.submit(f"t{i}", PROJECT_SQL) for i in range(4)]
    assert [_slot(r, False) for r in results] == [_slot(r, False) for r in serial]
