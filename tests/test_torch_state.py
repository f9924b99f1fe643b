"""The port's durable service state (``repro_torch.state``) against
``repro.state``: the reference's own checks (tests/test_state.py) run on
the port (WAL, lease and fencing, journal tail-sync and compaction, the
accountant's intent -> record protocol across restarts and replicas, the
calibration store), then the two packages read each other's journals and
agree on keys and budgets. The engine runs on the CPU (``device="cpu"``);
every comparison is exact.
"""
import json
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import state as jstate  # noqa: E402
from repro.core import noise as jnoise  # noqa: E402
from repro.ops.filter import Predicate as JPredicate  # noqa: E402
from repro.plan import nodes as jnodes  # noqa: E402
from repro.service import PrivacyAccountant as JAccountant  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.noise import ConstantNoise, RevealNoise, TruncatedLaplace  # noqa: E402
from repro_torch.core.resizer import ResizerConfig  # noqa: E402
from repro_torch.data import generate_healthlnk as _generate  # noqa: E402
from repro_torch.data.queries import QUERY_SQL  # noqa: E402
from repro_torch.engine.executor import ExecutionReport, NodeStats  # noqa: E402
from repro_torch.errors import LeaseFenced  # noqa: E402
from repro_torch.ops.filter import Predicate  # noqa: E402
from repro_torch.plan.nodes import Filter, Resize, Scan  # noqa: E402
from repro_torch.service import AnalyticsService, PrivacyAccountant, QueryRefused  # noqa: E402
from repro_torch.state import (  # noqa: E402
    CalibrationStore,
    FileLease,
    JournalStore,
    StaleLeaseError,
    WriteAheadLog,
    calibration_key,
)


def generate_healthlnk(**kw):
    return _generate(device="cpu", **kw)


DOSAGE = QUERY_SQL["dosage_study"]


# -----------------------------------------------------------------------------
# WAL: append / incremental read / torn-tail tolerance
# -----------------------------------------------------------------------------

def test_wal_append_and_incremental_read(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "w.jsonl"))
    off1 = wal.append({"a": 1})
    recs, off = wal.read_from(0)
    assert recs == [{"a": 1}] and off == off1
    wal.append({"b": 2})
    recs, _ = wal.read_from(off1)  # incremental: only the tail
    assert recs == [{"b": 2}]


@pytest.mark.parametrize("cut", ["mid_json", "no_newline"])
def test_wal_torn_tail_is_ignored_and_healed(tmp_path, cut):
    path = str(tmp_path / "w.jsonl")
    wal = WriteAheadLog(path)
    good = wal.append({"a": 1})
    # simulate a crashed writer: a torn final line
    with open(path, "ab") as f:
        f.write(b'{"b": 2' if cut == "mid_json" else b'{"b": 2}')
    recs, off = wal.read_from(0)
    assert recs == [{"a": 1}] and off == good  # torn bytes excluded
    # the next append under the lease heals the tail instead of corrupting it
    wal.append({"c": 3}, good_offset=good)
    recs, _ = wal.read_from(0)
    assert recs == [{"a": 1}, {"c": 3}]


# -----------------------------------------------------------------------------
# Lease: fencing tokens, reentrancy, stale-writer rejection
# -----------------------------------------------------------------------------

def test_lease_tokens_are_monotonic_across_holders(tmp_path):
    a, b = FileLease(str(tmp_path)), FileLease(str(tmp_path))
    with a.hold() as t1:
        pass
    with b.hold() as t2:
        pass
    with a.hold() as t3:
        pass
    assert t1 < t2 < t3


def test_lease_is_reentrant(tmp_path):
    lease = FileLease(str(tmp_path))
    with lease.hold() as t1:
        with lease.hold() as t2:  # same hold, same token
            assert t2 == t1
        assert lease.held
    assert not lease.held


def test_store_rejects_stale_fencing_token(tmp_path):
    store = JournalStore(str(tmp_path), "x")
    with store.transaction() as sync:
        sync.append({"type": "obs", "v": 1})
        with pytest.raises(StaleLeaseError):
            store._append({"type": "obs", "v": 2}, sync.token - 1)


def test_store_append_requires_transaction(tmp_path):
    store = JournalStore(str(tmp_path), "x")
    with pytest.raises(RuntimeError, match="outside"):
        store._append({"type": "obs"}, 1)


# -----------------------------------------------------------------------------
# JournalStore: tail-sync between replicas, compaction + generation reload
# -----------------------------------------------------------------------------

def test_two_stores_tail_sync(tmp_path):
    a = JournalStore(str(tmp_path), "j")
    b = JournalStore(str(tmp_path), "j")
    with a.transaction() as sync:
        sync.append({"type": "obs", "v": 1})
    with b.transaction() as sync:
        # b's first transaction reloads from scratch and sees a's record
        assert sync.reload
        assert [r["v"] for r in sync.records] == [1]
        sync.append({"type": "obs", "v": 2})
    with a.transaction() as sync:
        assert not sync.reload  # incremental: only b's record
        assert [r["v"] for r in sync.records] == [2]
        assert all(r["owner"] == b.session for r in sync.records)


def test_crash_between_snapshot_and_wal_truncate_does_not_double_apply(tmp_path):
    """compact() replaces the snapshot, THEN truncates the WAL: a crash in
    between leaves both on disk. Reload must skip records the snapshot
    already folds (seq watermark), or every budget would be charged twice."""
    a = JournalStore(str(tmp_path), "j")
    with a.transaction() as sync:
        sync.append({"type": "obs", "v": 1})
        sync.append({"type": "obs", "v": 2})
    wal_bytes = open(a.wal.path, "rb").read()
    with a.transaction():
        a.compact({"folded": 2})
    # simulate the crash window: snapshot(gen+1) on disk, WAL NOT truncated
    with open(a.wal.path, "wb") as f:
        f.write(wal_bytes)

    b = JournalStore(str(tmp_path), "j")
    with b.transaction() as sync:
        assert sync.reload and sync.snapshot["state"] == {"folded": 2}
        assert sync.records == []  # the stale WAL records are filtered
        # seq numbering continues past the snapshot watermark, so this
        # store's own appends are never at-or-below it
        rec = sync.append({"type": "obs", "v": 3})
        assert rec["seq"] > sync.snapshot["seq"]
    with JournalStore(str(tmp_path), "j").transaction() as sync:
        assert [r["v"] for r in sync.records] == [3]


def test_compaction_truncates_wal_and_forces_reload(tmp_path):
    a = JournalStore(str(tmp_path), "j")
    b = JournalStore(str(tmp_path), "j")
    with b.transaction():
        pass  # b is caught up at generation 0
    with a.transaction() as sync:
        sync.append({"type": "obs", "v": 1})
        a.compact({"folded": 1})
    assert a.wal_bytes == 0
    with b.transaction() as sync:  # generation bumped: full reload
        assert sync.reload
        assert sync.snapshot["state"] == {"folded": 1}
        assert sync.records == []  # WAL was folded into the snapshot


# -----------------------------------------------------------------------------
# Accountant durability: synthetic-plan helpers (no MPC — fast)
# -----------------------------------------------------------------------------

NOISE = TruncatedLaplace(eps=1.5, delta=5e-5, sensitivity=1)
N_SYNTH, T_SYNTH, S_SYNTH = 64, 5, 9


def synth_plan():
    return Resize(
        Filter(Scan("demographics"), [Predicate("zip", "eq", 1)]),
        ResizerConfig(noise=NOISE, addition="sequential"),
    )


def synth_report():
    rep = ExecutionReport()
    rep.nodes.append(NodeStats(
        node="Resize[rho(tlap,sequential)]", n_in=N_SYNTH, n_out=S_SYNTH,
        seconds=0.0, bytes_per_party=0, rounds=0,
        extra={"n": N_SYNTH, "t": T_SYNTH, "s": S_SYNTH},
    ))
    return rep


def drive_to_refusal(acct, max_steps=64):
    """admit+record until refused; returns the number of recorded charges."""
    plan = synth_plan()
    done = 0
    for _ in range(max_steps):
        try:
            admitted, _ = acct.admit(plan)
        except QueryRefused:
            return done
        acct.record(admitted, synth_report())
        done += 1
    raise AssertionError("never refused")


def test_durable_accountant_survives_restart(tmp_path):
    acct = PrivacyAccountant(policy="refuse",
                             store=JournalStore(str(tmp_path), "ledger"))
    r = drive_to_refusal(acct)
    sig = acct.signature(synth_plan())
    assert r == acct._state[sig].budget and r > 1

    # "restart": a brand-new accountant over the same directory
    acct2 = PrivacyAccountant(policy="refuse",
                              store=JournalStore(str(tmp_path), "ledger"))
    assert acct2.remaining(sig) == 0
    with pytest.raises(QueryRefused):
        acct2.admit(synth_plan())


def test_attach_store_merges_preexisting_memory_charges(tmp_path):
    """Attaching a journal to an accountant that already charged
    observations non-durably must not wipe them: an in-memory refusal stays
    a refusal after the attach (conservative, local-only merge)."""
    acct = PrivacyAccountant(policy="refuse")
    plan = synth_plan()
    r = drive_to_refusal(acct)  # exhaust the budget purely in memory
    sig = acct.signature(plan)
    assert acct.remaining(sig) == 0

    acct.attach_store(JournalStore(str(tmp_path), "ledger"))
    assert acct.remaining(sig) == 0  # nothing was forgotten
    with pytest.raises(QueryRefused):
        acct.admit(plan)
    assert acct.spent(sig) == r


def test_compaction_preserves_budget_and_open_intents(tmp_path):
    acct = PrivacyAccountant(policy="refuse",
                             store=JournalStore(str(tmp_path), "ledger"))
    plan = synth_plan()
    admitted, _ = acct.admit(plan)
    acct.record(admitted, synth_report())
    acct.admit(plan)  # open intent: admitted but never recorded (in flight)
    assert acct.maybe_compact(-1)  # force snapshot + WAL truncation
    assert acct.store.wal_bytes == 0

    acct2 = PrivacyAccountant(policy="refuse",
                              store=JournalStore(str(tmp_path), "ledger"))
    sig = acct2.signature(plan)
    st = acct2._state[sig]
    # the recorded charge AND the open intent both survived compaction; the
    # foreign (dead-session) intent is counted against the budget
    assert st.observed == 1 and len(st.intents) == 1
    assert acct2.spent(sig) == 2
    assert acct2.remaining(sig) == st.budget - 2


def test_charge_failed_is_journaled(tmp_path):
    """A crash between reveal and record must cost the budget durably."""
    acct = PrivacyAccountant(policy="refuse",
                             store=JournalStore(str(tmp_path), "ledger"))
    plan = synth_plan()
    admitted, _ = acct.admit(plan)
    acct.charge_failed(admitted)  # execution died after possible reveal
    acct2 = PrivacyAccountant(policy="refuse",
                              store=JournalStore(str(tmp_path), "ledger"))
    sig = acct2.signature(plan)
    st = acct2._state[sig]
    assert st.observed == 1 and not st.intents  # intent closed by the charge
    assert acct2.spent(sig) == 1


# -----------------------------------------------------------------------------
# Crash recovery: WAL truncated at every record boundary (and mid-line)
# replays to an accountant that refuses at-or-before the uninterrupted run
# -----------------------------------------------------------------------------

def test_wal_truncation_replay_is_conservative(tmp_path):
    base = tmp_path / "full"
    acct = PrivacyAccountant(policy="refuse",
                             store=JournalStore(str(base), "ledger"))
    r = drive_to_refusal(acct)
    sig = acct.signature(synth_plan())
    wal_path = acct.store.wal.path
    raw = open(wal_path, "rb").read()
    lines = raw.decode().splitlines(keepends=True)

    # truncation points: every record boundary, plus mid-line (torn write)
    offsets, pos = [0], 0
    for line in lines:
        offsets.append(pos + len(line) // 2)  # torn: crash mid-write
        pos += len(line)
        offsets.append(pos)  # boundary: crash between records

    for case, offset in enumerate(offsets):
        prefix = raw[:offset]
        # complete *intent* lines in the prefix: each one was durable before
        # its engine pass started, so each may have disclosed an observation
        n_intents = sum(
            1 for ln in prefix.decode(errors="ignore").splitlines()
            if ln.endswith("}") and _is_type(ln, "intent")
        )
        d = tmp_path / f"cut{case}"
        os.makedirs(d)
        with open(d / "ledger.wal.jsonl", "wb") as f:
            f.write(prefix)
        replayed = PrivacyAccountant(
            policy="refuse", store=JournalStore(str(d), "ledger")
        )
        # conservative and exact: every durable intent is charged (open
        # intents count), and nothing that never reached the disk is
        assert replayed.spent(sig) == n_intents, f"offset {offset}"
        # driving the replayed accountant to refusal must never allow the
        # TOTAL possible disclosures (pre-crash intents + new admits) past
        # the uninterrupted run's budget r
        extra = drive_to_refusal(replayed)
        assert n_intents + extra <= r, f"offset {offset}"
        # ... and when the budget was already learned pre-crash, the bound is
        # tight: the replayed run refuses exactly at r total
        if any(_is_type(ln, "record")
               for ln in prefix.decode(errors="ignore").splitlines()
               if ln.endswith("}")):
            assert n_intents + extra == r, f"offset {offset}"


def _is_type(line: str, typ: str) -> bool:
    try:
        return json.loads(line).get("type") == typ
    except ValueError:
        return False


# -----------------------------------------------------------------------------
# Service-level durability parity + multi-replica budget (real engine, tiny n)
# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    return generate_healthlnk(n=16, seed=3, aspirin_frac=0.5, icd_heart_frac=0.4)


def make_service(tables, state_dir, key=9, noise=None, policy="refuse"):
    return AnalyticsService(
        tables,
        noise=noise or ConstantNoise(0.2),
        addition="sequential",
        placement="after_joins",
        accountant=PrivacyAccountant(policy=policy),
        key=threefry.PRNGKey(key),
        state_dir=str(state_dir),
        device="cpu",
    )


def test_service_restart_still_refuses(tmp_path, data):
    """Durability parity acceptance: refused at budget r before the restart
    => still refused after it (fresh service objects, same state dir)."""
    tables, _ = data
    svc = make_service(tables, tmp_path)
    svc.session("alice").submit(DOSAGE)  # ConstantNoise: budget == 1
    with pytest.raises(QueryRefused):
        svc.session("alice").submit(DOSAGE)

    svc2 = make_service(tables, tmp_path, key=11)
    with pytest.raises(QueryRefused):  # the restart forgot nothing
        svc2.session("mallory").submit(DOSAGE)
    assert svc2.stats["refusals"] == 1


def test_two_replicas_cannot_jointly_overdraw(tmp_path, data):
    """Multi-replica acceptance: N services over one state dir enforce ONE
    global budget — interleaved submissions admit exactly `budget` total."""
    tables, _ = data
    noise = TruncatedLaplace(eps=1.5, delta=5e-5, sensitivity=1)
    a = make_service(tables, tmp_path, key=1, noise=noise)
    b = make_service(tables, tmp_path, key=2, noise=noise)
    assert a.accountant.store.session != b.accountant.store.session

    admitted, budget = 0, None
    for i in range(40):
        svc = (a, b)[i % 2]
        try:
            svc.session("t").submit(DOSAGE)
            admitted += 1
            budget = budget or svc.accountant.status()[0]["budget"]
        except QueryRefused:
            break
    else:
        raise AssertionError("never refused")
    assert budget is not None and 1 < budget < 40
    assert admitted == budget  # jointly exactly r, never r + 1
    # and both replicas agree the budget is gone
    for svc in (a, b):
        with pytest.raises(QueryRefused):
            svc.session("t").submit(DOSAGE)


def test_scheduler_journals_per_slot_intents(tmp_path, data):
    """Batched admission journals one intent per queued slot *before* the
    stacked pass runs, so a replica crash mid-batch still charges every
    queued disclosure on replay."""
    tables, _ = data
    noise = TruncatedLaplace(eps=1.5, delta=5e-5, sensitivity=1)
    svc = make_service(tables, tmp_path, noise=noise, policy="escalate")
    svc.scheduler.max_wait_s = 60.0  # hold the window open
    svc.enqueue("a", DOSAGE)
    svc.enqueue("b", DOSAGE)
    recs, _ = svc.accountant.store.wal.read_from(0)
    intents = [r for r in recs if r["type"] == "intent"]
    assert len(intents) == 2 and not any(r["type"] == "record" for r in recs)
    results = svc.drain()
    assert len(results) == 2
    recs, _ = svc.accountant.store.wal.read_from(0)
    assert sum(r["type"] == "record" for r in recs) == 2
    sig = next(iter(svc.accountant._state))
    assert not svc.accountant._state[sig].intents  # all intents closed


# -----------------------------------------------------------------------------
# Calibration: revealed sizes replace static selectivities
# -----------------------------------------------------------------------------

def test_calibration_store_ewma_and_persistence(tmp_path):
    store = JournalStore(str(tmp_path), "calibration")
    cal = CalibrationStore(store)
    key = calibration_key(Filter(Scan("medications"),
                                 [Predicate("med", "eq", 1)]))
    cal.observe(key, n=64, s=8)
    cal.observe(key, n=64, s=4)
    assert cal._stats[key]["count"] == 2
    assert cal._stats[key]["s_ewma"] == pytest.approx(6.0)  # 0.5*4 + 0.5*8

    # observations buffer off the engine's critical path: locally visible at
    # once, journaled only at flush (the service flushes per finalize)
    assert cal.status()["pending"] == 2
    fresh = CalibrationStore(JournalStore(str(tmp_path), "calibration"))
    assert key not in fresh._stats
    cal.flush()
    assert cal.status()["pending"] == 0

    cal2 = CalibrationStore(JournalStore(str(tmp_path), "calibration"))
    assert cal2._stats[key]["s_ewma"] == pytest.approx(6.0)
    cal.maybe_compact(-1)
    cal3 = CalibrationStore(JournalStore(str(tmp_path), "calibration"))
    assert cal3._stats[key]["s_ewma"] == pytest.approx(6.0)


def test_calibration_key_masks_literals_and_strips_resizers():
    f1 = Filter(Scan("medications"), [Predicate("med", "eq", 1)])
    f2 = Filter(Scan("medications"), [Predicate("med", "eq", 7)])
    assert calibration_key(f1) == calibration_key(f2)  # literal-masked
    wrapped = Filter(
        Resize(Scan("medications"), ResizerConfig(noise=RevealNoise())),
        [Predicate("med", "eq", 1)],
    )
    assert calibration_key(wrapped) == calibration_key(f1)  # Resize-stripped


JOIN_SQL = (
    "SELECT COUNT(*) FROM diagnoses d, medications m, demographics demo "
    "WHERE d.pid = m.pid AND d.pid = demo.pid AND m.med = 1"
)
PROBE_SQL = "SELECT COUNT(*) FROM medications WHERE med = 1"


def test_calibrated_reorder_is_cheaper_and_oracle_correct(tmp_path):
    """Calibration-efficacy acceptance: a cheap probe query's *already
    revealed* size flips a later multi-join's order to a cheaper one — across
    a service restart, with the same (oracle-verified) result, and with every
    calibration entry sourced from a disclosed resize info."""
    tables, plain = generate_healthlnk(n=64, seed=3, aspirin_frac=0.04,
                                       icd_heart_frac=0.3)
    mk = lambda key: AnalyticsService(
        tables, noise=RevealNoise(), addition="sequential",
        placement="all_internal",
        accountant=PrivacyAccountant(policy="escalate"),
        key=threefry.PRNGKey(key), state_dir=str(tmp_path), device="cpu",
    )
    svc = mk(1)
    plan_static, _, _ = svc.compile(JOIN_SQL)
    probe = svc.session("a").submit(PROBE_SQL)
    # zero additional disclosure: every calibration entry's (n, s) pair came
    # out of a revealed resize info of the executed report
    disclosed = {
        (e.extra["n"], e.extra["s"])
        for e in probe.report.nodes
        if e.node.startswith("Resize") and not e.extra.get("skipped")
    }
    cal_pairs = {
        (st["n_last"], st["s_last"]) for st in svc.calibration._stats.values()
    }
    assert cal_pairs and cal_pairs <= disclosed

    svc2 = mk(2)  # restart: calibration must survive the process boundary
    plan_cal, _, _ = svc2.compile(JOIN_SQL)
    assert plan_cal.pretty() != plan_static.pretty()  # different join order
    # the (observed-tiny) filtered medications leaf moved into the inner
    # join, displacing demographics to the outer one
    assert plan_cal.pretty().index("Filter(med eq 1)") < plan_cal.pretty().index(
        "Scan(demographics)"
    )
    assert plan_static.pretty().index("Scan(demographics)") < plan_static.pretty(
    ).index("Filter(med eq 1)")

    # cheaper under the calibrated model (the model that reflects reality)
    from repro_torch.sql.compile import default_cost_model

    cm = default_cost_model(svc2.catalog, noise=svc2.noise,
                            calibration=svc2.calibration)
    assert cm.plan_bytes(_logical(plan_cal)) < cm.plan_bytes(_logical(plan_static))

    # oracle-verified: both orders compute the same (correct) count
    out_static, _ = svc2.engine.execute(plan_static)
    res_cal = svc2.session("b").submit(JOIN_SQL)
    got_static = int(out_static.reveal_true_rows()["cnt"][0])
    got_cal = int(res_cal.rows["cnt"][0])
    d, m, demo = plain["diagnoses"], plain["medications"], plain["demographics"]
    demo_pids = set(demo["pid"].tolist())
    oracle = sum(
        1
        for i in range(len(d["pid"]))
        for j in range(len(m["pid"]))
        if m["pid"][j] == d["pid"][i] and m["med"][j] == 1
        and int(d["pid"][i]) in demo_pids
    )
    assert got_static == got_cal == oracle


def _logical(plan):
    from repro_torch.state.calibration import strip_resizers

    return strip_resizers(plan)


def test_calibration_does_not_disable_cost_based_placement():
    """Regression: resizer_profitable must judge the candidate node at its
    full pre-trim N. If the calibrated estimate (n already shrunk to the
    post-trim E[S]) fed the decision, every observed node would look
    already-small and placement would stop inserting the very Resizer that
    produced the observation."""
    from repro_torch.plan.cost import CostModel

    sizes = {"diagnoses": 1000, "medications": 1000, "demographics": 50}
    cols = {"diagnoses": 5, "medications": 4, "demographics": 2}
    filt = Filter(Scan("medications"), [Predicate("med", "eq", 1)])
    noise = RevealNoise()

    plain = CostModel(table_sizes=sizes, table_cols=cols, noise=noise)
    assert plain.resizer_profitable(filt)

    cal = CalibrationStore()
    # observed size matches the static default estimate exactly: learning it
    # must not change the (profitable) decision
    cal.observe(calibration_key(filt), n=1000, s=100)
    calibrated = CostModel(table_sizes=sizes, table_cols=cols, noise=noise,
                           calibration=cal)
    assert calibrated.resizer_profitable(filt)
    # ... while estimates flowing UP to parents still model the trim
    assert calibrated.estimate(filt)["n"] == 100


def test_cost_model_refine_only_touches_internal_nodes():
    cal = CalibrationStore()
    scan = Scan("medications")
    cal.observe(calibration_key(scan), n=64, s=2)
    est = {"n": 64, "t": 64, "cols": 4, "bytes": 0.0}
    # Scan is not a resizer candidate: calibration must not shrink it
    assert cal.refine(scan, dict(est), RevealNoise()) == est
    filt = Filter(scan, [Predicate("med", "eq", 1)])
    cal.observe(calibration_key(filt), n=64, s=2)
    refined = cal.refine(filt, {"n": 64, "t": 6.4, "cols": 4, "bytes": 5.0}, RevealNoise())
    assert refined["t"] == pytest.approx(2.0)
    assert refined["n"] == 2  # RevealNoise trims to exactly S
    nochange = cal.refine(filt, {"n": 64, "t": 6.4, "cols": 4, "bytes": 5.0}, None)
    assert nochange["n"] == 64  # no noise model: only T is calibrated


# -----------------------------------------------------------------------------
# Across the packages: one journal format, one key space, one budget
# -----------------------------------------------------------------------------

def _jsynth_plan():
    from repro.core.resizer import ResizerConfig as JConfig

    return jnodes.Resize(
        jnodes.Filter(jnodes.Scan("demographics"), [JPredicate("zip", "eq", 1)]),
        JConfig(noise=jnoise.TruncatedLaplace(eps=1.5, delta=5e-5, sensitivity=1), addition="sequential"),
    )


def _jsynth_report():
    from repro.engine.executor import ExecutionReport as JReport
    from repro.engine.executor import NodeStats as JStats

    rep = JReport()
    rep.nodes.append(JStats(
        node="Resize[rho(tlap,sequential)]", n_in=N_SYNTH, n_out=S_SYNTH,
        seconds=0.0, bytes_per_party=0, rounds=0,
        extra={"n": N_SYNTH, "t": T_SYNTH, "s": S_SYNTH},
    ))
    return rep


def test_signatures_and_budgets_equal_the_reference():
    """The ledger's keys are strings: the port's (fingerprint, strategy)
    signature and its budget for the same plan are the reference's."""
    acct, jacct = PrivacyAccountant(policy="refuse"), JAccountant(policy="refuse")
    assert acct.signature(synth_plan()) == jacct.signature(_jsynth_plan())
    r, jr = drive_to_refusal(acct), _jdrive(jacct)
    assert r == jr == acct._state[acct.signature(synth_plan())].budget


def _jdrive(acct, max_steps=64):
    from repro.service import QueryRefused as JRefused

    done = 0
    for _ in range(max_steps):
        try:
            admitted, _ = acct.admit(_jsynth_plan())
        except JRefused:
            return done
        acct.record(admitted, _jsynth_report())
        done += 1
    raise AssertionError("never refused")


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_port_reads_a_reference_journal(tmp_path, steps):
    """A ledger journal written by repro's accountant (records, and an
    intent left open) replays in the port's to the same observed counts,
    open intents, budget and remaining observations; and the port refuses
    exactly where the reference would."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    jacct = JAccountant(policy="refuse", store=jstate.JournalStore(str(port_dir), "ledger"))
    for _ in range(steps):
        admitted, _ = jacct.admit(_jsynth_plan())
        jacct.record(admitted, _jsynth_report())
    jacct.admit(_jsynth_plan())  # an open intent of a (now dead) session
    shutil.copytree(port_dir, ref_dir)
    acct = PrivacyAccountant(policy="refuse", store=JournalStore(str(port_dir), "ledger"))
    sig = acct.signature(synth_plan())
    jsig = jacct.signature(_jsynth_plan())
    assert sig == jsig
    jfresh = JAccountant(policy="refuse", store=jstate.JournalStore(str(ref_dir), "ledger"))
    assert acct.status() == jfresh.status()
    assert acct.spent(sig) == jfresh.spent(jsig) == steps + 1
    assert acct.remaining(sig) == jfresh.remaining(jsig)
    assert drive_to_refusal(acct) == _jdrive(jfresh)


def test_reference_reads_a_port_journal_after_compaction(tmp_path):
    acct = PrivacyAccountant(policy="refuse", store=JournalStore(str(tmp_path), "ledger"))
    admitted, _ = acct.admit(synth_plan())
    acct.record(admitted, synth_report())
    acct.admit(synth_plan())  # open intent
    assert acct.maybe_compact(-1)
    jacct = JAccountant(policy="refuse", store=jstate.JournalStore(str(tmp_path), "ledger"))
    fresh = PrivacyAccountant(policy="refuse", store=JournalStore(str(tmp_path), "ledger"))
    assert jacct.status() == fresh.status()
    assert json.load(open(tmp_path / "ledger.snapshot.json"))["state"]["sigs"][0]["observed"] == 1


def test_wal_bytes_equal_the_reference(tmp_path):
    """The same records through both WALs give the same bytes on disk."""
    recs = [{"type": "obs", "fp": "x", "n": 8, "s": 3}, {"b": [1, 2], "a": None}]
    port, ref = WriteAheadLog(str(tmp_path / "p.jsonl")), jstate.WriteAheadLog(str(tmp_path / "r.jsonl"))
    for r in recs:
        assert port.append(r) == ref.append(r)
    assert open(tmp_path / "p.jsonl", "rb").read() == open(tmp_path / "r.jsonl", "rb").read()
    assert port.read_from(0) == ref.read_from(0)


def test_lease_fencing_interleaves_with_the_reference(tmp_path):
    """Both packages' leases mint tokens from one fence file; a token the
    other package superseded is fenced, with the typed error."""
    a, b = FileLease(str(tmp_path), "ledger"), jstate.FileLease(str(tmp_path), "ledger")
    with a.hold() as t1:
        pass
    with b.hold() as t2:
        pass
    with a.hold() as t3:
        pass
    assert t1 < t2 < t3
    store = JournalStore(str(tmp_path), "j")
    with store.transaction() as sync:
        sync.append({"type": "obs"})
        with pytest.raises(LeaseFenced) as e:
            store._append({"type": "obs"}, sync.token - 1)
    assert isinstance(e.value, RuntimeError) and e.value.token == sync.token - 1


@pytest.mark.parametrize("sql", [
    "SELECT COUNT(*) FROM medications WHERE med = 1",
    QUERY_SQL["dosage_study"],
    QUERY_SQL["comorbidity"],
])
def test_calibration_keys_equal_the_reference(sql):
    from repro.sql import compile_logical as jcompile
    from repro_torch.sql import compile_logical

    assert calibration_key(compile_logical(sql)) == jstate.calibration_key(jcompile(sql))


def test_calibration_journal_is_shared_with_the_reference(tmp_path):
    jcal = jstate.CalibrationStore(jstate.JournalStore(str(tmp_path), "calibration"))
    jcal.observe("k", n=64, s=8)
    jcal.observe("k", n=64, s=4)
    jcal.flush()
    cal = CalibrationStore(JournalStore(str(tmp_path), "calibration"))
    assert cal._stats == jcal._stats
    est = {"n": 64, "t": 6.4, "cols": 4, "bytes": 5.0}
    filt = Filter(Scan("medications"), [Predicate("med", "eq", 1)])
    jfilt = jnodes.Filter(jnodes.Scan("medications"), [JPredicate("med", "eq", 1)])
    cal.observe(calibration_key(filt), n=64, s=2)
    jcal.observe(jstate.calibration_key(jfilt), n=64, s=2)
    assert cal.refine(filt, dict(est), RevealNoise()) == jcal.refine(jfilt, dict(est), jnoise.RevealNoise())
    assert cal.status()["entries"] == jcal.status()["entries"]
