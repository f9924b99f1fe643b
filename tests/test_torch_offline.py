"""The port's offline randomness subsystem (``repro_torch.offline``) against
``repro.offline``: randomness manifests per node, the recorded derivation
DAG (every event's op, parent and args), the pool's counts, bytes and LRU
eviction order, hits bit-identical to misses through the engine and the
service, and the provisioner's refills inline and on its background
thread. Both packages run the same plans over the same tables and keys;
the port runs on the CPU. Every comparison is exact.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import material as jmaterial  # noqa: E402
from repro.core import noise as jnoise  # noqa: E402
from repro.core.resizer import ResizerConfig as JConfig  # noqa: E402
from repro.data import generate_healthlnk as jgenerate  # noqa: E402
from repro.data.queries import QUERY_SQL  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.offline import Provisioner as JProvisioner  # noqa: E402
from repro.offline import RandomnessPlanner as JPlanner  # noqa: E402
from repro.offline import RandomnessPool as JPool  # noqa: E402
from repro.ops.filter import Predicate as JPredicate  # noqa: E402
from repro.plan import nodes as jnodes  # noqa: E402
from repro.sql import compile_logical as jcompile_logical  # noqa: E402
from repro.sql.catalog import HEALTHLNK_CATALOG as JCATALOG  # noqa: E402
from repro_torch.core import material, threefry  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core.resizer import ResizerConfig  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.data import generate_healthlnk, plaintext_oracle  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.offline import Provisioner, RandomnessPlanner, RandomnessPool  # noqa: E402
from repro_torch.ops.filter import Predicate  # noqa: E402
from repro_torch.plan import nodes as tnodes  # noqa: E402
from repro_torch.service import AnalyticsService, PrivacyAccountant  # noqa: E402
from repro_torch.sql import compile_logical  # noqa: E402
from repro_torch.sql.catalog import HEALTHLNK_CATALOG  # noqa: E402

DATA = dict(n=16, seed=3, aspirin_frac=0.5, icd_heart_frac=0.4)


@pytest.fixture(scope="module")
def data():
    """(port tables, plaintext, reference tables): the same shares."""
    jtables, _ = jgenerate(**DATA)
    ttables, plain = generate_healthlnk(device="cpu", **DATA)
    return ttables, plain, jtables


def _plans(nodes, predicate, config, noise):
    return {
        "filter": lambda: nodes.Filter(nodes.Scan("diagnoses"), [predicate("icd9", "eq", 414)]),
        "sum": lambda: nodes.Sum(nodes.Filter(nodes.Scan("medications"), [predicate("med", "eq", 1)]), "dosage"),
        "resize_parallel": lambda: nodes.Resize(
            nodes.Filter(nodes.Scan("diagnoses"), [predicate("icd9", "eq", 414)]),
            config(noise=noise.BetaNoise(2, 6), addition="parallel")),
        "resize_sequential": lambda: nodes.Resize(
            nodes.Filter(nodes.Scan("diagnoses"), [predicate("icd9", "eq", 414)]),
            config(noise=noise.BetaNoise(2, 6), addition="sequential")),
    }


PLANS = _plans(tnodes, Predicate, ResizerConfig, tnoise)
JPLANS = _plans(jnodes, JPredicate, JConfig, jnoise)
GOLDENS = ["dosage_study", "aspirin_count", "comorbidity", "three_join", "dosage_sum"]


def _engine(tables, seed=0):
    return Engine(tables, key=threefry.PRNGKey(seed), device="cpu")


def _jengine(tables, seed=0):
    return JEngine(tables, key=jax.random.PRNGKey(seed))


def _recorded(tables, plan, seed=0, pool=None):
    eng = _engine(tables, seed)
    pool = pool if pool is not None else RandomnessPool(device="cpu")
    src = pool.source(("bundle",), eng.prf.pair_keys)
    with material.material_scope(src):
        out, rep = eng.execute(plan)
    src.finish()
    return eng, pool, src, out, rep


def _jrecorded(tables, plan, seed=0, pool=None):
    eng = _jengine(tables, seed)
    pool = pool if pool is not None else JPool()
    src = pool.source(("bundle",), eng.prf.pair_keys)
    with jmaterial.material_scope(src):
        out, rep = eng.execute(plan)
    src.finish()
    return eng, pool, src, out, rep


def _events(pool, bundle=("bundle",)):
    return [(e.op, e.parent, e.args, e.root, e.is_root) for e in pool._recipes[bundle].events]


def _shares(out):
    return {k: np.asarray(v) for k, v in out.reveal().items()}


def _same(a, b):
    a, b = _shares(a), _shares(b)
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _tally(rep):
    return [(s.node, s.bytes_per_party, s.rounds, s.extra.get("s")) for s in rep.nodes]


# -----------------------------------------------------------------------------
# Manifests
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PLANS))
def test_manifest_equals_the_reference_and_the_recorded_events(data, name):
    """Per node, the port's manifest is the reference's; for these
    statically enumerable plans it is exact, and equals the events a cold
    recording run of the port intercepts."""
    tables, _, _ = data
    plan = PLANS[name]()
    manifest = RandomnessPlanner(catalog=HEALTHLNK_CATALOG).manifest(plan)
    jmanifest = JPlanner(catalog=JCATALOG).manifest(JPLANS[name]())
    assert manifest.template == jmanifest.template
    assert [vars(nm) for nm in manifest.nodes] == [vars(nm) for nm in jmanifest.nodes]
    assert manifest.exact
    _, _, src, _, _ = _recorded(tables, plan)
    got, totals = src.event_counts(), manifest.totals()
    assert got.get("fold", 0) == totals["folds"]
    assert got.get("draw", 0) + got.get("uniform", 0) == totals["draws"]
    assert got.get("zero_add", 0) + got.get("zero_xor", 0) == totals["zero_shares"]
    assert got.get("perm", 0) == totals["perms"]


@pytest.mark.parametrize("query", GOLDENS)
def test_golden_manifests_equal_the_reference(query):
    from repro.sql.compile import default_cost_model as jcost
    from repro_torch.sql.compile import default_cost_model

    sql = QUERY_SQL[query]
    manifest = RandomnessPlanner(HEALTHLNK_CATALOG, default_cost_model(HEALTHLNK_CATALOG)).manifest(
        compile_logical(sql))
    jmanifest = JPlanner(JCATALOG, jcost(JCATALOG)).manifest(jcompile_logical(sql))
    assert manifest.template == jmanifest.template
    assert [vars(nm) for nm in manifest.nodes] == [vars(nm) for nm in jmanifest.nodes]
    assert manifest.totals() == jmanifest.totals() and manifest.exact == jmanifest.exact


# -----------------------------------------------------------------------------
# The pool: recorded DAG, counts, bytes, eviction order
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PLANS))
def test_recorded_recipe_and_pool_stats_equal_the_reference(data, name):
    tables, _, jtables = data
    _, pool, src, out, _ = _recorded(tables, PLANS[name]())
    _, jpool, jsrc, jout, _ = _jrecorded(jtables, JPLANS[name]())
    assert src.event_counts() == jsrc.event_counts()
    assert _events(pool) == _events(jpool)
    assert pool.stats() == jpool.stats()
    assert (src.hits, src.misses) == (jsrc.hits, jsrc.misses)
    assert _same(out, jout)


def test_provisioned_counter_material_equals_the_reference(data):
    """The provisioner replays the recipe for upcoming counters: the same
    entries, bytes and owned counter range as the reference's, and then the
    same hits and misses in a hot run."""
    tables, _, jtables = data
    plan, jplan = PLANS["resize_parallel"](), JPLANS["resize_parallel"]()
    _, pool, _, _, _ = _recorded(tables, plan)
    _, jpool, _, _, _ = _jrecorded(jtables, jplan)
    eng, jeng = _engine(tables), _jengine(jtables)
    got = Provisioner(pool, eng.prf, ctr_fn=lambda: eng._resize_ctr, window=4).refill(trigger="test")
    want = JProvisioner(jpool, jeng.prf, ctr_fn=lambda: jeng._resize_ctr, window=4).refill(trigger="test")
    for k in ("gc_dropped", "static_entries", "counter_entries", "watermark"):
        assert got[k] == want[k]
    assert pool.stats() == jpool.stats()
    assert pool.owned_counters(("bundle",)) == jpool.owned_counters(("bundle",)) == (1, 4, 4)
    src = pool.source(("bundle",), eng.prf.pair_keys)
    jsrc = jpool.source(("bundle",), jeng.prf.pair_keys)
    with material.material_scope(src):
        out, rep = eng.execute(plan)
    with jmaterial.material_scope(jsrc):
        jout, jrep = jeng.execute(jplan)
    assert (src.hits, src.misses) == (jsrc.hits, jsrc.misses) and src.misses == 0
    assert _same(out, jout) and _tally(rep) == _tally(jrep)
    assert pool.gc(eng._resize_ctr) == jpool.gc(jeng._resize_ctr) > 0
    assert pool.stats() == jpool.stats()


def test_eviction_order_equals_the_reference(data):
    """Three bundles through a pool that holds about two: the same bundles
    are evicted, in the same order, and the same stay."""
    tables, _, jtables = data
    _, probe, _, _, _ = _recorded(tables, PLANS["filter"]())
    budget = int(probe.total_bytes() * 2.5)
    pool, jpool = RandomnessPool(max_bytes=budget, device="cpu"), JPool(max_bytes=budget)
    eng, jeng = _engine(tables), _jengine(jtables)
    orders = []
    for bundle, name in (("b1", "filter"), ("b2", "sum"), ("b1", "filter"), ("b3", "resize_parallel"),
                         ("b2", "sum")):
        src = pool.source((bundle,), eng.prf.pair_keys)
        jsrc = jpool.source((bundle,), jeng.prf.pair_keys)
        with material.material_scope(src):
            eng.execute(PLANS[name]())
        with jmaterial.material_scope(jsrc):
            jeng.execute(JPLANS[name]())
        src.finish()
        jsrc.finish()
        assert (src.hits, src.misses) == (jsrc.hits, jsrc.misses)
        orders.append((list(pool._static), list(jpool._static)))
        assert pool.stats() == jpool.stats()
    assert all(a == b for a, b in orders)
    assert pool.stats()["evictions"] > 0


def test_pool_bytes_are_counted_from_shapes(data):
    """Entries count numel * element size; a hop permutation is held as
    int32 (the reference's width) and served as the int64 index."""
    tables, _, _ = data
    _, pool, _, _, _ = _recorded(tables, PLANS["resize_parallel"]())
    eng = _engine(tables)
    Provisioner(pool, eng.prf, ctr_fn=lambda: eng._resize_ctr, window=1).refill()
    entries = [v for b in pool._static.values() for v in b.values()] + [v for v, _ in pool._counter.values()]
    assert pool.total_bytes() == sum(v.numel() * v.element_size() for v in entries)
    perms = [(k, v) for k, (v, _) in pool._counter.items() if k[0] == "perm"]
    assert perms and all(v.dtype == torch.int32 for _, v in perms)
    key, stored = perms[0]
    src = pool.source(("bundle",), eng.prf.pair_keys)
    served = src.fetch("perm", torch.from_numpy(np.frombuffer(key[1], np.int32).reshape(3, 2).copy()), key[2],
                       lambda: None)
    assert served.dtype == torch.int64 and torch.equal(served, stored.long())


# -----------------------------------------------------------------------------
# Hits equal misses, bit for bit
# -----------------------------------------------------------------------------

def test_hot_run_bit_identical_to_cold_and_unpooled(data):
    tables, _, jtables = data
    plan = PLANS["resize_parallel"]()
    out_ref, rep_ref = _engine(tables).execute(plan)
    _, pool, src1, out_cold, rep_cold = _recorded(tables, plan)
    assert src1.misses > 0 and pool.has_recipe(("bundle",))
    eng2 = _engine(tables)
    summary = Provisioner(pool, eng2.prf, ctr_fn=lambda: eng2._resize_ctr, window=4).refill(trigger="test")
    assert summary["counter_entries"] > 0
    src2 = pool.source(("bundle",), eng2.prf.pair_keys)
    with material.material_scope(src2):
        out_hot, rep_hot = eng2.execute(plan)
    assert src2.hits > 0 and src2.misses == 0
    assert _same(out_ref, out_cold) and _same(out_ref, out_hot)
    assert _tally(rep_ref) == _tally(rep_cold) == _tally(rep_hot)
    jout, jrep = _jengine(jtables).execute(JPLANS["resize_parallel"]())
    assert _same(out_hot, jout) and _tally(rep_hot) == _tally(jrep)


def test_mixed_run_and_exhaustion_keep_the_counter_stream(data):
    """Counters 1..2 provisioned, three executions: the third derives on
    demand from the engine's own counter 3; results equal a never-pooled
    engine's, run by run."""
    tables, _, _ = data
    plan = PLANS["resize_sequential"]()
    eng_ref = _engine(tables)
    refs = [eng_ref.execute(plan) for _ in range(3)]
    _, pool, _, _, _ = _recorded(tables, plan)
    eng = _engine(tables)
    Provisioner(pool, eng.prf, ctr_fn=lambda: eng._resize_ctr, window=2).refill()
    assert pool.owned_counters(("bundle",))[2] == 2
    outs, hits = [], []
    for _ in range(3):
        src = pool.source(("bundle",), eng.prf.pair_keys)
        with material.material_scope(src):
            outs.append(eng.execute(plan))
        hits.append((src.hits, src.misses))
    assert hits[0][1] == hits[1][1] == 0 and hits[2][1] > 0
    assert eng._resize_ctr == eng_ref._resize_ctr == 3
    for (out_r, rep_r), (out_p, rep_p) in zip(refs, outs):
        assert _same(out_r, out_p) and _tally(rep_r) == _tally(rep_p)


def test_batched_pass_through_the_pool_equals_serial(data):
    """``execute_batch`` consults the pool with concrete keys inside its
    stacked passes: slots equal the unpooled serial runs."""
    tables, _, _ = data
    plan = PLANS["resize_parallel"]()
    eng_ref = _engine(tables)
    refs = [eng_ref.execute(plan) for _ in range(3)]
    _, pool, _, _, _ = _recorded(tables, plan)
    eng = _engine(tables)
    Provisioner(pool, eng.prf, ctr_fn=lambda: eng._resize_ctr, window=4).refill()
    src = pool.source(("bundle",), eng.prf.pair_keys)
    with material.material_scope(src):
        slots = eng.execute_batch([plan] * 3)
    assert src.hits > 0
    for (out_r, rep_r), (out_b, rep_b) in zip(refs, slots):
        assert _same(out_r, out_b) and _tally(rep_r) == _tally(rep_b)


# -----------------------------------------------------------------------------
# The provisioner: inline and background refills
# -----------------------------------------------------------------------------

def _service(tables, offline, **kw):
    return AnalyticsService(
        tables, noise=tnoise.BetaNoise(2, 6), addition="sequential", placement="after_joins",
        accountant=PrivacyAccountant(policy="escalate"), key=threefry.PRNGKey(9), offline=offline,
        device="cpu", **kw,
    )


def test_service_on_mode_refills_at_idle_and_hits(data):
    tables, plain, _ = data
    sql = QUERY_SQL["dosage_study"]
    off = _service(tables, "off")
    ref = [off.submit("t", sql) for _ in range(3)]
    svc = _service(tables, "on")
    cold = svc.submit("t", sql)
    svc.drain()  # idle window: the inline provisioner refills
    assert svc.provisioner.stats()["refills"] == 1
    hot = [svc.submit("t", sql) for _ in range(2)]
    oracle = plaintext_oracle("dosage_study", plain)
    for r, p in zip(ref, [cold] + hot):
        assert sorted(set(p.rows["pid"].tolist())) == oracle
        assert [(s.node, s.bytes_per_party, s.rounds, s.extra.get("s")) for s in r.report.nodes] == \
            [(s.node, s.bytes_per_party, s.rounds, s.extra.get("s")) for s in p.report.nodes]
        for k in r.rows:
            assert np.array_equal(r.rows[k], p.rows[k])
    assert svc.pool.stats()["hits"] > 0
    extras = [s.extra.get("offline") for s in hot[-1].report.nodes]
    assert any(e and e.get("hits", 0) > 0 for e in extras)
    assert svc.status()["offline"]["mode"] == "on"


def test_background_provisioner_thread_refills(data):
    tables, plain, _ = data
    sql = QUERY_SQL["dosage_study"]
    svc = _service(tables, "background")
    try:
        prov = svc.provisioner
        assert prov.stats()["running"]
        prov.interval_s = 0.05
        first = svc.submit("t", sql)
        deadline = time.monotonic() + 60
        while svc.pool.stats()["counter_entries"] == 0 and time.monotonic() < deadline:
            prov.hint()
            time.sleep(0.05)
        assert svc.pool.stats()["counter_entries"] > 0 and prov.stats()["error"] is None
        second = svc.submit("t", sql)
        assert second.report.nodes and any(
            (s.extra.get("offline") or {}).get("hits", 0) for s in second.report.nodes)
        oracle = plaintext_oracle("dosage_study", plain)
        assert sorted(set(first.rows["pid"].tolist())) == sorted(set(second.rows["pid"].tolist())) == oracle
    finally:
        svc.close()
    assert not svc.provisioner.stats()["running"]


def test_concurrent_refill_and_consumption_race(data):
    """Refill and gc threads race the consuming engine under a short switch
    interval: every execution still equals an unpooled engine's."""
    tables, _, _ = data
    plan = PLANS["resize_parallel"]()
    eng_ref = _engine(tables)
    _, pool, _, _, _ = _recorded(tables, plan)
    eng = _engine(tables)
    prov = Provisioner(pool, eng.prf, ctr_fn=lambda: eng._resize_ctr, window=4)
    stop, errors = threading.Event(), []

    def hammer():
        while not stop.is_set():
            try:
                prov.refill(trigger="race")
                pool.gc(eng._resize_ctr)
            except Exception as e:  # noqa: BLE001 - reported by the assert below
                errors.append(e)
                return

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(3):
            out_ref, _ = eng_ref.execute(plan)
            src = pool.source(("bundle",), eng.prf.pair_keys)
            with material.material_scope(src):
                out, _ = eng.execute(plan)
            assert _same(out_ref, out)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors


def test_offline_modes_validate():
    with pytest.raises(ValueError, match="offline"):
        AnalyticsService({}, offline="sometimes", device="cpu")


def test_pool_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert RandomnessPool().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            RandomnessPool()


def test_share_words_equal_through_to_numpy(data):
    """The tables both packages start from are the same share words."""
    tables, _, jtables = data
    for name in tables:
        assert np.array_equal(to_numpy(tables[name].valid.shares), np.asarray(jtables[name].valid.shares))
