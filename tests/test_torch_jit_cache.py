"""The port's per-operator cache (``Engine(jit_ops=True)``) against the
reference's jit cache, on the CPU.

On the CPU an entry of the port's cache runs its protocol eagerly on the
device-key path of ``core/prf.py`` (on the card it is a CUDA graph; see
``tests/test_torch_cuda.py``); the cache, its key, its logical statistics,
the ledger replay and the pool bypass are the ones the card uses. Every
case runs the same plan or SQL through both packages with both caches
cleared, and compares the port with the reference's own ``jit_ops=True``
run: output shares, per-node ledger tallies, rows, cache size and hit /
miss counts, the offline pool's hits and misses, the service's
``status()['jit_cache']`` and ``reflex_jit_cache_logical`` lines. The
cases are those of ``tests/test_jit_ledger.py``, the jit-against-eager case
of ``tests/test_perf_levers.py`` and the two statistics cases of
``tests/test_service.py``, one GROUP BY at n = 8, LRU eviction at a cache
of two entries, and the device-key draws against the host path as a
hypothesis property. The reference's plans are sort-free but the GROUP BY:
its XLA-CPU compiles of sort networks take minutes above n = 8.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")

from repro.core import noise as jnoise  # noqa: E402
from repro.data import generate_healthlnk as jgenerate  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.ops.filter import Or as JOr  # noqa: E402
from repro.ops.filter import Predicate as JPredicate  # noqa: E402
from repro.plan import nodes as jnodes  # noqa: E402
from repro.plan.registry import registered_ops as jregistered  # noqa: E402
from repro.service import AnalyticsService as JService  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.data import generate_healthlnk  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.ops.filter import Or, Predicate  # noqa: E402
from repro_torch.plan import nodes as tnodes  # noqa: E402
from repro_torch.plan.registry import registered_ops  # noqa: E402
from repro_torch.service import AnalyticsService  # noqa: E402

LEDGER_DATA = dict(n=8, seed=2, aspirin_frac=0.5)  # tests/test_jit_ledger.py
LEVERS_DATA = dict(n=12, seed=3, aspirin_frac=0.4, icd_heart_frac=0.3)  # tests/test_perf_levers.py
SERVICE_DATA = dict(n=16, seed=3, aspirin_frac=0.5, icd_heart_frac=0.4)  # tests/test_service.py


def _clear():
    for eng in (Engine, JEngine):
        eng._JIT_CACHE.clear()
        eng.reset_jit_stats()


def _stats():
    """(port, reference) jit statistics."""
    return Engine.jit_cache_stats(), JEngine.jit_cache_stats()


def _words(x) -> list:
    return np.asarray(x).view(np.uint32).tolist()


def _shares(table) -> dict:
    out = {c: _words(table.col(c).shares) for c in table.cols}
    out["_valid"] = _words(table.valid.shares)
    return out


def _profile(report) -> list:
    return [(s.node, s.n_ins, s.n_out, s.bytes_per_party, s.rounds) for s in report.nodes]


def _ledger_plan(m, pred, or_):
    d = m.Filter(m.Scan("diagnoses"), [or_((pred("icd9", "eq", 414), pred("icd9", "eq", 390)))])
    return m.CountValid(m.Join(d, m.Scan("medications"), ("pid", "pid")))


def _levers_plan(m, pred):
    return m.CountValid(
        m.Join(
            m.Filter(m.Scan("diagnoses"), [pred("icd9", "eq", 414)]),
            m.Filter(m.Scan("medications"), [pred("med", "eq", 1)]),
            ("pid", "pid"),
        )
    )


# -----------------------------------------------------------------------------
# The registry: which operators go through the cache
# -----------------------------------------------------------------------------

def test_protocol_and_stateful_operators_equal_the_reference():
    """Field for field: a pure protocol (cached) or a stateful hook that
    bypasses the cache (Scan, Resize), and the batched-pass hooks."""

    def split(ops):
        return {
            t.__name__: (d.protocol is not None, d.engine_apply is not None, d.batch_apply is not None, d.batchable)
            for t, d in ops.items()
        }

    port, ref = split(registered_ops()), split(jregistered())
    assert port == ref
    assert sorted(n for n, (proto, _, _, _) in port.items() if not proto) == ["Resize", "Scan"]


# -----------------------------------------------------------------------------
# tests/test_jit_ledger.py: capture, replay, a second engine
# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ledger_runs():
    """An eager run, then a jit engine's first (capturing) and second
    (replaying) execute, then a second jit engine with another key, in
    both packages."""
    jt, _ = jgenerate(**LEDGER_DATA)
    tt, _ = generate_healthlnk(device="cpu", **LEDGER_DATA)
    jplan, tplan = _ledger_plan(jnodes, JPredicate, JOr), _ledger_plan(tnodes, Predicate, Or)
    _clear()
    runs = {"eager": (JEngine(jt, key=jax.random.PRNGKey(3)).execute(jplan),
                      Engine(tt, key=threefry.PRNGKey(3), device="cpu").execute(tplan))}
    jeng = JEngine(jt, key=jax.random.PRNGKey(3), jit_ops=True)
    teng = Engine(tt, key=threefry.PRNGKey(3), jit_ops=True, device="cpu")
    sizes = {}
    for run in ("first", "replay"):
        runs[run] = (jeng.execute(jplan), teng.execute(tplan))
        sizes[run] = (len(Engine._JIT_CACHE), len(JEngine._JIT_CACHE))
    runs["other_key"] = (JEngine(jt, key=jax.random.PRNGKey(9), jit_ops=True).execute(jplan),
                         Engine(tt, key=threefry.PRNGKey(9), jit_ops=True, device="cpu").execute(tplan))
    return runs, sizes, _stats()


@pytest.mark.parametrize("run", ["first", "replay", "other_key"])
def test_jit_runs_equal_the_references_jit_runs(ledger_runs, run):
    runs, _, _ = ledger_runs
    (jout, jrep), (tout, trep) = runs[run]
    assert _profile(trep) == _profile(jrep)
    assert _shares(tout) == _shares(jout)
    assert {k: v.tolist() for k, v in tout.reveal_true_rows().items()} == {
        k: np.asarray(v).tolist() for k, v in jout.reveal_true_rows().items()
    }


def test_jit_ledger_parity_with_eager(ledger_runs):
    runs, sizes, _ = ledger_runs
    (_, jeager), (_, teager) = runs["eager"]
    (_, jfirst), (_, tfirst) = runs["first"]
    assert _profile(tfirst) == _profile(teager) == _profile(jfirst) == _profile(jeager)
    # Filter, Join, CountValid were cached; the Scans bypass the cache
    assert sizes["first"] == (3, 3)


def test_jit_cache_hit_replays_recorded_tally(ledger_runs):
    runs, sizes, stats = ledger_runs
    assert sizes["replay"] == sizes["first"]
    assert _profile(runs["replay"][1][1]) == _profile(runs["first"][1][1])
    assert _profile(runs["other_key"][1][1]) == _profile(runs["first"][1][1])
    port, ref = stats
    assert port == ref
    assert (port["misses"], port["hits"], port["size"]) == (3, 6, 3)


def test_jit_results_match_eager_results(ledger_runs):
    """The same key and counter give the eager run's shares: the reference's
    jit and eager runs agree, and so do the port's."""
    runs, _, _ = ledger_runs
    (jeager, _), (teager, _) = runs["eager"]
    for run in ("first", "replay"):
        (jout, _), (tout, _) = runs[run]
        assert _shares(tout) == _shares(teager) == _shares(jout) == _shares(jeager)
    (_, _), (tother, _) = runs["other_key"]
    assert _shares(tother) != _shares(teager)  # a replay draws with its engine's keys
    cnt = int(teager.reveal_true_rows()["cnt"][0])
    assert int(tother.reveal_true_rows()["cnt"][0]) == cnt


# -----------------------------------------------------------------------------
# tests/test_perf_levers.py: jit against eager
# -----------------------------------------------------------------------------

def test_engine_jit_matches_eager():
    jt, _ = jgenerate(**LEVERS_DATA)
    tt, plain = generate_healthlnk(device="cpu", **LEVERS_DATA)
    _clear()
    outs = []
    for jit_ops in (False, True):
        jout, jrep = JEngine(jt, key=jax.random.PRNGKey(5), jit_ops=jit_ops).execute(_levers_plan(jnodes, JPredicate))
        tout, trep = Engine(tt, key=threefry.PRNGKey(5), jit_ops=jit_ops, device="cpu").execute(
            _levers_plan(tnodes, Predicate))
        assert _shares(tout) == _shares(jout)
        assert _profile(trep) == _profile(jrep) and trep.total_bytes > 0
        outs.append(int(tout.reveal_true_rows()["cnt"][0]))
    d, m = plain["diagnoses"], plain["medications"]
    want = sum(
        1
        for i in range(len(d["pid"]))
        for j in range(len(m["pid"]))
        if d["pid"][i] == m["pid"][j] and d["icd9"][i] == 414 and m["med"][j] == 1
    )
    assert outs[0] == outs[1] == want
    assert Engine.jit_cache_stats() == JEngine.jit_cache_stats()


def test_group_by_under_jit_equals_the_reference():
    """One sort network (the bitonic GroupBy at n = 8) through the cache."""
    data = dict(n=8, seed=3, aspirin_frac=0.5, icd_heart_frac=0.4)
    jt, _ = jgenerate(**data)
    tt, _ = generate_healthlnk(device="cpu", **data)
    _clear()
    jeng = JEngine(jt, key=jax.random.PRNGKey(9), jit_ops=True)
    teng = Engine(tt, key=threefry.PRNGKey(9), jit_ops=True, device="cpu")
    eager, _ = Engine(tt, key=threefry.PRNGKey(9), device="cpu").execute(
        tnodes.GroupByCount(tnodes.Scan("diagnoses"), "major_icd9"))
    for _ in range(2):
        jout, jrep = jeng.execute(jnodes.GroupByCount(jnodes.Scan("diagnoses"), "major_icd9"))
        tout, trep = teng.execute(tnodes.GroupByCount(tnodes.Scan("diagnoses"), "major_icd9"))
        assert _shares(tout) == _shares(jout) == _shares(eager)
        assert _profile(trep) == _profile(jrep)
    assert Engine.jit_cache_stats() == JEngine.jit_cache_stats()


# -----------------------------------------------------------------------------
# tests/test_service.py: logical statistics of the serial and batched paths
# -----------------------------------------------------------------------------

def _services(**kw):
    jt, _ = jgenerate(**SERVICE_DATA)
    tt, _ = generate_healthlnk(device="cpu", **SERVICE_DATA)
    jsvc = JService(jt, noise=jnoise.NoTrim(), placement="none", jit_ops=True, key=jax.random.PRNGKey(9), **kw)
    tsvc = AnalyticsService(tt, noise=tnoise.NoTrim(), placement="none", jit_ops=True, key=threefry.PRNGKey(9),
                            device="cpu", **kw)
    return tsvc, jsvc


def _rows(res) -> dict:
    return {k: np.asarray(v).tolist() for k, v in res.rows.items()}


def test_jit_cache_counts_k_logical_hits_for_batched_pass():
    tsvc, jsvc = _services(batch_wait_s=60.0)
    sql = "SELECT pid, icd9 FROM diagnoses WHERE icd9 = 390"
    k = 3
    _clear()
    seen = []
    for _ in range(2):
        for svc in (tsvc, jsvc):
            for i in range(k):
                svc.enqueue(f"t{i}", sql)
        tres, jres = tsvc.drain(), jsvc.drain()
        assert [_rows(r) for r in tres] == [_rows(r) for r in jres]
        assert [_shares(r.table) for r in tres] == [_shares(r.table) for r in jres]
        assert [_profile(r.report) for r in tres] == [_profile(r.report) for r in jres]
        port, ref = _stats()
        assert port == ref
        seen.append((port["misses"], port["hits"]))
    # Filter and Project: one entry each covers all K slots
    assert seen == [(2, 2 * (k - 1)), (2, 2 * (2 * k - 1))]
    assert tsvc.cache_stats() == jsvc.cache_stats()


def test_jit_cache_stats_count_serial_path_too():
    tsvc, jsvc = _services()
    sql = "SELECT pid FROM diagnoses WHERE icd9 = 414"
    _clear()
    for step in range(2):
        tres, jres = tsvc.session("a").submit(sql), jsvc.session("a").submit(sql)
        assert _rows(tres) == _rows(jres) and _shares(tres.table) == _shares(jres.table)
        port, ref = _stats()
        assert port == ref
        if step == 0:
            first = port
            assert first["hits"] == 0 and first["misses"] > 0
    assert port["misses"] == first["misses"] and port["hits"] == first["misses"]


# -----------------------------------------------------------------------------
# The offline pool under jit; the service's jit surface
# -----------------------------------------------------------------------------

def _status_view(st):
    st = dict(st)
    prov = dict(st["offline"].pop("provisioner"))
    prov.pop("last_refill_seconds")
    st["offline"]["provisioner"] = prov
    return st


def _gauge_lines(text):
    return [line for line in text.splitlines() if "reflex_jit_cache_logical" in line]


@pytest.fixture(scope="module")
def pooled():
    """The service's defaults (TLap noise, the pool on) with Resizers on
    every internal operator, under jit: a submit, an idle window that
    refills the pool, the same query again and another; each submit's
    per-node pool traffic. Eager, every node draws from the pool; under jit
    only the Resizes, which bypass the cache, do."""
    jt, _ = jgenerate(**SERVICE_DATA)
    tt, _ = generate_healthlnk(device="cpu", **SERVICE_DATA)
    _clear()
    jsvc = JService(jt, jit_ops=True, key=jax.random.PRNGKey(9), placement="all_internal")
    tsvc = AnalyticsService(tt, jit_ops=True, key=threefry.PRNGKey(9), placement="all_internal", device="cpu")
    sqls = ["SELECT COUNT(*) FROM medications WHERE med = 1"] * 2 + [
        "SELECT COUNT(*) FROM medications WHERE dosage = 325"]
    got, want = [], []
    for i, sql in enumerate(sqls):
        for svc, out in ((tsvc, got), (jsvc, want)):
            res = svc.session("a").submit(sql)
            out.append({
                "rows": _rows(res),
                "shares": _shares(res.table),
                "nodes": [(s.node, s.rounds, s.bytes_per_party, s.extra.get("s"), s.extra.get("offline"))
                          for s in res.report.nodes],
            })
            if i == 0:
                svc.drain()  # the idle window: the provisioner refills
    return tsvc, jsvc, got, want


def test_pool_hits_and_misses_under_jit_equal_the_reference(pooled):
    tsvc, jsvc, got, want = pooled
    assert got == want
    assert tsvc.pool.stats() == jsvc.pool.stats()
    # inside a cache entry the pool is bypassed: only the Resizes draw from
    # it, cold at first, then from the refilled pool
    traffic = [[(node.split("[")[0], offline) for node, _, _, _, offline in s["nodes"] if offline] for s in got]
    assert [[node for node, _ in t] for t in traffic] == [["Resize"]] * 3
    assert traffic[0][0][1]["hits"] == 0 and traffic[1][0][1]["misses"] == traffic[2][0][1]["misses"] == 0


def test_status_jit_cache_and_gauge_equal_the_reference(pooled):
    tsvc, jsvc, _, _ = pooled
    port, ref = tsvc.status(), jsvc.status()
    assert port["jit_cache"] == ref["jit_cache"] == {**Engine.jit_cache_stats(), "scope": "process"}
    assert port["jit_cache"]["misses"] > 0 and port["jit_cache"]["hits"] > 0
    assert _status_view(port) == _status_view(ref)
    lines = _gauge_lines(tsvc.render_metrics())
    assert lines == _gauge_lines(jsvc.render_metrics())
    assert len([line for line in lines if not line.startswith("#")]) == 3  # hits, misses, size


# -----------------------------------------------------------------------------
# LRU eviction
# -----------------------------------------------------------------------------

def test_lru_eviction_equals_the_reference(monkeypatch):
    monkeypatch.setattr(Engine, "_JIT_CACHE_MAX", 2)
    monkeypatch.setattr(JEngine, "_JIT_CACHE_MAX", 2)
    jt, _ = jgenerate(**LEDGER_DATA)
    tt, _ = generate_healthlnk(device="cpu", **LEDGER_DATA)

    def plan(m):  # three protocol nodes that compile at once
        cols = ("pid", "icd9", "diag")
        return m.Project(m.Project(m.Project(m.Scan("diagnoses"), cols), cols[:2]), cols[:1])

    _clear()
    jeng = JEngine(jt, key=jax.random.PRNGKey(3), jit_ops=True)
    teng = Engine(tt, key=threefry.PRNGKey(3), jit_ops=True, device="cpu")
    for _ in range(2):
        jout, _ = jeng.execute(plan(jnodes))
        tout, _ = teng.execute(plan(tnodes))
        assert _shares(tout) == _shares(jout)
        assert [k[1] for k in Engine._JIT_CACHE] == [k[1] for k in JEngine._JIT_CACHE]
        assert len(Engine._JIT_CACHE) == 2
    port, ref = _stats()
    assert port == ref
    # with room for two, each of the three nodes evicts one made before it
    assert (port["misses"], port["hits"]) == (6, 0)
    # the innermost node's entry went first: run alone, it misses again
    teng.execute(plan(tnodes).child.child)
    assert Engine.jit_cache_stats()["misses"] == 7


def test_pool_byte_bound_evicts_the_least_recently_used():
    """The port's second bound, which the reference's cache of executables
    does not need: on the card every entry's graphs hold a memory pool, so
    entries are evicted oldest first while their pools hold more than the
    budget, and the entry used last stays even alone above it."""
    from types import SimpleNamespace

    _clear()
    for i, pool in enumerate((40, 30, 20, 10)):
        Engine._jit_cache_put(("k", i), SimpleNamespace(pool_bytes=pool))
    assert Engine._jit_cache_get(("k", 0)) is not None  # the oldest becomes the newest
    Engine._jit_cache_fit(100)
    assert [k[1] for k in Engine._JIT_CACHE] == [1, 2, 3, 0]
    Engine._jit_cache_fit(65)
    assert [k[1] for k in Engine._JIT_CACHE] == [3, 0]
    Engine._jit_cache_fit(5)
    assert [k[1] for k in Engine._JIT_CACHE] == [0]
    assert Engine.jit_cache_stats()["size"] == 1
    _clear()


# -----------------------------------------------------------------------------
# The device-key draws against the host path
# -----------------------------------------------------------------------------

_U32 = st.integers(0, 2**32 - 1)


@settings(max_examples=60, deadline=None)
@given(hi=_U32, lo=_U32, tag=_U32, rows=st.integers(0, 9), lanes=st.integers(1, 7), num=st.integers(1, 6),
       bounds=st.sampled_from([(0.0, 1.0), (-2.5, 7.0), (1e-3, 0.125), (-1e4, 1e4)]))
def test_device_key_draws_equal_the_host_path(hi, lo, tag, rows, lanes, num, bounds):
    key = threefry.make_key(hi, lo)
    assert torch.equal(threefry.fold_in_dev(key, tag), threefry.fold_in(key, tag))
    assert torch.equal(threefry.split_dev(key, num), threefry.split(key, num))
    shape = (rows, lanes)
    assert torch.equal(threefry.bits_dev(key, shape), threefry.bits(key, shape, "cpu"))
    assert torch.equal(threefry.uniform_dev(key, shape, *bounds), threefry.uniform(key, shape, *bounds, device="cpu"))
    # three pair keys at once, as PRFSetup(device_keys=True) hashes them
    keys = torch.stack([key, threefry.fold_in(key, 1), threefry.fold_in(key, 2)])
    assert torch.equal(threefry.fold_in_dev(keys, tag), torch.stack([threefry.fold_in(k, tag) for k in keys]))
    assert torch.equal(threefry.bits_dev(keys, shape), torch.stack([threefry.bits(k, shape, "cpu") for k in keys]))
    assert torch.equal(threefry.permutation_dev(key, rows * lanes), threefry.permutation(key, rows * lanes, "cpu"))
