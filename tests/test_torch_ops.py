"""The slice's operators one by one — predicate-tree Filter, the tiled lazy
Join (with theta conditions), the bitonic sort (single, lexicographic,
descending, payload-narrowed), segment starts and Distinct — on tables
carried over from repro with ``interop``: shares and ledger entries equal
repro's (exact). Also the schema check before any MPC work."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import ledger as jledger  # noqa: E402
from repro.core import prf as jprf  # noqa: E402
from repro.core import sort as jsort  # noqa: E402
from repro.ops import filter as jfilter  # noqa: E402
from repro.ops.distinct import oblivious_distinct as jdistinct  # noqa: E402
from repro.ops.groupby import segment_starts as jsegment_starts  # noqa: E402
from repro.ops.join import oblivious_join as jjoin  # noqa: E402
from repro.ops.table import SecretTable as JTable  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core import sort as tsort  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.core.sharing import BShare  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.errors import PlanSchemaError  # noqa: E402
from repro_torch.interop import prf_from_numpy, tables_from_numpy  # noqa: E402
from repro_torch.ops import filter as tfilter  # noqa: E402
from repro_torch.ops.distinct import oblivious_distinct as tdistinct  # noqa: E402
from repro_torch.ops.groupby import segment_starts as tsegment_starts  # noqa: E402
from repro_torch.ops.join import oblivious_join as tjoin  # noqa: E402
from repro_torch.ops.table import SecretTable as TTable  # noqa: E402
from repro_torch.plan import Distinct, Filter, Join, Scan  # noqa: E402


def _entries(led):
    return [(e.op, e.rounds, e.bytes_per_party, e.count) for e in led.entries]


def _pair(n, seed, cols=("a", "b", "c"), hi=6):
    """The same table in repro and (carried over) in the port."""
    rng = np.random.default_rng(seed)
    data = {c: rng.integers(0, hi, n).astype(np.uint32) for c in cols}
    valid = (rng.random(n) < 0.7).astype(np.uint32)
    jt = JTable.from_plaintext(data, jax.random.PRNGKey(seed), valid=valid)
    tt = tables_from_numpy(
        {"t": ({c: np.asarray(v.shares) for c, v in jt.cols.items()}, np.asarray(jt.valid.shares))}, "cpu"
    )["t"]
    return jt, tt


def _prfs(seed):
    jp = jprf.setup_prf(jax.random.PRNGKey(seed))
    return jp, prf_from_numpy(np.asarray(jp.pair_keys))


def _same_shares(j, t):
    assert (np.asarray(j.shares) == to_numpy(t.shares)).all()


def _same_table(jt, tt):
    assert list(jt.cols) == list(tt.cols)
    for name in jt.cols:
        _same_shares(jt.col(name), tt.col(name))
    _same_shares(jt.valid, tt.valid)


def _tree(m):
    """(a = 3 AND b < 4) OR (c <= 2 AND b > 1) OR a = col:b, in module m."""
    P = m.Predicate
    return m.Or((
        m.And((P("a", "eq", 3), P("b", "lt", 4))),
        m.And((P("c", "le", 2), P("b", "gt", 1))),
        P("a", "eq", "col:b"),
    ))


@pytest.mark.parametrize(
    "name,build",
    [
        ("conjunction", lambda m: [m.Predicate("a", "eq", 3), m.Predicate("b", "lt", 4)]),
        ("tree", _tree),
        ("column_compare", lambda m: [m.Predicate("a", "lt", "col:c"), m.Predicate("c", "le", "col:b")]),
    ],
)
def test_filter_matches_reference(name, build):
    jt, tt = _pair(37, seed=1)
    jp, tp = _prfs(2)
    with jledger.CommLedger() as jl:
        jout = jfilter.oblivious_filter(jt, build(jfilter), jp)
    with tledger.CommLedger() as tl:
        tout = tfilter.oblivious_filter(tt, build(tfilter), tp)
    _same_table(jout, tout)
    assert _entries(jl) == _entries(tl)
    assert tfilter.render_pred(tfilter.normalize_pred(build(tfilter))) == jfilter.render_pred(
        jfilter.normalize_pred(build(jfilter))
    )


@pytest.mark.parametrize("theta,tile", [(None, 7), (("c", "le", "c"), 64), (("b", "eq", "c"), 16)])
def test_join_matches_reference(theta, tile):
    (jl_, tl_), (jr_, tr_) = _pair(9, seed=3), _pair(6, seed=4)
    jp, tp = _prfs(5)
    with jledger.CommLedger() as jl:
        jout = jjoin(jl_, jr_, ("a", "b"), jp, theta=theta, tile=tile)
    with tledger.CommLedger() as tl:
        tout = tjoin(tl_, tr_, ("a", "b"), tp, theta=theta, tile=tile)
    assert list(jout.cols) == list(tout.cols) == ["a", "b", "c", "r1.a", "r1.b", "r1.c"]
    _same_table(jout, tout)
    assert _entries(jl) == _entries(tl)


@pytest.mark.parametrize(
    "keys,descending,narrow",
    [("a", False, False), (("a", "b"), False, False), ("a", True, False), ("a", False, True)],
)
def test_bitonic_sort_matches_reference(keys, descending, narrow):
    jt, tt = _pair(16, seed=6, cols=("a", "b", "c", "d"), hi=4)
    jcols, tcols = dict(jt.cols), dict(tt.cols)
    jp, tp = _prfs(7)
    jfn = jsort.bitonic_sort_narrow if narrow else jsort.bitonic_sort
    tfn = tsort.bitonic_sort_narrow if narrow else tsort.bitonic_sort
    with jledger.CommLedger() as jl:
        jout = jfn(jcols, keys, jp, descending=descending)
    with tledger.CommLedger() as tl:
        tout = tfn(tcols, keys, tp, descending=descending)
    for name in jcols:
        _same_shares(jout[name], tout[name])
    assert _entries(jl) == _entries(tl)
    a = to_numpy(tout["a"].shares[0] ^ tout["a"].shares[1] ^ tout["a"].shares[2])
    assert (a == np.sort(a)[::-1]).all() if descending else (a == np.sort(a)).all()


def test_bitonic_stages_and_power_of_two():
    assert list(tsort.bitonic_stages(8)) == list(jsort.bitonic_stages(8))
    _, tt = _pair(12, seed=8)
    with pytest.raises(ValueError):
        tsort.bitonic_sort(dict(tt.cols), "a", _prfs(0)[1])


@pytest.mark.parametrize("composite", [False, True])
def test_segment_starts_matches_reference(composite):
    jt, tt = _pair(16, seed=9, hi=3)
    jp, tp = _prfs(10)
    names = ["a", "b"] if composite else ["a"]
    jkey = [jt.col(c) for c in names] if composite else jt.col("a")
    tkey = [tt.col(c) for c in names] if composite else tt.col("a")
    _same_shares(jsegment_starts(jkey, jt.valid, jp), tsegment_starts(tkey, tt.valid, tp))


@pytest.mark.parametrize("n", [13, 16])
def test_distinct_matches_reference(n):
    jt, tt = _pair(n, seed=n, hi=5)
    jp, tp = _prfs(11)
    with jledger.CommLedger() as jl:
        jout = jdistinct(jt, "a", jp)
    with tledger.CommLedger() as tl:
        tout = tdistinct(tt, "a", tp)
    _same_table(jout, tout)
    assert _entries(jl) == _entries(tl)
    rows = tout.reveal_true_rows()["a"]
    plain = tt.reveal()
    assert sorted(rows.tolist()) == sorted(set(plain["a"][plain["_valid"] == 1].tolist()))


def test_schema_error_before_any_mpc_work():
    table = TTable.from_plaintext({"pid": np.arange(4, dtype=np.uint32)}, threefry.PRNGKey(0), device="cpu")
    engine = Engine({"t": table, "u": table}, device="cpu")
    with tledger.CommLedger() as led:
        with pytest.raises(PlanSchemaError) as err:
            engine.execute(Distinct(Filter(Scan("t"), [tfilter.Predicate("nope", "eq", 1)]), "pid"))
        assert err.value.column == "nope" and err.value.available == ["pid"]
        with pytest.raises(PlanSchemaError):
            engine.execute(Join(Scan("t"), Scan("missing"), ("pid", "pid")))
        out, _ = engine.execute(Distinct(Join(Scan("t"), Scan("u"), ("pid", "pid")), "r1.pid"))
    assert isinstance(out.valid, BShare)
    assert led.entries == []  # each node runs under its own ledger


def test_join_tile_changes_randomness_not_results():
    from repro_torch.config import RuntimeConfig

    rng = np.random.default_rng(12)
    data = {"pid": rng.integers(0, 5, 10).astype(np.uint32)}
    table = TTable.from_plaintext(data, threefry.PRNGKey(1), device="cpu")
    plan = Distinct(Join(Scan("t"), Scan("t"), ("pid", "pid")), "pid")
    runs = [
        Engine({"t": table}, key=threefry.PRNGKey(2), config=RuntimeConfig(join_tile=tile), device="cpu").execute(plan)
        for tile in (7, 1 << 16)
    ]
    (small, small_rep), (big, big_rep) = runs
    assert [(s.rounds, s.bytes_per_party) for s in small_rep.nodes] == [(s.rounds, s.bytes_per_party) for s in big_rep.nodes]
    assert sorted(small.reveal_true_rows()["pid"].tolist()) == sorted(set(data["pid"].tolist()))
    assert sorted(big.reveal_true_rows()["pid"].tolist()) == sorted(set(data["pid"].tolist()))
    with pytest.raises(ValueError):
        RuntimeConfig(join_tile=0)
