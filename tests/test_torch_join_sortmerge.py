"""The sort-merge join (``ops/join_sortmerge.py``) in the port and in repro,
from the same shares and PRF keys: output shares, ledger entries and the
revealed rows bit for bit, for both build sides, fanout 1 and 3, a theta
``le`` or ``eq`` or none, empty inputs, a fanout below the true
multiplicity, on the fused and the gate-by-gate circuit path. Then
``dosage_study``, ``aspirin_count`` and ``projection_join`` compiled with
the sort-merge join forced, through both engines: per node shares, ledger,
every S and the rows."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import noise as jnoise  # noqa: E402
from repro.core.ledger import CommLedger as JLedger  # noqa: E402
from repro.core.prf import setup_prf as jsetup_prf  # noqa: E402
from repro.data.healthlnk import generate_healthlnk as jgenerate  # noqa: E402
from repro.data.healthlnk import plaintext_oracle as joracle  # noqa: E402
from repro.data.queries import QUERY_SQL as JSQL  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.ops import oblivious_join_sortmerge as jsortmerge  # noqa: E402
from repro.ops.table import SecretTable as JTable  # noqa: E402
from repro.sql import Catalog as JCatalog  # noqa: E402
from repro.sql import compile_query as jcompile  # noqa: E402
from repro_torch import RuntimeConfig  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.ledger import CommLedger as TLedger  # noqa: E402
from repro_torch.data import QUERY_SQL, revealed_answer  # noqa: E402
from repro_torch.data.healthlnk import generate_healthlnk as tgenerate  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.interop import prf_from_numpy, tables_from_numpy  # noqa: E402
from repro_torch.kernels import override_fusion  # noqa: E402
from repro_torch.ops import oblivious_join_sortmerge  # noqa: E402
from repro_torch.plan import JoinSortMerge  # noqa: E402
from repro_torch.sql import Catalog, compile_query, plan_fingerprint  # noqa: E402
from test_torch_slice import _assert_outputs_equal, _assert_reports_equal  # noqa: E402

DATA = dict(n=8, seed=3, aspirin_frac=0.5)
SQL_GOLDENS = ("dosage_study", "aspirin_count", "projection_join")
_REFERENCE: dict = {}


def _jtable(cols, valid, seed):
    data = {k: np.asarray(v, np.uint32) for k, v in cols.items()}
    return JTable.from_plaintext(data, jax.random.PRNGKey(seed), valid=np.asarray(valid, np.uint32))


def _port_tables(jtables):
    return tables_from_numpy(
        {n: ({c: np.asarray(v.shares) for c, v in t.cols.items()}, np.asarray(t.valid.shares))
         for n, t in jtables.items()},
        device="cpu",
    )


def _entries(led):
    return [(e.op, e.rounds, e.bytes_per_party, e.count) for e in led.entries]


# name -> (left columns, left valid, right columns, right valid)
TABLES = {
    # duplicate keys on both sides, an invalid row on each
    "dups": ({"k": [1, 2, 3, 2, 9], "a": [10, 20, 30, 40, 50]}, [1, 1, 1, 1, 0],
             {"k": [2, 2, 5, 1], "b": [100, 200, 300, 400]}, [1, 1, 0, 1]),
    # the build side holds two valid rows of key 2; fanout 1 keeps one (the
    # cases share one union size, 16 rows, so the reference compiles once)
    "fanout_short": ({"k": [2, 2, 0, 0, 0], "a": [1, 2, 0, 0, 0]}, [1, 1, 0, 0, 0],
                     {"k": [2, 0, 0, 0], "b": [5, 0, 0, 0]}, [1, 0, 0, 0]),
    # no key in common
    "no_match": ({"k": [1, 2, 2, 3, 4], "a": [5, 5, 50, 6, 7]}, [1, 1, 1, 1, 1],
                 {"k": [7, 8, 9, 10], "b": [0, 0, 1, 1]}, [1, 1, 1, 0]),
}
THETAS = {"none": None, "le": ("a", "le", "b"), "eq": ("k", "eq", "k")}


def _reference_join(case, build, fanout, theta):
    key = ("op", case, build, fanout, theta)
    if key not in _REFERENCE:
        lc, lv, rc, rv = TABLES[case]
        jt = {"l": _jtable(lc, lv, 1), "r": _jtable(rc, rv, 2)}
        prf = jsetup_prf(jax.random.PRNGKey(0)).fold(7)
        with JLedger() as led:
            out = jsortmerge(jt["l"], jt["r"], ("k", "k"), prf, theta=THETAS[theta], fanout=fanout, build=build)
        _REFERENCE[key] = (jt, np.asarray(prf.pair_keys), out, _entries(led))
    return _REFERENCE[key]


def _check_operator(case, build, fanout, theta, fused):
    jt, pair_keys, jout, jentries = _reference_join(case, build, fanout, theta)
    tt = _port_tables(jt)
    with TLedger() as led, override_fusion(fused):
        tout = oblivious_join_sortmerge(tt["l"], tt["r"], ("k", "k"), prf_from_numpy(pair_keys),
                                        theta=THETAS[theta], fanout=fanout, build=build)
    assert _entries(led) == jentries
    _assert_outputs_equal(jout, tout)
    return tout


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gates"])
@pytest.mark.parametrize("theta", ["none", "le", "eq"])
@pytest.mark.parametrize("fanout", [1, 3])
@pytest.mark.parametrize("build", ["left", "right"])
def test_sortmerge_matches_reference(build, fanout, theta, fused):
    out = _check_operator("dups", build, fanout, theta, fused)
    assert out.n == fanout * 16


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gates"])
def test_fanout_below_multiplicity_matches_reference(fused):
    out = _check_operator("fanout_short", "left", 1, "none", fused)
    # a fanout below the true multiplicity keeps one match per probe row
    assert len(out.reveal_true_rows()["k"]) == 1


@pytest.mark.parametrize("build", ["left", "right"])
def test_no_match_matches_reference(build):
    out = _check_operator("no_match", build, 3, "none", True)
    assert len(out.reveal_true_rows()["k"]) == 0


@pytest.mark.parametrize("side", ["left", "right"])
def test_empty_input_matches_reference(side):
    lc, lv, rc, rv = TABLES["dups"]
    jt = {"l": _jtable(lc, lv, 1), "r": _jtable(rc, rv, 2)}
    empty = JTable({c: v.take(np.zeros(0, np.int32)) for c, v in jt[side[0]].cols.items()},
                   jt[side[0]].valid.take(np.zeros(0, np.int32)))
    jt[side[0]] = empty
    prf = jsetup_prf(jax.random.PRNGKey(0))
    with JLedger() as jled:
        jout = jsortmerge(jt["l"], jt["r"], ("k", "k"), prf, fanout=2)
    tt = _port_tables(jt)
    with TLedger() as tled:
        tout = oblivious_join_sortmerge(tt["l"], tt["r"], ("k", "k"), prf_from_numpy(np.asarray(prf.pair_keys)),
                                        fanout=2)
    assert _entries(tled) == _entries(jled) == []
    assert tout.n == jout.n == 0
    assert list(tout.cols) == list(jout.cols) == ["k", "a", "r1.k", "b"]


def test_bad_arguments_raise_as_the_reference():
    lc, lv, rc, rv = TABLES["dups"]
    tt = _port_tables({"l": _jtable(lc, lv, 1), "r": _jtable(rc, rv, 2)})
    prf = prf_from_numpy(np.zeros((3, 2), np.uint32))
    with pytest.raises(ValueError, match="build side"):
        oblivious_join_sortmerge(tt["l"], tt["r"], ("k", "k"), prf, build="middle")
    with pytest.raises(ValueError, match="fanout"):
        oblivious_join_sortmerge(tt["l"], tt["r"], ("k", "k"), prf, fanout=0)


# -----------------------------------------------------------------------------
# compiled goldens through both engines
# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    jtables, jplain = jgenerate(**DATA)
    ttables, tplain = tgenerate(**DATA, device="cpu")
    return jtables, jplain, ttables, tplain


def _multiplicity(plain):
    return {t: {"pid": int(np.bincount(cols["pid"]).max())} for t, cols in plain.items()}


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def _reference_golden(jtables, jplain, query, placement):
    key = ("golden", query, placement)
    if key not in _REFERENCE:
        catalog = JCatalog.from_tables(jtables, multiplicity=_multiplicity(jplain))
        plan = jcompile(JSQL[query], catalog, placement=placement, noise=jnoise.UniformNoise(0.0, 0.5),
                        join_algo="sortmerge")
        _REFERENCE[key] = (plan, *JEngine(jtables, key=jax.random.PRNGKey(5)).execute(plan))
    return _REFERENCE[key]


# one placement each for the two paper goldens (the reference's compile time
# bounds the file), both for projection_join
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gates"])
@pytest.mark.parametrize(
    "query,placement",
    [("dosage_study", "after_joins"), ("aspirin_count", "none"), ("projection_join", "all_internal"),
     ("projection_join", "none")],
)
def test_compiled_golden_matches_reference(data, query, placement, fused):
    jtables, jplain, ttables, tplain = data
    jplan, jout, jrep = _reference_golden(jtables, jplain, query, placement)
    catalog = Catalog.from_tables(ttables, multiplicity=_multiplicity(tplain))
    plan = compile_query(QUERY_SQL[query], catalog, placement=placement, noise=tnoise.UniformNoise(0.0, 0.5),
                         config=RuntimeConfig(join_algo="sortmerge"))
    assert plan_fingerprint(plan) == jplan.pretty()
    joins = [n for n in _walk(plan) if isinstance(n, JoinSortMerge)]
    jjoins = [n for n in _walk(jplan) if type(n).__name__ == "JoinSortMerge"]
    assert [(j.fanout, j.build) for j in joins] == [(j.fanout, j.build) for j in jjoins] != []
    engine = TEngine(ttables, key=threefry.PRNGKey(5), config=RuntimeConfig(fuse_circuits=fused), device="cpu")
    tout, trep = engine.execute(plan)
    _assert_reports_equal(jrep, trep)
    _assert_outputs_equal(jout, tout)
    assert revealed_answer(query, plan, tout) == joracle(query, jplain)
