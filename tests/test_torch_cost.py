"""The port's cost model (``plan/cost.py``, the registry's estimates), the
noise strategies' moments and the join algorithm's selection against
repro's: every estimate float for float on every node of every golden, the
``cost_based`` Resizer decision at every node, and the same algorithm,
build side and fanout across the ``auto`` crossover."""
import pytest

pytest.importorskip("jax")

from repro.core import noise as jnoise  # noqa: E402
from repro.core.resizer import ResizerConfig as JConfig  # noqa: E402
from repro.plan import Join as JJoin  # noqa: E402
from repro.plan import Scan as JScan  # noqa: E402
from repro.plan import insert_resizers as jinsert  # noqa: E402
from repro.plan import registry as jregistry  # noqa: E402
from repro.plan import select_join_algorithms as jselect  # noqa: E402
from repro.plan.cost import CostModel as JCostModel  # noqa: E402
from repro.sql import Catalog as JCatalog  # noqa: E402
from repro.sql import compile_logical as jcompile_logical  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core.resizer import ResizerConfig as TConfig  # noqa: E402
from repro_torch.data import QUERY_SQL  # noqa: E402
from repro_torch.plan import Join, JoinSortMerge, Scan, insert_resizers, select_join_algorithms  # noqa: E402
from repro_torch.plan import registry  # noqa: E402
from repro_torch.plan.cost import CostModel  # noqa: E402
from repro_torch.sql import HEALTHLNK_CATALOG, Catalog, compile_logical, default_cost_model  # noqa: E402

TABLES = {name: list(cols) for name, cols in HEALTHLNK_CATALOG.tables.items()}
SIZES = {"diagnoses": 8192, "medications": 8192, "demographics": 2048}
MULT = {"diagnoses": {"pid": 13}, "medications": {"pid": 11}, "demographics": {"pid": 1}}
NOISES = {
    "tlap": lambda m: m.TruncatedLaplace(eps=0.5),
    "beta": lambda m: m.BetaNoise(2, 6),
    "uniform": lambda m: m.UniformNoise(0.0, 0.5),
    "const": lambda m: m.ConstantNoise(0.1),
    "reveal": lambda m: m.RevealNoise(),
    "notrim": lambda m: m.NoTrim(),
}


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def _models(noise):
    kw = dict(table_sizes=dict(SIZES), table_cols={t: len(c) for t, c in TABLES.items()})
    return (CostModel(**kw, noise=NOISES[noise](tnoise) if noise else None),
            JCostModel(**kw, noise=NOISES[noise](jnoise) if noise else None))


def _assert_estimates_equal(plan, jplan, cm, jcm):
    pairs = list(zip(_walk(plan), _walk(jplan)))
    assert len(pairs) == len(list(_walk(jplan)))
    for node, jnode in pairs:
        assert type(node).__name__ == type(jnode).__name__
        assert cm.estimate(node) == jcm.estimate(jnode), node.describe()
        assert cm.resizer_profitable(node) == jcm.resizer_profitable(jnode), node.describe()


@pytest.mark.parametrize("n,t", [(0, 0), (1, 1), (100, 7), (8192, 300), (1 << 20, 1 << 10)])
@pytest.mark.parametrize("noise", list(NOISES))
def test_noise_moments_equal_the_reference(noise, n, t):
    mine, ref = NOISES[noise](tnoise), NOISES[noise](jnoise)
    assert mine.name == ref.name
    for moment in ("mean", "var", "var_parallel"):
        assert getattr(mine, moment)(n, t) == getattr(ref, moment)(n, t), moment


@pytest.mark.parametrize("placement", ["none", "all_internal"])
@pytest.mark.parametrize("query", list(QUERY_SQL))
def test_estimates_equal_the_reference_on_every_node(query, placement):
    catalog = Catalog(TABLES, SIZES)
    plan = compile_logical(QUERY_SQL[query], catalog)
    jplan = jcompile_logical(QUERY_SQL[query], JCatalog(TABLES, SIZES))
    for noise in ("tlap", "beta", "uniform"):
        cm, jcm = _models(noise)
        placed = insert_resizers(plan, lambda node: TConfig(noise=NOISES[noise](tnoise)), placement=placement)
        jplaced = jinsert(jplan, lambda node: JConfig(noise=NOISES[noise](jnoise)), placement=placement)
        _assert_estimates_equal(placed, jplaced, cm, jcm)
        assert cm.plan_bytes(placed) == jcm.plan_bytes(jplaced)


@pytest.mark.parametrize("query", ["dosage_study", "aspirin_count", "three_join", "projection_join"])
def test_sortmerge_estimates_equal_the_reference(query):
    catalog, jcatalog = Catalog(TABLES, SIZES, MULT), JCatalog(TABLES, SIZES, MULT)
    plan = select_join_algorithms(compile_logical(QUERY_SQL[query], catalog), catalog=catalog, mode="sortmerge")
    jplan = jselect(jcompile_logical(QUERY_SQL[query], jcatalog), catalog=jcatalog, mode="sortmerge")
    assert any(isinstance(n, JoinSortMerge) for n in _walk(plan))
    cm, jcm = _models("beta")
    _assert_estimates_equal(plan, jplan, cm, jcm)


def test_cost_constants_equal_the_reference():
    assert registry.BYTES == jregistry.BYTES
    for n in (1, 2, 3, 1000, 8192, 1 << 20):
        for cols in (1, 4, 9):
            assert registry.sort_bytes(n, cols) == jregistry.sort_bytes(n, cols)
            assert registry.shuffle_bytes(n, cols) == jregistry.shuffle_bytes(n, cols)
            assert registry.resizer_bytes(n, cols) == jregistry.resizer_bytes(n, cols)
            for fanout in (1, 11):
                for theta in (False, True):
                    args = (n, 2 * n + 1, cols, 3, fanout, theta)
                    assert registry.sortmerge_join_bytes(*args) == jregistry.sortmerge_join_bytes(*args)


def _two_table_catalog(n, lmult, rmult):
    mult = {t: {"k": m} for t, m in (("l", lmult), ("r", rmult)) if m is not None}
    args = ({"l": ["k", "a"], "r": ["k", "b"]}, {"l": n, "r": n}, mult or None)
    return Catalog(*args), JCatalog(*args)


@pytest.mark.parametrize("lmult,rmult", [(4, 4), (8, 2), (1, None), (None, 3), (None, None)])
@pytest.mark.parametrize("mode", ["auto", "sortmerge", "product"])
@pytest.mark.parametrize("log_n", [4, 8, 9, 10, 11, 14])
def test_join_algorithm_choice_equals_the_reference(log_n, mode, lmult, rmult):
    catalog, jcatalog = _two_table_catalog(1 << log_n, lmult, rmult)
    cm, jcm = default_cost_model(catalog), JCostModel(
        table_sizes={t: jcatalog.size(t) for t in jcatalog.tables},
        table_cols={t: len(c) for t, c in jcatalog.tables.items()},
    )
    for theta in (("a", "le", "b"), None):
        got = select_join_algorithms(Join(Scan("l"), Scan("r"), ("k", "k"), theta), cm, catalog, mode)
        want = jselect(JJoin(JScan("l"), JScan("r"), ("k", "k"), theta), jcm, jcatalog, mode)
        assert type(got).__name__ == type(want).__name__
        if isinstance(got, JoinSortMerge):
            assert (got.fanout, got.build) == (want.fanout, want.build)
    if mode == "auto" and lmult == rmult == 4 and log_n in (8, 11, 14):
        # the reference's own crossover points (no theta): the product join
        # at 2^8 rows a side, the sort-merge join from 2^11
        assert type(got) is (Join if log_n == 8 else JoinSortMerge)


def test_no_multiplicity_means_no_rewrite():
    plan = compile_logical(QUERY_SQL["dosage_study"])
    for mode in ("auto", "sortmerge"):
        out = select_join_algorithms(plan, default_cost_model(HEALTHLNK_CATALOG), HEALTHLNK_CATALOG, mode)
        assert out == plan and not any(isinstance(n, JoinSortMerge) for n in _walk(out))
    with pytest.raises(ValueError, match="bogus"):
        select_join_algorithms(plan, None, HEALTHLNK_CATALOG, "bogus")


def test_build_side_has_the_smaller_bound():
    from repro_torch.ops import Predicate
    from repro_torch.plan import Filter

    catalog, _ = _two_table_catalog(64, 8, 2)
    chosen = select_join_algorithms(Join(Scan("l"), Scan("r"), ("k", "k")), catalog=catalog, mode="sortmerge")
    assert isinstance(chosen, JoinSortMerge) and (chosen.build, chosen.fanout) == ("right", 2)
    # the bound passes through a Filter, not through a join
    inner = Join(Filter(Scan("l"), [Predicate("a", "eq", 1)]), Scan("r"), ("k", "k"))
    outer = select_join_algorithms(Join(inner, Scan("r"), ("k", "k")), catalog=catalog, mode="sortmerge")
    assert (outer.build, outer.fanout) == ("right", 2)
    assert (outer.left.build, outer.left.fanout) == ("right", 2)
    kids = [{"n": 64, "t": 64, "cols": 2, "bytes": 0.0}] * 2
    assert registry.lookup(JoinSortMerge).estimate(chosen, kids, default_cost_model(catalog))["n"] == 2 * 128
