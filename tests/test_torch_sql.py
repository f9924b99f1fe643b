"""The port's SQL front end (``repro_torch.sql``) against repro's: every
golden compiles to the reference's fingerprint and to the port's hand plan;
``compile_query`` places Resizes and picks join algorithms where the
reference does under every placement; ``render_sql`` gives the reference's
text, which compiles back; prepared-statement templates and parameters
agree; bad SQL raises the same ``SqlError`` message at the same position;
and random queries over the HealthLNK catalog compile to the same
fingerprint in both packages. The CLI's ``--check`` runs on the CPU."""
import pytest

pytest.importorskip("jax")

from repro.core import noise as jnoise  # noqa: E402
from repro.data.queries import QUERY_SQL as JSQL  # noqa: E402
from repro.data.queries import all_query_plans as jplans  # noqa: E402
from repro.sql import Catalog as JCatalog  # noqa: E402
from repro.sql import SqlError as JSqlError  # noqa: E402
from repro.sql import bind_params as jbind  # noqa: E402
from repro.sql import compile_logical as jcompile_logical  # noqa: E402
from repro.sql import compile_query as jcompile_query  # noqa: E402
from repro.sql import parse as jparse  # noqa: E402
from repro.sql import plan_params as jparams  # noqa: E402
from repro.sql import render_sql as jrender  # noqa: E402
from repro.sql import template_fingerprint as jtemplate_fp  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.data import DIALECT_QUERIES, QUERY_SQL, all_query_plans, all_query_sql  # noqa: E402
from repro_torch.plan import JoinSortMerge  # noqa: E402
from repro_torch.sql import (  # noqa: E402
    HEALTHLNK_CATALOG,
    Catalog,
    SqlError,
    bind_params,
    compile_logical,
    compile_query,
    parse,
    plan_fingerprint,
    plan_params,
    plan_template,
    render_sql,
    template_fingerprint,
    tokenize,
)

TABLES = {name: list(cols) for name, cols in HEALTHLNK_CATALOG.tables.items()}
SIZES = {"diagnoses": 1000, "medications": 1000, "demographics": 50}
MULT = {"diagnoses": {"pid": 13}, "medications": {"pid": 11}, "demographics": {"pid": 1}}
NOISES = {
    "tlap": lambda m: m.TruncatedLaplace(eps=0.5),
    "beta": lambda m: m.BetaNoise(2, 6),
    "reveal": lambda m: m.RevealNoise(),
    "uniform": lambda m: m.UniformNoise(0.0, 0.5),
}


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def _physical(plan):
    """The node types, and each sort-merge join's (fanout, build)."""
    return [
        (type(n).__name__, getattr(n, "fanout", None), getattr(n, "build", None))
        for n in _walk(plan)
    ]


def test_goldens_are_the_references():
    assert QUERY_SQL == JSQL and all_query_sql() == JSQL
    assert list(all_query_sql()) == list(all_query_plans())
    assert set(DIALECT_QUERIES) < set(QUERY_SQL)


@pytest.mark.parametrize("name", list(QUERY_SQL))
def test_golden_compiles_to_the_reference_fingerprint_and_the_hand_plan(name):
    plan = compile_logical(QUERY_SQL[name])
    assert plan == all_query_plans()[name]
    assert plan_fingerprint(plan) == plan.pretty() == jcompile_logical(JSQL[name]).pretty()
    assert plan_fingerprint(plan) == jplans()[name].pretty()


@pytest.mark.parametrize("placement", ["none", "all_internal", "after_joins", "cost_based"])
@pytest.mark.parametrize("name", list(QUERY_SQL))
def test_compile_query_places_resizes_as_the_reference(name, placement):
    for sizes in (SIZES, {"diagnoses": 8192, "medications": 8192, "demographics": 2048}):
        for mult in (None, MULT):
            catalog, jcatalog = Catalog(TABLES, sizes, mult), JCatalog(TABLES, sizes, mult)
            for noise in NOISES:
                for algo in ("auto", "product", "sortmerge"):
                    plan = compile_query(QUERY_SQL[name], catalog, placement=placement,
                                         noise=NOISES[noise](tnoise), join_algo=algo)
                    jplan = jcompile_query(JSQL[name], jcatalog, placement=placement,
                                           noise=NOISES[noise](jnoise), join_algo=algo)
                    assert plan_fingerprint(plan) == jplan.pretty(), (noise, algo)
                    assert _physical(plan) == _physical(jplan), (noise, algo)


def test_cost_based_placement_is_selective():
    # with the reference's decisions held above, make sure the policy does
    # decide: some golden gets fewer Resizes than all_internal gives it
    counts = {}
    for placement in ("all_internal", "cost_based"):
        counts[placement] = sum(
            plan_fingerprint(compile_query(q, Catalog(TABLES, SIZES), placement=placement,
                                           noise=tnoise.TruncatedLaplace(eps=0.5))).count("Resize")
            for q in QUERY_SQL.values()
        )
    assert 0 < counts["cost_based"] < counts["all_internal"]


def test_compile_query_needs_noise_to_place():
    with pytest.raises(ValueError, match="requires noise"):
        compile_query(QUERY_SQL["dosage_sum"], placement="all_internal")


def test_join_algo_comes_from_the_config():
    from repro_torch import RuntimeConfig

    catalog = Catalog(TABLES, SIZES, MULT)
    for algo in ("product", "sortmerge"):
        plan = compile_query(QUERY_SQL["dosage_study"], catalog, config=RuntimeConfig(join_algo=algo))
        assert any(isinstance(n, JoinSortMerge) for n in _walk(plan)) == (algo == "sortmerge")
    with pytest.raises(ValueError, match="bogus"):
        RuntimeConfig(join_algo="bogus")


@pytest.mark.parametrize("name", list(QUERY_SQL))
def test_render_sql_equals_the_reference_and_round_trips(name):
    plan = compile_logical(QUERY_SQL[name])
    text = render_sql(plan)
    assert text == jrender(jcompile_logical(JSQL[name]))
    assert compile_logical(text) == plan


@pytest.mark.parametrize("name", list(QUERY_SQL))
def test_prepared_statements_equal_the_reference(name):
    plan, jplan = compile_logical(QUERY_SQL[name]), jcompile_logical(JSQL[name])
    params = plan_params(plan)
    assert params == jparams(jplan)
    assert template_fingerprint(plan) == jtemplate_fp(jplan) == plan_fingerprint(plan_template(plan))
    shifted = tuple(p + 1 for p in params)
    assert plan_fingerprint(bind_params(plan, shifted)) == jbind(jplan, shifted).pretty()
    assert bind_params(plan, params) == plan
    if params:
        with pytest.raises(ValueError, match="fewer params"):
            bind_params(plan, params[:-1])
    with pytest.raises(ValueError, match="left over"):
        bind_params(plan, params + (1,))


# the error cases of the reference's own SQL tests, and a few more
BAD_SQL = [
    "SELECT FROM diagnoses",
    "SELECT * FROM nope",
    "SELECT * FROM diagnoses WHERE zzz = 1",
    "SELECT * FROM diagnoses d, medications m WHERE pid = 1",
    "SELECT * FROM diagnoses d, medications m JOIN demographics g ON d.pid = g.pid",
    "SELECT * FROM diagnoses WHERE icd9 <> 1",
    "SELECT * FROM diagnoses WHERE 1 = 2",
    "SELECT * FROM diagnoses d, medications m",
    "SELECT * FROM diagnoses LIMIT 5",
    "SELECT COUNT(icd9) FROM diagnoses",
    "SELECT DISTINCT pid, icd9 FROM diagnoses",
    "SELECT pid, COUNT(*) FROM diagnoses GROUP BY major_icd9",
    "SELECT * FROM diagnoses ORDER BY COUNT(*)",
    "SELECT major_icd9, COUNT(*) FROM diagnoses GROUP BY major_icd9 ORDER BY time DESC",
    "SELECT COUNT(*) FROM diagnoses ORDER BY pid",
    "SELECT * FROM diagnoses WHERE icd9 = ",
    "SELECT * FROM diagnoses d d2 d3",
    "SELECT * FROM diagnoses WHERE d.icd9 = 1",
    "SELECT * FROM diagnoses WHERE icd9 ! 1",
    "SELECT * FROM diagnoses WHERE 12ab = 1",
    "SELECT * FROM diagnoses WHERE icd9 = 1 HAVING COUNT(*) > 1",
    "SELECT major_icd9, AVG(time) FROM diagnoses GROUP BY major_icd9 HAVING AVG(time) > 1",
    "SELECT d.pid FROM diagnoses d JOIN medications m ON d.pid = m.pid AND (d.time < 1 OR m.time < 2)",
]


@pytest.mark.parametrize("sql", BAD_SQL)
def test_sql_errors_equal_the_reference(sql):
    catalog, jcatalog = Catalog(TABLES, SIZES), JCatalog(TABLES, SIZES)
    with pytest.raises(JSqlError) as want:
        jcompile_logical(sql, jcatalog)
    with pytest.raises(SqlError) as got:
        compile_logical(sql, catalog)
    assert str(got.value) == str(want.value)
    assert (got.value.message, got.value.pos) == (want.value.message, want.value.pos)


def test_parse_and_tokenize_equal_the_reference():
    from repro.sql import tokenize as jtokenize

    for sql in list(QUERY_SQL.values()) + ["select distinct x.pid from diagnoses x -- note\n;"]:
        assert [(t.kind, t.value, t.pos) for t in tokenize(sql)] == [
            (t.kind, t.value, t.pos) for t in jtokenize(sql)
        ]
        assert repr(parse(sql)) == repr(jparse(sql))


def test_cli_check_passes_on_the_cpu(capsys):
    from repro_torch.sql.__main__ import main

    assert main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("OK   exec") == len(DIALECT_QUERIES) + 1
    assert "FAIL" not in out


def test_cli_prints_the_plan_and_refuses_explain(capsys, monkeypatch):
    import torch

    from repro_torch.sql.__main__ import main

    sql = QUERY_SQL["dosage_sum"]
    assert main(["--device", "cpu", sql]) == 0
    assert capsys.readouterr().out.strip() == compile_query(sql).pretty()
    # the explain verbs run through the runtime's client since it was ported
    # (their text against the reference's: tests/test_torch_sql_cli.py)
    for flag in ("--explain", "--explain-analyze"):
        assert main([flag, "--device", "cpu", sql]) == 0
        assert capsys.readouterr().out.startswith(f"{flag[2:].upper().replace('-', ' ')} {sql}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([sql])


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover
    st = None

if st is not None:
    _OPS = ["eq", "lt", "le", "gt"]

    @st.composite
    def _leaf(draw, table):
        from repro_torch.ops import Predicate
        from repro_torch.plan import Filter, Scan

        node = Scan(table)
        k = draw(st.integers(0, 2))
        if k:
            cols = TABLES[table]
            node = Filter(node, [Predicate(draw(st.sampled_from(cols)), draw(st.sampled_from(_OPS)),
                                           draw(st.integers(0, 999))) for _ in range(k)])
        return node

    @st.composite
    def _plans(draw):
        from repro_torch.plan import CountDistinct, CountValid, Distinct, GroupByCount, Join, OrderBy

        first = draw(st.sampled_from(list(TABLES)))
        node = draw(_leaf(first))
        for _ in range(draw(st.integers(0, 2))):
            t = draw(st.sampled_from(list(TABLES)))
            theta = None
            if "time" in TABLES[first] and "time" in TABLES[t] and draw(st.booleans()):
                theta = ("time", "le", "time")
            node = Join(node, draw(_leaf(t)), ("pid", "pid"), theta=theta)
        terminal = draw(st.sampled_from(["none", "distinct", "count", "count_distinct", "group"]))
        if terminal == "distinct":
            node = Distinct(node, draw(st.sampled_from(TABLES[first])))
        elif terminal == "count":
            node = CountValid(node)
        elif terminal == "count_distinct":
            node = CountDistinct(node, draw(st.sampled_from(TABLES[first])))
        elif terminal == "group":
            node = GroupByCount(node, draw(st.sampled_from(TABLES[first])))
            if draw(st.booleans()):
                node = OrderBy(node, "cnt", descending=draw(st.booleans()),
                               limit=draw(st.one_of(st.none(), st.integers(1, 20))))
        return node

    @settings(max_examples=60, deadline=None)
    @given(_plans(), st.sampled_from(["none", "all_internal", "cost_based"]))
    def test_random_queries_compile_as_the_reference(plan, placement):
        sql = render_sql(plan)
        assert compile_logical(sql) == plan
        catalog, jcatalog = Catalog(TABLES, SIZES, MULT), JCatalog(TABLES, SIZES, MULT)
        got = compile_query(sql, catalog, placement=placement, noise=tnoise.TruncatedLaplace(eps=0.5))
        want = jcompile_query(sql, jcatalog, placement=placement, noise=jnoise.TruncatedLaplace(eps=0.5))
        assert plan_fingerprint(got) == want.pretty()
        assert _physical(got) == _physical(want)
