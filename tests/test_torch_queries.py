"""CountDistinct plans end to end: ``aspirin_count`` (a theta join, then
COUNT(DISTINCT pid)) and ``three_join`` (three joins, then COUNT(DISTINCT
pid)) through ``Engine.execute`` in the port and in repro, on the reference's
own test data (``tests/test_queries.py``).

The port runs its default configuration, the fused circuit path. repro runs
its default configuration (``use_pallas`` off: its gate-by-gate path), whose
shares and ledger entries are those of its fused path, because both paths
draw the same PRF folds and log the same entries
(``repro/core/circuits.py:23-30``). With UniformNoise and TruncatedLaplace
the output shares, per-node (rounds, bytes/party), every S and ``cnt`` must
be equal (exact); with BetaNoise, which draws its own p in the port, ``cnt``
must equal the plaintext oracle."""
import pytest

jax = pytest.importorskip("jax")

from repro.core import noise as jnoise  # noqa: E402
from repro.core.resizer import ResizerConfig as JConfig  # noqa: E402
from repro.data import all_query_plans  # noqa: E402
from repro.data.healthlnk import generate_healthlnk as jgenerate  # noqa: E402
from repro.data.healthlnk import plaintext_oracle as joracle  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.ops import Predicate as JPredicate  # noqa: E402
from repro.plan import insert_resizers as jinsert  # noqa: E402
from repro.plan import nodes as jnodes  # noqa: E402
from repro_torch import RuntimeConfig  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.resizer import ResizerConfig as TConfig  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.data import aspirin_count_plan, three_join_plan  # noqa: E402
from repro_torch.data.healthlnk import generate_healthlnk as tgenerate  # noqa: E402
from repro_torch.data.healthlnk import plaintext_oracle as toracle  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.ops import Predicate as TPredicate  # noqa: E402
from repro_torch.plan import CountValid, Filter, Scan, insert_resizers  # noqa: E402
from test_torch_slice import _assert_outputs_equal, _assert_reports_equal  # noqa: E402

DATA = dict(n=24, seed=3, aspirin_frac=0.4, icd_heart_frac=0.3)
PLANS = {"aspirin_count": aspirin_count_plan, "three_join": three_join_plan}
NOISE = {
    "uniform": lambda m: m.UniformNoise(0.0, 0.5),
    "tlap": lambda m: m.TruncatedLaplace(eps=0.5),
    "beta": lambda m: m.BetaNoise(2, 6),
}


@pytest.fixture(scope="module")
def data():
    jtables, jplain = jgenerate(**DATA)
    ttables, tplain = tgenerate(**DATA, device="cpu")
    return jtables, jplain, ttables, tplain


def _port_run(ttables, query, placement, noise, config=None):
    plan = insert_resizers(
        PLANS[query](), lambda node: TConfig(noise=NOISE[noise](tnoise)), placement=placement
    )
    return TEngine(ttables, key=threefry.PRNGKey(5), config=config, device="cpu").execute(plan)


def _cnt(out) -> int:
    return int(out.reveal_true_rows()["cnt"][0])


@pytest.mark.parametrize(
    "query,placement,noise",
    [
        ("aspirin_count", "none", "uniform"),
        ("aspirin_count", "all_internal", "uniform"),
        ("aspirin_count", "all_internal", "tlap"),
        ("three_join", "after_joins", "uniform"),
        ("three_join", "after_joins", "tlap"),
    ],
)
def test_count_distinct_plan_matches_reference(data, query, placement, noise):
    jtables, jplain, ttables, tplain = data
    jplan = jinsert(
        all_query_plans()[query], lambda node: JConfig(noise=NOISE[noise](jnoise)), placement=placement
    )
    jout, jrep = JEngine(jtables, key=jax.random.PRNGKey(5)).execute(jplan)
    tout, trep = _port_run(ttables, query, placement, noise)
    assert [s.node for s in trep.nodes] == [s.node for s in jrep.nodes]
    resizes = sum(1 for s in trep.nodes if s.node.startswith("Resize"))
    assert resizes == {"none": 0, "all_internal": 3, "after_joins": 3}[placement]
    _assert_reports_equal(jrep, trep)
    _assert_outputs_equal(jout, tout)
    want = joracle(query, jplain)
    assert toracle(query, tplain) == want
    assert _cnt(tout) == _cnt(jout) == want


def test_count_valid_matches_reference(data):
    # COUNT(*) over a filter: bit2a of the valid column, then a local sum
    jtables, jplain, ttables, _ = data
    jplan = jnodes.CountValid(jnodes.Filter(jnodes.Scan("medications"), [JPredicate("med", "eq", 1)]))
    tplan = CountValid(Filter(Scan("medications"), [TPredicate("med", "eq", 1)]))
    jout, jrep = JEngine(jtables, key=jax.random.PRNGKey(5)).execute(jplan)
    tout, trep = TEngine(ttables, key=threefry.PRNGKey(5), device="cpu").execute(tplan)
    assert [s.node for s in trep.nodes] == ["Scan(medications)", "Filter(med eq 1)", "Count(*)"]
    _assert_reports_equal(jrep, trep)
    _assert_outputs_equal(jout, tout)
    assert _cnt(tout) == int((jplain["medications"]["med"] == 1).sum())


def test_fused_and_gate_by_gate_plans_are_identical(data):
    _, _, ttables, _ = data
    fout, frep = _port_run(ttables, "aspirin_count", "all_internal", "uniform")
    gout, grep = _port_run(
        ttables, "aspirin_count", "all_internal", "uniform", RuntimeConfig(fuse_circuits=False)
    )
    _assert_reports_equal(frep, grep)
    assert (to_numpy(fout.col("cnt").shares) == to_numpy(gout.col("cnt").shares)).all()
    assert (to_numpy(fout.valid.shares) == to_numpy(gout.valid.shares)).all()


@pytest.mark.parametrize("query,placement", [("aspirin_count", "all_internal"), ("three_join", "after_joins")])
def test_beta_noise_count_equals_the_oracle(data, query, placement):
    _, _, ttables, tplain = data
    tout, trep = _port_run(ttables, query, placement, "beta")
    assert sum(1 for s in trep.nodes if "s" in s.extra) == 3
    assert _cnt(tout) == toracle(query, tplain)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [16, 200])
def test_vectorised_oracle_equals_the_reference(n, seed):
    # plaintext only: the port's numpy oracle against repro's nested loops,
    # also with half the patients missing from demographics
    _, plain = jgenerate(n=n, seed=seed, aspirin_frac=0.4, icd_heart_frac=0.3)
    for query in all_query_plans():
        assert toracle(query, plain) == joracle(query, plain)
    demo = plain["demographics"]
    half = {**plain, "demographics": {c: v[::2] for c, v in demo.items()}}
    assert toracle("three_join", half) == joracle("three_join", half)
