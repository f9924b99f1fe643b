"""The HealthLNK goldens (``repro.data.all_query_plans()``) through
``Engine.execute`` in the port and in repro, on the reference's own test
data (``tests/test_queries.py``): placements ``none`` and ``all_internal``,
and ``after_joins`` for the join goldens, with UniformNoise and
TruncatedLaplace Resizers, on the port's fused and gate-by-gate circuit
paths. Output shares, per-node (rounds, bytes/party), every S and the
revealed rows must be equal (exact: all values are ring words), and the
answer must equal the plaintext oracle. With BetaNoise, which the port draws
itself, only the answer is compared with the oracle. The AVG goldens'
``post_reveal`` hooks must equal the reference's on the same rows.

This file runs comorbidity and the ten dialect goldens; the three paper
goldens with joins (``dosage_study``, ``aspirin_count``, ``three_join``) run
through :func:`check_golden` in ``tests/test_torch_join_goldens.py``, so
that the two halves of the reference's compile time fall on two test
workers."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import noise as jnoise  # noqa: E402
from repro.core.resizer import ResizerConfig as JConfig  # noqa: E402
from repro.data import all_query_plans as jplans  # noqa: E402
from repro.data.healthlnk import generate_healthlnk as jgenerate  # noqa: E402
from repro.data.healthlnk import plaintext_oracle as joracle  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.plan import insert_resizers as jinsert  # noqa: E402
from repro.plan.registry import lookup as jlookup  # noqa: E402
from repro_torch import RuntimeConfig  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.resizer import ResizerConfig as TConfig  # noqa: E402
from repro_torch.data import all_query_plans, revealed_answer  # noqa: E402
from repro_torch.data.healthlnk import generate_healthlnk as tgenerate  # noqa: E402
from repro_torch.data.healthlnk import plaintext_oracle as toracle  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.plan import insert_resizers  # noqa: E402
from repro_torch.plan.registry import lookup  # noqa: E402
from test_torch_slice import _assert_outputs_equal, _assert_reports_equal  # noqa: E402

DATA = dict(n=24, seed=3, aspirin_frac=0.4, icd_heart_frac=0.3)
PAPER_JOIN_QUERIES = ("dosage_study", "aspirin_count", "three_join")
QUERIES = [q for q in all_query_plans() if q not in PAPER_JOIN_QUERIES]
NOISE = {
    "uniform": lambda m: m.UniformNoise(0.0, 0.5),
    "tlap": lambda m: m.TruncatedLaplace(eps=0.5),
    "beta": lambda m: m.BetaNoise(2, 6),
}


def cases(queries, joins):
    """(query, placement, noise): without Resizers the noise plays no part,
    so one run per golden; ``after_joins`` for the goldens with joins."""
    return (
        [(q, "none", "uniform") for q in queries]
        + [(q, "all_internal", noise) for q in queries for noise in ("uniform", "tlap")]
        + [(q, "after_joins", noise) for q in joins for noise in ("uniform", "tlap")]
    )


CASES = cases(QUERIES, ["projection_join"])
_REFERENCE: dict = {}


@pytest.fixture(scope="module")
def data():
    jtables, jplain = jgenerate(**DATA)
    ttables, tplain = tgenerate(**DATA, device="cpu")
    return jtables, jplain, ttables, tplain


def _reference(jtables, query, placement, noise):
    """repro's run of a case, shared by the port's two circuit paths."""
    case = (query, placement, noise)
    if case not in _REFERENCE:
        plan = jinsert(jplans()[query], lambda node: JConfig(noise=NOISE[noise](jnoise)), placement=placement)
        _REFERENCE[case] = JEngine(jtables, key=jax.random.PRNGKey(5)).execute(plan)
    return _REFERENCE[case]


def _port(ttables, query, placement, noise, fused=True):
    plan = insert_resizers(
        all_query_plans()[query], lambda node: TConfig(noise=NOISE[noise](tnoise)), placement=placement
    )
    engine = TEngine(ttables, key=threefry.PRNGKey(5), config=RuntimeConfig(fuse_circuits=fused), device="cpu")
    return plan, *engine.execute(plan)


def check_golden(data, query, placement, noise, fused):
    """One case against repro's run of it and against the oracle."""
    jtables, jplain, ttables, tplain = data
    jout, jrep = _reference(jtables, query, placement, noise)
    plan, tout, trep = _port(ttables, query, placement, noise, fused)
    assert [s.node for s in trep.nodes] == [s.node for s in jrep.nodes]
    _assert_reports_equal(jrep, trep)
    _assert_outputs_equal(jout, tout)
    want = joracle(query, jplain)
    assert toracle(query, tplain) == want
    assert revealed_answer(query, plan, tout) == want


def test_plans_describe_as_the_reference():
    assert list(all_query_plans()) == list(jplans())
    for q in jplans():
        assert all_query_plans()[q].describe() == jplans()[q].describe()
        placed = insert_resizers(all_query_plans()[q], lambda node: TConfig(noise=tnoise.UniformNoise(0.0, 0.5)))
        jplaced = jinsert(jplans()[q], lambda node: JConfig(noise=jnoise.UniformNoise(0.0, 0.5)))
        assert placed.describe() == jplaced.describe()


def test_operator_flags_equal_the_reference():
    # every node type of the goldens: placement hint, ballooning, 1-row
    # output, and whether a post_reveal hook exists
    def walk(node):
        yield node
        for c in node.children():
            yield from walk(c)

    seen = {}
    for q in jplans():
        for tnode, jnode in zip(walk(all_query_plans()[q]), walk(jplans()[q])):
            seen[type(tnode)] = type(jnode)
    assert len(seen) == 16
    for ttype, jtype in seen.items():
        td, jd = lookup(ttype), jlookup(jtype)
        assert ttype.__name__ == jtype.__name__
        assert (td.resizer, td.balloons, td.singleton) == (jd.resizer, jd.balloons, jd.singleton), ttype
        assert (td.post_reveal is None) == (jd.post_reveal is None), ttype


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gates"])
@pytest.mark.parametrize("query,placement,noise", CASES)
def test_golden_matches_reference(data, query, placement, noise, fused):
    check_golden(data, query, placement, noise, fused)


@pytest.mark.parametrize("query", list(all_query_plans()))
def test_beta_noise_answer_equals_the_oracle(data, query):
    _, _, ttables, tplain = data
    plan, tout, trep = _port(ttables, query, "all_internal", "beta")
    assert revealed_answer(query, plan, tout) == toracle(query, tplain)


@pytest.mark.parametrize("query", ["dosage_avg", "med_dosage_avg"])
def test_post_reveal_equals_the_reference(data, query):
    _, _, ttables, _ = data
    plan, tout, _ = _port(ttables, query, "all_internal", "uniform")
    rows = tout.reveal_true_rows()
    jplan = jplans()[query]
    got = lookup(type(plan)).post_reveal(plan, dict(rows))
    want = jlookup(type(jplan)).post_reveal(jplan, dict(rows))
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
