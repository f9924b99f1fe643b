"""The slice as a whole: Filter -> Resize -> Join -> Resize -> Distinct through
``Engine.execute`` in the port and in repro, from the same plaintext and keys.
Per-node (rounds, bytes/party), every Resize's S, the output share triples
and the revealed rows must be equal (exact), and the rows must equal the
plaintext oracle."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import noise as jnoise  # noqa: E402
from repro.core.resizer import ResizerConfig as JConfig  # noqa: E402
from repro.data.healthlnk import generate_healthlnk as jgenerate  # noqa: E402
from repro.data.healthlnk import plaintext_oracle as joracle  # noqa: E402
from repro.data.queries import dosage_study_plan as jdosage_plan  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.ops import Predicate as JPredicate  # noqa: E402
from repro.ops import SecretTable as JTable  # noqa: E402
from repro.plan import insert_resizers as jinsert  # noqa: E402
from repro.plan import nodes as jnodes  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.resizer import ResizerConfig as TConfig  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.data.healthlnk import generate_healthlnk as tgenerate  # noqa: E402
from repro_torch.data.healthlnk import plaintext_oracle as toracle  # noqa: E402
from repro_torch.data.queries import dosage_study_plan as tdosage_plan  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.ops import Predicate as TPredicate  # noqa: E402
from repro_torch.ops import SecretTable as TTable  # noqa: E402
from repro_torch.plan import Distinct, Filter, Join, Scan, insert_resizers  # noqa: E402


def _quickstart_data(n=48):
    """examples/quickstart.py's tables."""
    rng = np.random.default_rng(7)
    patients = {
        "pid": rng.integers(0, 12, n).astype(np.uint32),
        "icd9": rng.choice([390, 401, 414], n).astype(np.uint32),
    }
    meds = {
        "pid2": rng.integers(0, 12, n).astype(np.uint32),
        "med": rng.choice([1, 2, 3], n).astype(np.uint32),
    }
    return patients, meds


def _quickstart_plan(nodes, predicate):
    return nodes.Distinct(
        nodes.Join(
            nodes.Filter(nodes.Scan("diagnoses"), [predicate("icd9", "eq", 414)]),
            nodes.Filter(nodes.Scan("medications"), [predicate("med", "eq", 1)]),
            ("pid", "pid2"),
        ),
        "pid",
    )


class _PortNodes:
    Distinct, Join, Filter, Scan = Distinct, Join, Filter, Scan


def _assert_reports_equal(jrep, trep):
    jrows = [(s.node, s.n_ins, s.n_out, s.rounds, s.bytes_per_party, s.extra.get("s")) for s in jrep.nodes]
    trows = [(s.node, s.n_ins, s.n_out, s.rounds, s.bytes_per_party, s.extra.get("s")) for s in trep.nodes]
    assert jrows == trows
    for js_, ts_ in zip(jrep.nodes, trep.nodes):
        if "s" in js_.extra:
            assert js_.extra == ts_.extra


def _assert_outputs_equal(jout, tout):
    assert list(jout.cols) == list(tout.cols)
    for name in jout.cols:
        assert (np.asarray(jout.col(name).shares) == to_numpy(tout.col(name).shares)).all(), name
    assert (np.asarray(jout.valid.shares) == to_numpy(tout.valid.shares)).all()
    jrows, trows = jout.reveal_true_rows(), tout.reveal_true_rows()
    for name in jrows:
        assert (np.asarray(jrows[name]) == trows[name]).all(), name


@pytest.mark.parametrize("noise", ["uniform", "tlap"])
def test_quickstart_plan_matches_reference(noise):
    patients, meds = _quickstart_data()
    make = {"uniform": lambda m: m.UniformNoise(0.0, 0.5), "tlap": lambda m: m.TruncatedLaplace(eps=0.5)}[noise]

    jtables = {
        "diagnoses": JTable.from_plaintext(patients, jax.random.PRNGKey(0)),
        "medications": JTable.from_plaintext(meds, jax.random.PRNGKey(1)),
    }
    jplan = jinsert(_quickstart_plan(jnodes, JPredicate),
                    lambda node: JConfig(noise=make(jnoise), addition="parallel"), placement="all_internal")
    jout, jrep = JEngine(jtables, key=jax.random.PRNGKey(42)).execute(jplan)

    ttables = {
        "diagnoses": TTable.from_plaintext(patients, threefry.PRNGKey(0), device="cpu"),
        "medications": TTable.from_plaintext(meds, threefry.PRNGKey(1), device="cpu"),
    }
    tplan = insert_resizers(_quickstart_plan(_PortNodes, TPredicate),
                            lambda node: TConfig(noise=make(tnoise), addition="parallel"), placement="all_internal")
    tout, trep = TEngine(ttables, key=threefry.PRNGKey(42), device="cpu").execute(tplan)

    assert [s.node for s in trep.nodes].count("Resize[" + TConfig(make(tnoise)).describe() + "]") == 3
    _assert_reports_equal(jrep, trep)
    _assert_outputs_equal(jout, tout)
    want = sorted(set(np.intersect1d(patients["pid"][patients["icd9"] == 414], meds["pid2"][meds["med"] == 1]).tolist()))
    assert sorted(set(tout.reveal_true_rows()["pid"].tolist())) == want == [1, 2, 4, 6, 8, 9, 11]


def test_dosage_study_matches_reference():
    jtables, jplain = jgenerate(n=16)
    ttables, tplain = tgenerate(n=16, device="cpu")
    for name in jplain:
        for col in jplain[name]:
            assert (jplain[name][col] == tplain[name][col]).all()
    for name in jtables:
        _assert_outputs_equal(jtables[name], ttables[name])

    jplan = jinsert(jdosage_plan(), lambda node: JConfig(noise=jnoise.UniformNoise(0.0, 0.5)))
    tplan = insert_resizers(tdosage_plan(), lambda node: TConfig(noise=tnoise.UniformNoise(0.0, 0.5)))
    jout, jrep = JEngine(jtables, key=jax.random.PRNGKey(5)).execute(jplan)
    tout, trep = TEngine(ttables, key=threefry.PRNGKey(5), device="cpu").execute(tplan)
    _assert_reports_equal(jrep, trep)
    _assert_outputs_equal(jout, tout)
    want = joracle("dosage_study", jplain)
    assert want == toracle("dosage_study", tplain)
    assert sorted(set(tout.reveal_true_rows()["pid"].tolist())) == want


def test_beta_noise_rows_equal_the_oracle():
    # BetaNoise draws its own p (not jax.random.beta's), so only rows compare
    ttables, tplain = tgenerate(n=24, seed=3, device="cpu")
    tplan = insert_resizers(tdosage_plan(), lambda node: TConfig(noise=tnoise.BetaNoise(2, 6)))
    tout, trep = TEngine(ttables, key=threefry.PRNGKey(1), device="cpu").execute(tplan)
    assert sum(1 for s in trep.nodes if "s" in s.extra) == 3
    assert sorted(set(tout.reveal_true_rows()["pid"].tolist())) == toracle("dosage_study", tplain)
