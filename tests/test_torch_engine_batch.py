"""``Engine.execute_batch``: K structurally identical plans in one engine
pass, against repro's ``execute_batch`` and against the port's own serial
``execute``.

Each stateless node runs once under ``torch.func.vmap`` over the K slots
(the kernels' batch rules fold the slots into one launch on the card; here
the plain versions run under vmap); Resize runs per slot with the counter
``base + i*R + j + 1``. With a power-of-two ``bucket_fn`` the slots' sizes
agree and the plan stays stacked; without one they diverge and the batch
splits. Every slot's output shares, per-node ledger, S (and p) and rows
must equal the reference's slot and a serial run of that query, bit for
bit, and ``last_batch_stats`` must equal the reference's."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import noise as jnoise  # noqa: E402
from repro.core.resizer import ResizerConfig as JConfig  # noqa: E402
from repro.data.queries import QUERY_SQL as JSQL  # noqa: E402
from repro.data import all_query_plans as jplans  # noqa: E402
from repro.data.healthlnk import generate_healthlnk as jgenerate  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.ops import Predicate as JPredicate  # noqa: E402
from repro.ops import SecretTable as JTable  # noqa: E402
from repro.plan import insert_resizers as jinsert  # noqa: E402
from repro.plan import nodes as jnodes  # noqa: E402
from repro.sql import Catalog as JCatalog  # noqa: E402
from repro.sql import compile_query as jcompile  # noqa: E402
from repro_torch import RuntimeConfig  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.resizer import ResizerConfig as TConfig  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.data import QUERY_SQL, all_query_plans  # noqa: E402
from repro_torch.data.healthlnk import generate_healthlnk as tgenerate  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.ops import Predicate as TPredicate  # noqa: E402
from repro_torch.ops import SecretTable as TTable  # noqa: E402
from repro_torch.plan import insert_resizers  # noqa: E402
from repro_torch.plan.registry import plan_batchable  # noqa: E402
from repro_torch.sql import Catalog, compile_query  # noqa: E402
from test_torch_slice import (  # noqa: E402
    _assert_outputs_equal,
    _assert_reports_equal,
    _PortNodes,
    _quickstart_data,
    _quickstart_plan,
)

K = 3
DATA = dict(n=24, seed=3, aspirin_frac=0.4, icd_heart_frac=0.3)


def pow2(s: int) -> int:
    return 1 << max(s - 1, 0).bit_length()


def _quickstart():
    patients, meds = _quickstart_data()
    jtables = {
        "diagnoses": JTable.from_plaintext(patients, jax.random.PRNGKey(0)),
        "medications": JTable.from_plaintext(meds, jax.random.PRNGKey(1)),
    }
    ttables = {
        "diagnoses": TTable.from_plaintext(patients, threefry.PRNGKey(0), device="cpu"),
        "medications": TTable.from_plaintext(meds, threefry.PRNGKey(1), device="cpu"),
    }
    jplan = jinsert(_quickstart_plan(jnodes, JPredicate),
                    lambda node: JConfig(noise=jnoise.BetaNoise(2, 6), addition="parallel"), placement="all_internal")
    tplan = insert_resizers(_quickstart_plan(_PortNodes, TPredicate),
                            lambda node: TConfig(noise=tnoise.BetaNoise(2, 6), addition="parallel"),
                            placement="all_internal")
    return jtables, ttables, jplan, tplan


def _multiplicity(plain):
    return {t: {"pid": int(np.bincount(cols["pid"]).max())} for t, cols in plain.items()}


def _dosage_sortmerge():
    jtables, jplain = jgenerate(**DATA)
    ttables, tplain = tgenerate(**DATA, device="cpu")
    jplan = jcompile(JSQL["dosage_study"], JCatalog.from_tables(jtables, multiplicity=_multiplicity(jplain)),
                     placement="all_internal", noise=jnoise.BetaNoise(2, 6), join_algo="sortmerge")
    tplan = compile_query(QUERY_SQL["dosage_study"], Catalog.from_tables(ttables, multiplicity=_multiplicity(tplain)),
                          placement="all_internal", noise=tnoise.BetaNoise(2, 6),
                          config=RuntimeConfig(join_algo="sortmerge"))
    return jtables, ttables, jplan, tplan


CASES = {"quickstart": _quickstart, "dosage_sortmerge": _dosage_sortmerge}
_SETUP: dict = {}


def _case(name):
    if name not in _SETUP:
        _SETUP[name] = CASES[name]()
    return _SETUP[name]


def _same_tables(a, b) -> bool:
    la, lb = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _ledger(rep):
    return [(s.node, s.n_ins, s.n_out, s.rounds, s.bytes_per_party, s.extra) for s in rep.nodes]


@pytest.mark.parametrize("bucket", ["pow2", "none"])
@pytest.mark.parametrize("case", list(CASES))
def test_batch_matches_reference_and_serial(case, bucket):
    jtables, ttables, jplan, tplan = _case(case)
    bucket_fn = pow2 if bucket == "pow2" else None
    assert plan_batchable(tplan)
    jeng = JEngine(jtables, key=jax.random.PRNGKey(5), bucket_fn=bucket_fn)
    jres = jeng.execute_batch([jplan] * K)
    teng = TEngine(ttables, key=threefry.PRNGKey(5), bucket_fn=bucket_fn, device="cpu")
    tres = teng.execute_batch([tplan] * K)
    assert teng.last_batch_stats == jeng.last_batch_stats
    stats = teng.last_batch_stats
    assert stats["slots"] == K and stats["stacked_nodes"] > 0
    if bucket == "none":
        assert stats["split_nodes"] > 0
    assert teng._resize_ctr == jeng._resize_ctr
    serial = TEngine(ttables, key=threefry.PRNGKey(5), bucket_fn=bucket_fn, device="cpu")
    for (jout, jrep), (tout, trep) in zip(jres, tres):
        _assert_reports_equal(jrep, trep)
        _assert_outputs_equal(jout, tout)
        sout, srep = serial.execute(tplan)
        assert _ledger(srep) == _ledger(trep)
        assert _same_tables(sout, tout)
    assert serial._resize_ctr == teng._resize_ctr


def test_non_batchable_plan_runs_serially():
    jtables, _ = jgenerate(**DATA)
    ttables, _ = tgenerate(**DATA, device="cpu")
    jplan = jinsert(jplans()["aspirin_count"], lambda node: JConfig(noise=jnoise.UniformNoise(0.0, 0.5)))
    tplan = insert_resizers(all_query_plans()["aspirin_count"], lambda node: TConfig(noise=tnoise.UniformNoise(0.0, 0.5)))
    assert not plan_batchable(tplan)
    jeng = JEngine(jtables, key=jax.random.PRNGKey(5))
    jres = jeng.execute_batch([jplan] * 2)
    teng = TEngine(ttables, key=threefry.PRNGKey(5), device="cpu")
    tres = teng.execute_batch([tplan] * 2)
    assert teng.last_batch_stats == jeng.last_batch_stats
    assert teng.last_batch_stats["stacked_nodes"] == 0
    for (jout, jrep), (tout, trep) in zip(jres, tres):
        _assert_reports_equal(jrep, trep)
        _assert_outputs_equal(jout, tout)


def test_resize_counter_skips_the_batch_range_even_on_failure():
    _, ttables, _, tplan = _case("quickstart")
    resizes = 3
    eng = TEngine(ttables, key=threefry.PRNGKey(5), bucket_fn=pow2, device="cpu")
    eng._resize_ctr = 4
    eng.execute_batch([tplan] * K)
    assert eng._resize_ctr == 4 + K * resizes
    calls = []

    def hook(node, info):
        calls.append(info["s"])
        if len(calls) == 2:
            raise RuntimeError("hook failure")

    eng.reveal_hook = hook
    base = eng._resize_ctr
    with pytest.raises(RuntimeError, match="hook failure"):
        eng.execute_batch([tplan] * K)
    assert eng._resize_ctr == base + K * resizes


def test_batch_rejects_different_plans_and_keeps_empty():
    _, ttables, _, tplan = _case("quickstart")
    eng = TEngine(ttables, key=threefry.PRNGKey(5), device="cpu")
    assert eng.execute_batch([]) == []
    other = insert_resizers(_quickstart_plan(_PortNodes, TPredicate),
                            lambda node: TConfig(noise=tnoise.UniformNoise(0.0, 0.5)), placement="all_internal")
    with pytest.raises(ValueError, match="structurally identical"):
        eng.execute_batch([tplan, other])


def test_batch_of_one_is_a_serial_run():
    _, ttables, _, tplan = _case("quickstart")
    a = TEngine(ttables, key=threefry.PRNGKey(5), device="cpu")
    b = TEngine(ttables, key=threefry.PRNGKey(5), device="cpu")
    (out, rep), = a.execute_batch([tplan])
    sout, srep = b.execute(tplan)
    assert _ledger(rep) == _ledger(srep)
    assert (to_numpy(out.valid.shares) == to_numpy(sout.valid.shares)).all()
    assert a.last_batch_stats["stacked_nodes"] == 0 and a.last_batch_stats["slots"] == 1
