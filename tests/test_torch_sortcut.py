"""Sort&cut, the paper's Shrinkwrap baseline (``ResizerConfig(use_sort=True)``),
in the port against repro, and the sort helper it rests on.

The Resizer alone, on a table carried over from repro: the bench's
``TruncatedLaplace`` with sequential addition and ``UniformNoise`` with
parallel addition, on the port's fused and gate-by-gate paths, against
repro's default path (whose shares and ledger its fused path repeats,
``repro/core/circuits.py:23-30``): output shares, ledger entries, S and the
info dict (with the padded ``n``) and the kept rows, exactly. Then whole
plans through ``Engine.execute`` with sort&cut Resizers on every internal
operator (the quickstart plan, ``dosage_study``, ``comorbidity``): shares,
per-node ledger, S and rows; the lazy join's view (materialised, not
deferred); ``sort_valid_first``; and the plan-level surface: ``describe()``,
the plan fingerprint, EXPLAIN and the randomness manifest (inexact)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import ledger as jledger  # noqa: E402
from repro.core import noise as jnoise  # noqa: E402
from repro.core import prf as jprf  # noqa: E402
from repro.core.resizer import Resizer as JResizer  # noqa: E402
from repro.core.resizer import ResizerConfig as JConfig  # noqa: E402
from repro.core.sharing import share_b as jshare_b  # noqa: E402
from repro.core.sort import sort_valid_first as jsort_valid_first  # noqa: E402
from repro.data import all_query_plans as jplans  # noqa: E402
from repro.data.healthlnk import generate_healthlnk as jgenerate  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.obs import explain_text as jexplain  # noqa: E402
from repro.offline import RandomnessPlanner as JPlanner  # noqa: E402
from repro.ops import Predicate as JPredicate  # noqa: E402
from repro.ops import SecretTable as JTable  # noqa: E402
from repro.ops.join import oblivious_join as jjoin  # noqa: E402
from repro.plan import insert_resizers as jinsert  # noqa: E402
from repro.plan import nodes as jnodes  # noqa: E402
from repro.sql.catalog import HEALTHLNK_CATALOG as JCATALOG  # noqa: E402
from repro.sql.compile import plan_fingerprint as jfingerprint  # noqa: E402
from repro_torch import RuntimeConfig  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.resizer import Resizer as TResizer  # noqa: E402
from repro_torch.core.resizer import ResizerConfig as TConfig  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.core.sharing import share_b as tshare_b  # noqa: E402
from repro_torch.core.sort import sort_valid_first  # noqa: E402
from repro_torch.data import all_query_plans as tplans  # noqa: E402
from repro_torch.data.healthlnk import generate_healthlnk as tgenerate  # noqa: E402
from repro_torch.data.healthlnk import plaintext_oracle as toracle  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.interop import key_from_numpy, prf_from_numpy  # noqa: E402
from repro_torch.kernels import override_fusion  # noqa: E402
from repro_torch.obs import explain_text  # noqa: E402
from repro_torch.offline import RandomnessPlanner  # noqa: E402
from repro_torch.ops import Predicate as TPredicate  # noqa: E402
from repro_torch.ops import SecretTable as TTable  # noqa: E402
from repro_torch.ops.join import oblivious_join as tjoin  # noqa: E402
from repro_torch.plan import insert_resizers  # noqa: E402
from repro_torch.plan import nodes as tnodes  # noqa: E402
from repro_torch.sql.catalog import HEALTHLNK_CATALOG  # noqa: E402
from repro_torch.sql.compile import plan_fingerprint  # noqa: E402
from test_torch_resizer import _carry, _entries, _table  # noqa: E402
from test_torch_slice import (  # noqa: E402
    _assert_outputs_equal,
    _assert_reports_equal,
    _PortNodes,
    _quickstart_data,
    _quickstart_plan,
)

# the paper's sort&cut mode (benchmarks/bench_healthlnk.py:38-45): TLap with
# the bench's sensitivity, sequential addition; and a coin-toss variant
MODES = {
    "tlap_sequential": (lambda m, n: m.TruncatedLaplace(eps=0.5, delta=5e-5, sensitivity=max(n // 8, 1)),
                        "sequential"),
    "uniform_parallel": (lambda m, n: m.UniformNoise(0.2, 0.6), "parallel"),
}
PATHS = ("fused", "gates")
# The tables are small enough that every sort&cut Resize below pads to 16
# rows, or to 256 over a join: the reference compiles each circuit and sort
# shape op by op at its first use, and tests that share the shapes share
# those compiles.


def _configs(mode, n):
    make, addition = MODES[mode]
    return (JConfig(noise=make(jnoise, n), addition=addition, use_sort=True),
            TConfig(noise=make(tnoise, n), addition=addition, use_sort=True))


def _resize_both(jt, tt, mode, path, key_seed=3):
    jcfg, tcfg = _configs(mode, jt.n)
    jp = jprf.setup_prf(jax.random.PRNGKey(50 + key_seed))
    tp = prf_from_numpy(np.asarray(jp.pair_keys))
    jkey = jax.random.PRNGKey(key_seed)
    with jledger.CommLedger() as jl:
        jout, jinfo = JResizer(jcfg)(jt, jp, jkey)
    with override_fusion(path == "fused"), tledger.CommLedger() as tl:
        tout, tinfo = TResizer(tcfg)(tt, tp, key_from_numpy(np.asarray(jkey)))
    assert _entries(jl) == _entries(tl)
    assert jinfo == tinfo
    assert list(jout.cols) == list(tout.cols)
    for name in jout.cols:
        assert (np.asarray(jout.col(name).shares) == to_numpy(tout.col(name).shares)).all(), name
    assert (np.asarray(jout.valid.shares) == to_numpy(tout.valid.shares)).all()
    jrows, trows = jout.reveal_true_rows(), tout.reveal_true_rows()
    for name in jrows:
        assert (np.asarray(jrows[name]) == trows[name]).all()
    return tinfo, tl


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mode", list(MODES))
def test_sortcut_resizer_matches_reference(mode, path):
    jt = _table(12, seed=1)
    tt = _carry({"t": jt})["t"]
    info, led = _resize_both(jt, tt, mode, path)
    # padded to the next power of two; the reveal opens every padded row
    assert info["n"] == 16 and info["t"] <= info["s"] <= 12
    assert any(e.op == "reveal_k" and e.bytes_per_party == 16 * 4 for e in led.entries)
    assert not any(e.op == "shuffle_deferred_payload" for e in led.entries)


def test_sortcut_resizer_materializes_the_lazy_join():
    """The counterpart of ``tests/test_lazy_join.py:234``: sort&cut needs
    physical columns, so the join's lazy views are materialised (no deferred
    payload) and the result is the eager join's."""
    jl_, jr_ = _table(5, seed=4, cols=("pid", "a")), _table(3, seed=5, cols=("pid", "b"))
    carried = _carry({"l": jl_, "r": jr_})
    jp = jprf.setup_prf(jax.random.PRNGKey(77))
    tp = prf_from_numpy(np.asarray(jp.pair_keys))
    jj = jjoin(jl_, jr_, ("pid", "pid"), jp, tile=4)
    tj = tjoin(carried["l"], carried["r"], ("pid", "pid"), tp, tile=4)
    info, _ = _resize_both(jj, tj, "uniform_parallel", "fused")
    assert info["n"] == 16
    # the port's join is lazy; a copy with every view materialised is the
    # eager join
    eager = TTable(dict(tj.cols), tj.valid)
    for name in eager.cols:
        eager.col(name)
    _, ecfg = _configs("uniform_parallel", 15)
    key = key_from_numpy(np.asarray(jax.random.PRNGKey(3)))
    lazy_out, lazy_info = TResizer(ecfg)(tj, tp, key)
    eager_out, eager_info = TResizer(ecfg)(eager, tp, key)
    assert lazy_info == eager_info
    lrows, erows = lazy_out.reveal_true_rows(), eager_out.reveal_true_rows()
    for name in erows:
        assert sorted(lrows[name].tolist()) == sorted(erows[name].tolist())


def _plans(query):
    if query == "quickstart":
        return _quickstart_plan(jnodes, JPredicate), _quickstart_plan(_PortNodes, TPredicate)
    return jplans()[query], tplans()[query]


def _tables(query):
    if query == "quickstart":
        patients, meds = _quickstart_data(16)
        jt = {"diagnoses": JTable.from_plaintext(patients, jax.random.PRNGKey(0)),
              "medications": JTable.from_plaintext(meds, jax.random.PRNGKey(1))}
        tt = {"diagnoses": TTable.from_plaintext(patients, threefry.PRNGKey(0), device="cpu"),
              "medications": TTable.from_plaintext(meds, threefry.PRNGKey(1), device="cpu")}
        return jt, tt, None
    jt, jplain = jgenerate(n=16, seed=3, aspirin_frac=0.4, icd_heart_frac=0.3)
    tt, tplain = tgenerate(n=16, seed=3, aspirin_frac=0.4, icd_heart_frac=0.3, device="cpu")
    return jt, tt, tplain


@pytest.mark.parametrize("query,mode", [
    ("quickstart", "tlap_sequential"),
    ("dosage_study", "tlap_sequential"),
    ("comorbidity", "tlap_sequential"),
])
def test_sortcut_plans_match_reference(query, mode):
    jt, tt, tplain = _tables(query)
    jplan, tplan = _plans(query)
    jcfg, tcfg = _configs(mode, 16)
    jplan = jinsert(jplan, lambda node: jcfg, placement="all_internal")
    tplan = insert_resizers(tplan, lambda node: tcfg, placement="all_internal")
    jout, jrep = JEngine(jt, key=jax.random.PRNGKey(5)).execute(jplan)
    outs = []
    for fused in (True, False):
        tout, trep = TEngine(tt, key=threefry.PRNGKey(5), config=RuntimeConfig(fuse_circuits=fused),
                             device="cpu").execute(tplan)
        _assert_reports_equal(jrep, trep)
        _assert_outputs_equal(jout, tout)
        outs.append(tout)
    resizes = [s for s in trep.nodes if s.node.startswith("Resize[")]
    assert resizes and all("sortcut" in s.node for s in resizes)
    assert all(s.extra["n"] & (s.extra["n"] - 1) == 0 for s in resizes if not s.extra.get("skipped"))
    if tplain is not None and query == "dosage_study":
        assert sorted(set(outs[0].reveal_true_rows()["pid"].tolist())) == toracle(query, tplain)


def test_sort_valid_first_matches_reference():
    """The counterpart of ``tests/test_shuffle_sort.py:71``: valid rows come
    first, the shares equal the reference's."""
    rng = np.random.default_rng(0)
    n = 16
    vals = rng.integers(0, 100, n).astype(np.uint32)
    valid = (rng.random(n) < 0.5).astype(np.uint32)
    pay = rng.integers(0, 9, n).astype(np.uint32)
    jp = jprf.setup_prf(jax.random.PRNGKey(1))
    tp = prf_from_numpy(np.asarray(jp.pair_keys))
    jcols = {"v": jshare_b(vals, jax.random.PRNGKey(0)), "valid": jshare_b(valid, jax.random.PRNGKey(1)),
             "p": jshare_b(pay, jax.random.PRNGKey(2))}
    tcols = {"v": tshare_b(vals, threefry.PRNGKey(0), "cpu"), "valid": tshare_b(valid, threefry.PRNGKey(1), "cpu"),
             "p": tshare_b(pay, threefry.PRNGKey(2), "cpu")}
    jout = jsort_valid_first(jcols, "valid", jp)
    for fused in (True, False):
        with override_fusion(fused), tledger.CommLedger() as tl:
            tout = sort_valid_first(tcols, "valid", tp)
        assert list(tout) == list(jout)
        for name in jout:
            assert (np.asarray(jout[name].shares) == to_numpy(tout[name].shares)).all(), name
        opened = {k: to_numpy(v.shares[0] ^ v.shares[1] ^ v.shares[2]) for k, v in tout.items()}
        k = int(valid.sum())
        assert (opened["valid"][:k] == 1).all() and (opened["valid"][k:] == 0).all()
        assert sorted(opened["v"][:k].tolist()) == sorted(vals[valid == 1].tolist())
        assert tl.tally()["rounds"] > 0


def test_sortcut_describe_fingerprint_explain_and_manifest():
    jcfg, tcfg = _configs("tlap_sequential", 64)
    assert tcfg.describe() == jcfg.describe() == "rho(tlap,sortcut)"
    assert TConfig(noise=tnoise.UniformNoise(0.0, 0.5)).describe().endswith(",parallel)")
    jplan = jinsert(jplans()["dosage_study"], lambda node: jcfg, placement="all_internal")
    tplan = insert_resizers(tplans()["dosage_study"], lambda node: tcfg, placement="all_internal")
    assert plan_fingerprint(tplan) == jfingerprint(jplan)
    assert "sortcut" in plan_fingerprint(tplan)
    text = explain_text(tplan, title="dosage_study")
    assert text == jexplain(jplan, title="dosage_study") and "sortcut" in text
    # the manifest: a Resize over a Filter is exact with the shuffle,
    # inexact under sort&cut, as in the reference
    for use_sort in (False, True):
        jresize = jnodes.Resize(jnodes.Filter(jnodes.Scan("diagnoses"), [JPredicate("icd9", "eq", 414)]),
                                JConfig(noise=jcfg.noise, addition="sequential", use_sort=use_sort))
        tresize = tnodes.Resize(tnodes.Filter(tnodes.Scan("diagnoses"), [TPredicate("icd9", "eq", 414)]),
                                TConfig(noise=tcfg.noise, addition="sequential", use_sort=use_sort))
        manifest = RandomnessPlanner(catalog=HEALTHLNK_CATALOG).manifest(tresize)
        jmanifest = JPlanner(catalog=JCATALOG).manifest(jresize)
        assert [vars(nm) for nm in manifest.nodes] == [vars(nm) for nm in jmanifest.nodes]
        assert manifest.exact is jmanifest.exact is (not use_sort)
