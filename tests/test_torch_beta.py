"""BetaNoise drawn bit for bit as ``jax.random.beta`` draws it on the CPU.

``repro_torch.core.xla_beta`` ports jax 0.9.0's Beta sampler (two log-gamma
Marsaglia-Tsang loops, normals by ``erf_inv``) with XLA CPU's float32
arithmetic. The port's ``BetaNoise.sample_p`` must equal
``repro.core.noise.BetaNoise.sample_p`` exactly on every key: Beta(2, 6),
the noise of the quickstart plan and of every full-size card run, on 10,000
keys; Beta(0.5, 0.5) (alpha below 1: the boosted branch) and Beta(5, 1) on
1,000 each. The float32 primitives equal XLA's on sampled inputs, and the
quickstart plan, ``dosage_study`` and ``comorbidity`` under BetaNoise(2, 6)
equal repro in shares, per-node ledger, S (and p) and rows on both circuit
paths."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import noise as jnoise  # noqa: E402
from repro.core.resizer import ResizerConfig as JConfig  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.ops import Predicate as JPredicate  # noqa: E402
from repro.ops import SecretTable as JTable  # noqa: E402
from repro.plan import insert_resizers as jinsert  # noqa: E402
from repro.plan import nodes as jnodes  # noqa: E402
from repro_torch import RuntimeConfig  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry, xla_beta  # noqa: E402
from repro_torch.core.resizer import ResizerConfig as TConfig  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.ops import Predicate as TPredicate  # noqa: E402
from repro_torch.ops import SecretTable as TTable  # noqa: E402
from repro_torch.plan import insert_resizers  # noqa: E402
from test_torch_dialect import check_golden, data  # noqa: E402,F401
from test_torch_slice import (  # noqa: E402
    _assert_outputs_equal,
    _assert_reports_equal,
    _PortNodes,
    _quickstart_data,
    _quickstart_plan,
)


def _bits(x: float) -> int:
    return int(np.float32(x).view(np.uint32))


@pytest.mark.parametrize("alpha,beta,keys", [(2.0, 6.0, 10_000), (0.5, 0.5, 1_000), (5.0, 1.0, 1_000)])
def test_sample_p_equals_jax_random_beta(alpha, beta, keys):
    jbeta, tbeta = jnoise.BetaNoise(alpha, beta), tnoise.BetaNoise(alpha, beta)
    jbase, tbase = jax.random.PRNGKey(0), threefry.PRNGKey(0)
    differ = []
    for i in range(keys):
        want = jbeta.sample_p(jax.random.fold_in(jbase, i), 100, 10)
        got = tbeta.sample_p(threefry.fold_in(tbase, i), 100, 10)
        if _bits(want) != _bits(got):
            differ.append((i, want, got))
    assert not differ, differ[:5]


def _patterns(rng, lo, hi, n):
    return rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize(
    "name,port,ref,lo,hi",
    [
        ("log", xla_beta.log32, jnp.log, 0, 1 << 32),
        ("log1p", xla_beta.log1p32, jnp.log1p, 0, 1 << 32),
        ("exp", xla_beta.exp32, jnp.exp, 0, 1 << 32),
        ("rsqrt", xla_beta.rsqrt32, jax.lax.rsqrt, 0x00800000, 0x7F800000),
        ("erf_inv", xla_beta.erf_inv32, jax.lax.erf_inv, 0xBF000000, 0xBF800000),
        ("erf_inv", xla_beta.erf_inv32, jax.lax.erf_inv, 0x00000000, 0x3F800000),
    ],
)
def test_float32_primitive_equals_xla(name, port, ref, lo, hi):
    x = _patterns(np.random.default_rng(hash(name) % 1000), lo, hi, 4000)
    want = np.asarray(jax.jit(ref)(jnp.asarray(x)))
    got = np.array([port(float(v)) for v in x], dtype=np.float32)
    same = (want.view(np.uint32) == got.view(np.uint32)) | (np.isnan(want) & np.isnan(got))
    assert same.all(), (x[~same][:4], want[~same][:4], got[~same][:4])


def test_fma_rounds_once():
    # (2^-24 (1 - 2^-23)) (1 + 2^-23) + (1 + 2^-23) = 1 + 2^-23 + 2^-24 - 2^-70
    # lies just below a float32 tie: one rounding gives 1 + 2^-23, while
    # rounding the float64 sum first (onto the tie) would give 1 + 2^-22
    a, b = 2.0**-24 * (1 - 2.0**-23), 1 + 2.0**-23
    assert xla_beta._fma(a, b, 1 + 2.0**-23) == 1 + 2.0**-23
    assert xla_beta._fma(-a, b, -(1 + 2.0**-23)) == -(1 + 2.0**-23)
    assert xla_beta._fma(1.0, 1.0, 2.0**-24) == 1.0  # an exact tie goes to even


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gates"])
def test_quickstart_plan_under_beta_matches_reference(fused):
    patients, meds = _quickstart_data()
    jtables = {
        "diagnoses": JTable.from_plaintext(patients, jax.random.PRNGKey(0)),
        "medications": JTable.from_plaintext(meds, jax.random.PRNGKey(1)),
    }
    jplan = jinsert(_quickstart_plan(jnodes, JPredicate),
                    lambda node: JConfig(noise=jnoise.BetaNoise(2, 6), addition="parallel"), placement="all_internal")
    jout, jrep = JEngine(jtables, key=jax.random.PRNGKey(42)).execute(jplan)
    ttables = {
        "diagnoses": TTable.from_plaintext(patients, threefry.PRNGKey(0), device="cpu"),
        "medications": TTable.from_plaintext(meds, threefry.PRNGKey(1), device="cpu"),
    }
    tplan = insert_resizers(_quickstart_plan(_PortNodes, TPredicate),
                            lambda node: TConfig(noise=tnoise.BetaNoise(2, 6), addition="parallel"),
                            placement="all_internal")
    engine = TEngine(ttables, key=threefry.PRNGKey(42), config=RuntimeConfig(fuse_circuits=fused), device="cpu")
    tout, trep = engine.execute(tplan)
    assert sum(1 for s in trep.nodes if "p" in s.extra) == 3
    _assert_reports_equal(jrep, trep)
    _assert_outputs_equal(jout, tout)
    assert sorted(set(tout.reveal_true_rows()["pid"].tolist())) == [1, 2, 4, 6, 8, 9, 11]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gates"])
@pytest.mark.parametrize("query", ["dosage_study", "comorbidity"])
def test_golden_under_beta_matches_reference(data, query, fused):  # noqa: F811
    check_golden(data, query, "all_internal", "beta", fused)
