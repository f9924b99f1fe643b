"""The port's CRT metric (``repro_torch.core.crt``) against ``repro.core.crt``.

``z_score`` must be ``jax.scipy.special.ndtri``'s float32 value exactly:
the accountant's budget is ``floor(crt_rounds)``, so one ulp of z can move
it by one observation. ``torch.special.ndtri`` and scipy's float64 ``ndtri``
rounded to float32 differ from it at some confidences (0.95, 0.99, 0.8),
which is why the port reproduces JAX's float32 operations. ``sigma_s2``,
``crt_rounds``, the accountant's budgets and the Monte-Carlo attacker are
compared for every noise strategy under both additions. Every comparison
is exact.
"""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.scipy.special import ndtri as jndtri  # noqa: E402

from repro.core import crt as jcrt  # noqa: E402
from repro.core import noise as jnoise  # noqa: E402
from repro.service import PrivacyAccountant as JAccountant  # noqa: E402
from repro_torch.core import crt, threefry  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.service import PrivacyAccountant  # noqa: E402

CONFIDENCES = [0.5, 0.6, 0.8, 0.9, 0.95, 0.975, 0.99, 0.995, 0.999, 0.9999, 0.99999]


def _strategies():
    """(port, reference) pairs of every noise strategy, at the service's
    default and at the calibrations the reference's tests use."""
    return {
        "shrinkwrap": (tnoise.shrinkwrap_default(), jnoise.shrinkwrap_default()),
        "tlap_sens4": (tnoise.TruncatedLaplace(eps=0.5, sensitivity=4), jnoise.TruncatedLaplace(eps=0.5, sensitivity=4)),
        "tlap_wide": (tnoise.TruncatedLaplace(1.5, 5e-5, 10.0), jnoise.TruncatedLaplace(1.5, 5e-5, 10.0)),
        "beta": (tnoise.BetaNoise(2, 6), jnoise.BetaNoise(2, 6)),
        "beta_half": (tnoise.BetaNoise(1.0, 3.0), jnoise.BetaNoise(1.0, 3.0)),
        "uniform": (tnoise.UniformNoise(), jnoise.UniformNoise()),
        "const": (tnoise.ConstantNoise(0.2), jnoise.ConstantNoise(0.2)),
        "reveal": (tnoise.RevealNoise(), jnoise.RevealNoise()),
        "notrim": (tnoise.NoTrim(), jnoise.NoTrim()),
    }


STRATEGIES = _strategies()
SIZES = [(64, 5), (1000, 50), (8192, 2316), (10000, 500)]


@pytest.mark.parametrize("confidence", CONFIDENCES)
def test_z_score_equals_jax_float32(confidence):
    want = float(jndtri(0.5 + confidence / 2.0))
    assert crt.z_score(confidence) == want == jcrt.z_score(confidence)


def test_ndtri32_equals_jax_over_random_float32():
    """Every branch of the rational approximation: the central one
    (p in (exp(-2), 1 - exp(-2))), the tails with z < 8 and z >= 8, and the
    end points."""
    rng = np.random.default_rng(0)
    ps = np.concatenate([
        rng.random(1500), 1 - rng.random(300) * 1e-3, rng.random(300) * 1e-3,
        rng.random(100) * 1e-30, [0.0, 1.0, 0.5, math.exp(-2.0), 1 - math.exp(-2.0)],
    ]).astype(np.float32)
    want = np.asarray(jndtri(ps), dtype=np.float64)
    got = np.array([crt.ndtri32(float(p)) for p in ps])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", list(STRATEGIES))
@pytest.mark.parametrize("addition", ["sequential", "parallel"])
def test_sigma_and_crt_rounds_equal_the_reference(name, addition):
    port, ref = STRATEGIES[name]
    for n, t in SIZES:
        assert crt.sigma_s2(port, addition, n, t) == jcrt.sigma_s2(ref, addition, n, t)
        for err, conf in ((1.0, 0.999), (5.0, 0.95), (0.01 * n, 0.99)):
            assert crt.crt_rounds(port, addition, n, t, err, conf) == jcrt.crt_rounds(ref, addition, n, t, err, conf)


@pytest.mark.parametrize("name", list(STRATEGIES))
@pytest.mark.parametrize("addition", ["sequential", "parallel"])
def test_accountant_budgets_equal_the_reference(name, addition):
    port, ref = STRATEGIES[name]
    for conf in (0.8, 0.95, 0.99, 0.999):
        a, j = PrivacyAccountant(confidence=conf), JAccountant(confidence=conf)
        for n, t in SIZES:
            assert a.budget_for(port, addition, n, t) == j.budget_for(ref, addition, n, t)


@pytest.mark.parametrize("name", ["shrinkwrap", "tlap_wide", "beta", "uniform", "const"])
@pytest.mark.parametrize("addition", ["sequential", "parallel"])
def test_attacker_estimate_equals_the_reference(name, addition):
    port, ref = STRATEGIES[name]
    got = crt.attacker_estimate(port, addition, 5000, 250, 12, threefry.PRNGKey(3))
    want = jcrt.attacker_estimate(ref, addition, 5000, 250, 12, jax.random.PRNGKey(3))
    assert got == want


# the reference's own checks of the metric (tests/test_crt.py), on the port

def test_z_score_matches_paper():
    assert abs(crt.z_score(0.999) - 3.291) < 1e-3


def test_crt_orderings_match_paper_figures():
    n, t = 1000, 50
    tlap = tnoise.TruncatedLaplace(0.5, 5e-5, 1.0)
    beta_par = crt.crt_rounds(tnoise.BetaNoise(2, 6), "parallel", n, t)
    tlap_par = crt.crt_rounds(tlap, "parallel", n, t)
    tlap_seq = crt.crt_rounds(tlap, "sequential", n, t)
    assert tlap_par > tlap_seq  # Fig. 10a
    assert beta_par > tlap_par  # Fig. 11a


def test_error_margin_collapses_rounds():
    n, t = 10000, 500
    noise = tnoise.TruncatedLaplace(0.5, 5e-5, 1.0)
    r_tight = crt.crt_rounds(noise, "parallel", n, t, err=1.0)
    r_loose = crt.crt_rounds(noise, "parallel", n, t, err=0.01 * n)
    assert r_loose <= max(r_tight / 1000, 1.0)


def test_constant_noise_is_trivially_recoverable():
    assert crt.crt_rounds(tnoise.ConstantNoise(0.2), "sequential", 1000, 100) == 1.0


def test_attacker_simulation_validates_eq1():
    n, t = 5000, 250
    noise = tnoise.TruncatedLaplace(0.5, 5e-5, 10.0)
    r = int(crt.crt_rounds(noise, "sequential", n, t, err=5.0))
    est = crt.attacker_estimate(noise, "sequential", n, t, r, threefry.PRNGKey(0))
    assert est["abs_err"] < 15.0
    assert est == jcrt.attacker_estimate(jnoise.TruncatedLaplace(0.5, 5e-5, 10.0), "sequential", n, t, r,
                                         jax.random.PRNGKey(0))
