import os

import jax
import pytest

# NOTE: no XLA_FLAGS device-count override here — smoke tests and benches see
# the single real CPU device. Only launch/dryrun.py forces 512 host devices.

# Hypothesis profiles for the property suites (tests/test_properties.py,
# tests/test_sql_properties.py). The CI nightly job selects the fixed
# derandomized profile via HYPOTHESIS_PROFILE=nightly, so a red nightly run
# reproduces locally with the same examples; everywhere else the default
# profile keeps the quick randomized search.
try:
    from hypothesis import settings as _hyp_settings

    _hyp_settings.register_profile(
        "nightly", derandomize=True, max_examples=200, deadline=None
    )
    _hyp_settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "default"))
except ImportError:  # tier-1 runs without hypothesis installed
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one"
    )


@pytest.fixture(scope="session")
def prf():
    from repro.core.prf import setup_prf

    return setup_prf(jax.random.PRNGKey(1))


@pytest.fixture()
def key():
    return jax.random.PRNGKey(42)
