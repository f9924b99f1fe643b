"""The port's Waksman routing (``repro_torch.core.waksman``) against
``repro.core.waksman``: the switch counts, the switch settings of random
permutations of every power-of-two size up to 64, and the network's
evaluation (on tensors in the port), exactly; then the reference's own cases
(``tests/test_waksman.py``) and its routing property
(``tests/test_properties.py``) on the port."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from repro.core import waksman as jw  # noqa: E402
from repro_torch.core.waksman import apply_network, n_switches, route  # noqa: E402

SIZES = [1, 2, 4, 8, 16, 32, 64]


@pytest.mark.parametrize("n", SIZES)
def test_routing_equals_the_reference(n):
    rng = np.random.default_rng(100 + n)
    assert n_switches(n) == jw.n_switches(n)
    for _ in range(10):
        perm = rng.permutation(n)
        bits = route(perm)
        assert bits == jw.route(perm)
        payload = rng.integers(0, 2**31, n)
        got = apply_network(bits, torch.from_numpy(payload))
        assert (got.numpy() == jw.apply_network(jw.route(perm), payload)).all()
        # the port's network also moves whole rows
        rows = rng.integers(0, 2**31, (n, 3))
        assert (apply_network(bits, torch.from_numpy(rows)).numpy() == rows[perm]).all()


@pytest.mark.parametrize("n", [2, 4, 8, 16, 64])
def test_route_random_perms(n):
    rng = np.random.default_rng(n)
    for _ in range(10):
        perm = rng.permutation(n)
        out = apply_network(route(perm), torch.arange(n))
        assert (out.numpy() == perm).all()


def test_identity_and_reverse():
    for n in (4, 16):
        ident = torch.arange(n)
        assert (apply_network(route(np.arange(n)), ident) == ident).all()
        rev = np.arange(n)[::-1]
        assert (apply_network(route(rev), ident).numpy() == rev).all()


def test_switch_count_closed_form():
    for m in range(1, 8):
        n = 1 << m
        assert n_switches(n) == n * m - n + 1


def test_route_refuses_sizes_that_are_not_powers_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        route(np.arange(6)[::-1])


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 5), st.integers(0, 2**31 - 1))
def test_property_routing(logn, seed):
    n = 1 << logn
    perm = np.random.default_rng(seed).permutation(n)
    payload = np.random.default_rng(seed + 1).integers(0, 1000, n)
    out = apply_network(route(perm), torch.from_numpy(payload))
    assert (out.numpy() == payload[perm]).all()
    assert route(perm) == jw.route(perm)
