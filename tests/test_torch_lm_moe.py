"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe``: the Reflex capacity resizer ``resolve_capacity``
exactly, for all four policies and the mixtral and arctic configs (every
token count from 1 to 65,536 under ``const``, ``full`` and ``reflex_beta``;
under ``reflex_tlap``, whose mean integrates a 200,001-point grid per call
in the reference, every count up to 64 and 60 seeded counts above it);
the router's top-k against ``jax.lax.top_k`` on ties; and ``moe_apply`` on
both dispatch routes (output and aux, ``rtol = atol = 1e-4``), also under a
skewed router that drops assignments."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import moe as jm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402
from torch_lm_parity import TOL, assert_close, configs, to_torch  # noqa: E402

POLICIES = ["const", "full", "reflex_tlap", "reflex_beta"]


def _counts(policy):
    if policy != "reflex_tlap":
        return range(1, 65537)
    rng = np.random.default_rng(7)
    return sorted(set(range(1, 65)) | set(rng.integers(65, 65537, 60).tolist()) | {65536})


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["mixtral_8x7b", "arctic_480b"])
def test_resolve_capacity_equals_the_reference(arch, policy):
    jcfg = dataclasses.replace(ref_config(arch), capacity_policy=policy)
    tcfg = dataclasses.replace(get_config(arch), capacity_policy=policy)
    counts = _counts(policy)
    got = [tm.resolve_capacity(tcfg, n) for n in counts]
    assert got == [jm.resolve_capacity(jcfg, n) for n in counts]
    assert all(c % 8 == 0 and c >= 8 for c in got)


def test_resolve_capacity_rejects_an_unknown_policy():
    cfg = dataclasses.replace(get_config("mixtral_8x7b"), capacity_policy="nope")
    with pytest.raises(ValueError):
        tm.resolve_capacity(cfg, 64)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array(
        [[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.3, 0.2, 0.3, 0.2], [0.0, 0.5, 0.5, 0.0]], np.float32
    )
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = tm._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _setup(arch, seed=0, skew=0.0, **changes):
    jcfg, tcfg = configs(arch, **changes)
    jp = jm.moe_init(jax.random.PRNGKey(seed), jcfg)
    if skew:  # with inputs of positive mean, push most tokens toward expert 0
        jp = dict(jp, router=jp["router"].at[:, 0].add(skew))
    return jcfg, tcfg, jp, to_torch(jax.device_get(jp))


# a skew that keeps every routing probability a normal float: XLA flushes
# subnormals to zero (ties, broken toward the lower index), PyTorch does not
@pytest.mark.parametrize("skew", [0.0, 0.1])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ["mixtral_8x7b", "arctic_480b"])
def test_moe_apply_equals_the_reference(arch, impl, skew):
    jcfg, tcfg, jp, tp = _setup(arch, moe_impl=impl, skew=skew)
    x = (np.random.default_rng(1).standard_normal((2, 24, jcfg.d_model)) + 5 * skew).astype(np.float32)
    jy, jaux = jm.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = tm.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert_close(jy, ty, TOL, "y")
    assert_close(jaux, taux, TOL, "aux")
    # the slot bookkeeping is integer and equal
    jr = jm._route(jp, jcfg, jnp.asarray(x.reshape(-1, jcfg.d_model)))
    tr = tm._route(tp, tcfg, torch.from_numpy(x.reshape(-1, jcfg.d_model)))
    np.testing.assert_array_equal(tr[1].numpy(), np.asarray(jr[1]))
    np.testing.assert_array_equal(tr[2].numpy(), np.asarray(jr[2]))
    assert tr[2].dtype == torch.int32 and tr[3] == jr[3]
    dropped = int((tr[2] >= tr[3]).sum())
    assert (dropped > 0) == (skew > 0), dropped


@pytest.mark.parametrize("policy", POLICIES)
def test_moe_routes_agree_under_every_policy(policy):
    # both dispatch routes compute one function, whatever C the policy picks
    _, tcfg, _, tp = _setup("mixtral_8x7b", skew=0.1, capacity_policy=policy)
    x = torch.from_numpy((np.random.default_rng(2).standard_normal((2, 32, tcfg.d_model)) + 0.5).astype(np.float32))
    a, aux_a = tm.moe_apply(tp, tcfg, x)
    b, aux_b = tm.moe_apply(tp, dataclasses.replace(tcfg, moe_impl="gather"), x)
    torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    assert torch.equal(aux_a, aux_b)
