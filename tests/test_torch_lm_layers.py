"""The port's shared layers (``repro_torch.models.layers``) against
``repro.models.layers`` on the same numpy inputs: both norms, RoPE at
rotary fractions 1.0 and 0.25, and the swiglu and gelu FFNs, in f32
(``rtol = atol = 1e-4``) and in bf16 (the bf16 compute path: inputs and
weights cast as the reference casts them; ``2e-2``, a few bf16 ulps of
values of order 1). Then the interop tree conversions, both ways."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.interop import caches_from_numpy, caches_to_numpy, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL), "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _pair(a, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(j, t, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_equals_the_reference(kind, dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 48)) * 3 + 0.5).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = tl.apply_norm({"scale": torch.from_numpy(scale)}, tx, kind)
    want = jl.apply_norm({"scale": jnp.asarray(scale)}, jx, kind)
    assert got.dtype == DTYPES[dtype][1]
    _close(want, got, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_rope_equals_the_reference(fraction, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 33, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(33, dtype=np.int32) * 97, (2, 33)).copy()
    jx, tx = _pair(x, dtype)
    got = tl.rope(tx, torch.from_numpy(pos), 10000.0, fraction)
    want = jl.rope(jx, jnp.asarray(pos), 10000.0, fraction)
    _close(want, got, DTYPES[dtype][2])
    if fraction < 1.0:  # the tail past the rotary dims passes through
        assert torch.equal(got[..., 8:], tx[..., 8:])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_equals_the_reference(kind, dtype):
    rng = np.random.default_rng(3)
    p = jl.mlp_init(jax.random.PRNGKey(4), 40, 72, kind)
    x = rng.standard_normal((2, 9, 40)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = tl.apply_mlp(params_from_numpy(jax.device_get(p), "cpu"), tx, kind)
    want = jl.apply_mlp(p, jx, kind)
    _close(want, got, DTYPES[dtype][2])


def test_interop_trees_round_trip():
    import ml_dtypes

    rng = np.random.default_rng(5)
    tree = {
        "a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
        "idx": np.array([3, 5], np.int32),
        "k": rng.integers(-127, 128, (2, 4, 1, 8)).astype(np.int8),
        "k_scale": rng.standard_normal((2, 4, 1)).astype(ml_dtypes.bfloat16),
    }
    for there, back in ((params_from_numpy, params_to_numpy), (caches_from_numpy, caches_to_numpy)):
        got = there(tree, "cpu")
        assert got["k_scale"].dtype == torch.bfloat16 and got["k"].dtype == torch.int8
        assert got["idx"].dtype == torch.int32 and got["a"]["w"].dtype == torch.float32
        again = back(got)
        for path in ("idx", "k", "k_scale"):
            assert again[path].dtype == tree[path].dtype
            np.testing.assert_array_equal(again[path].view(np.uint8), tree[path].view(np.uint8))
        np.testing.assert_array_equal(again["a"]["w"], tree["a"]["w"])
