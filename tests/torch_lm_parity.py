"""Shared helpers of the LM side's parity tests (``tests/test_torch_lm_*.py``):
one architecture's config, parameters and inputs in both packages, made from
numpy seeds, and tree comparisons. Parameters are JAX's, carried across with
``repro_torch.interop.params_from_numpy``.

Tolerances (f32 reduced configs): ``rtol = atol = 1e-4`` for the attention,
dense and MoE families; ``5e-3`` for the recurrent ones (recurrentgemma,
xlstm), the reference's own RG-LRU decode tolerance: the associative scan,
the sLSTM loop and the mLSTM's stabilised divisions reassociate in the last
bits, which depth amplifies.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.interop import caches_to_numpy, params_from_numpy
from repro_torch.models.lm import tree_items

TOL = 1e-4
RECURRENT_TOL = 5e-3
RECURRENT = ("recurrentgemma_9b", "xlstm_1_3b")


def tol(arch: str) -> float:
    return RECURRENT_TOL if arch in RECURRENT else TOL


def configs(arch: str, **changes):
    """The reduced config of ``arch`` in both packages, with ``changes``."""
    jcfg = dataclasses.replace(ref_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def params(jcfg, seed: int):
    """JAX's parameters for ``jcfg`` and the same arrays as the port's tree
    (made once per process: the entry points do not modify them)."""
    jp = ref_init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.device_get(jp), "cpu")



def batch(cfg, rng, b: int = 2, s: int = 20, labels: bool = False) -> dict:
    """A numpy batch of ``s`` positions: tokens, or embeddings (musicgen), or
    an image prefix of ``cfg.n_prefix`` embeddings and ``s - n_prefix``
    tokens (paligemma)."""
    out = {}
    n_tok = s
    if cfg.input_mode == "embeddings":
        n_emb = cfg.n_prefix if cfg.prefix_lm and cfg.n_prefix else s
        out["embeds"] = rng.standard_normal((b, n_emb, cfg.d_model)).astype(np.float32)
        n_tok = s - n_emb
    if n_tok:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, n_tok)).astype(np.int32)
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (b, n_tok or s)).astype(np.int32)
        lab[:, ::5] = -1  # masked positions
        out["labels"] = lab
    return out


def step_input(cfg, rng, b: int = 2) -> dict:
    """One decode step's input: a token, or a frame embedding (musicgen)."""
    if cfg.input_mode == "embeddings" and not (cfg.prefix_lm and cfg.n_prefix):
        return {"embeds": rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def leaves(jtree) -> dict:
    """A JAX tree of nested dicts as {dotted path: numpy array}."""
    return dict(tree_items(jax.device_get(jtree)))


def assert_close(jx, tx, tol_: float, what: str = ""):
    got = tx.detach().cpu().float().numpy() if isinstance(tx, torch.Tensor) else np.asarray(tx)
    want = np.asarray(jnp.asarray(jx, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol_, atol=tol_, err_msg=what)


def assert_tree_close(jtree, ttree, tol_: float, what: str = ""):
    """Same paths, shapes and dtypes; values within ``tol_`` (integer leaves
    exactly)."""
    want = leaves(jtree)
    got = dict(tree_items(caches_to_numpy(ttree)))
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path, g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(
                g.astype(np.float32), w.astype(np.float32), rtol=tol_, atol=tol_, err_msg=f"{what} {path}"
            )


def assert_leaves_close(jtree, ttree, tol_: float, what: str = ""):
    """Same paths, shapes and dtypes; per leaf ``max|got - want| <= tol_ *
    max(1, max|want|)`` (the training tests' rule: a gradient leaf is judged
    against its own scale); integer leaves exactly."""
    want = leaves(jtree)
    got = dict(tree_items(caches_to_numpy(ttree)))
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path, g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")
            continue
        w64, g64 = w.astype(np.float64), g.astype(np.float64)
        assert np.isfinite(g64).all(), f"{what} {path}: non-finite"
        err, scale = float(np.abs(g64 - w64).max(initial=0.0)), max(1.0, float(np.abs(w64).max(initial=0.0)))
        assert err <= tol_ * scale, f"{what} {path}: max |diff| {err:.3g} > {tol_:g} x {scale:.3g}"


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(jcfg):
    """``jax.value_and_grad`` of the reference's ``loss_fn`` (jitted once per
    config and process)."""
    from repro.models import loss_fn as ref_loss_fn

    return jax.jit(jax.value_and_grad(lambda p, b: ref_loss_fn(jcfg, p, b), has_aux=True))


def check_grads_against_reference(jcfg, tcfg, jp, tp, tol_: float, seed: int = 1):
    """The port's ``loss_fn`` total, parts and every gradient leaf against
    ``jax.value_and_grad`` of the reference's, on a batch with masked labels
    (seeded by ``seed``); ``tp`` is left as it was. Returns the port's
    gradient tree."""
    from repro_torch.train.train_step import loss_and_grads

    b = batch(jcfg, np.random.default_rng(seed), s=24, labels=True)
    (jl, jparts), jg = jax_value_and_grad(jcfg)(jp, to_jax(b))
    tl, tparts, tg = loss_and_grads(tcfg, tp, to_torch(b))
    assert_close(jl, tl, tol_, "loss")
    for k in ("ce", "aux"):
        assert_close(jparts[k], tparts[k], tol_, k)
    assert_leaves_close(jg, tg, tol_, f"{tcfg.name} grads")
    assert not any(t.requires_grad for _, t in tree_items(tp))
    return tg


def check_loss_and_grads(arch: str, **changes):
    """:func:`check_grads_against_reference` for ``arch``'s reduced config
    (with ``changes``) on JAX's parameters of seed 0."""
    jcfg, tcfg = configs(arch, **changes)
    jp, tp = params(jcfg, 0)
    return check_grads_against_reference(jcfg, tcfg, jp, tp, tol(arch))


def check_remat(arch: str):
    """Loss, parts and gradients with ``remat`` on equal them with it off,
    bit for bit."""
    from repro_torch.train.train_step import loss_and_grads

    jcfg, tcfg = configs(arch)
    _, tp = params(jcfg, 0)
    tb = to_torch(batch(tcfg, np.random.default_rng(2), s=24, labels=True))
    l_on, parts_on, g_on = loss_and_grads(dataclasses.replace(tcfg, remat=True), tp, tb)
    l_off, parts_off, g_off = loss_and_grads(dataclasses.replace(tcfg, remat=False), tp, tb)
    assert torch.equal(l_on, l_off) and all(torch.equal(parts_on[k], parts_off[k]) for k in parts_on)
    for (path, a), (_, b) in zip(tree_items(g_on), tree_items(g_off)):
        assert torch.equal(a, b), path
