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
