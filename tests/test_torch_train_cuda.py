"""The port's training path on the card against the same on the CPU.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_train_cuda.py

f32 with TF32 off: one train step of each reduced architecture on ``cuda``
equals the same step on ``cpu`` (metrics, parameters and AdamW state,
``max|diff| <= tol * max(1, max|cpu|)`` per leaf, ``tol = 1e-4``, ``5e-3``
for recurrentgemma and xlstm); remat on equals remat off within the same
rule (the card's scatter-adds may sum in any order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import TokenPipeline
from repro_torch.models import init_params
from repro_torch.models.lm import tree_items, tree_map
from repro_torch.train import AdamWConfig, adamw_init, make_train_step

pytestmark = pytest.mark.cuda

RECURRENT = ("recurrentgemma_9b", "xlstm_1_3b")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.set_float32_matmul_precision(precision)


def _close(want: dict, got: dict, tol: float, what: str):
    for (path, w), (_, g) in zip(tree_items(want), tree_items(got)):
        w, g = w.double().cpu(), g.double().cpu()
        assert bool(torch.isfinite(g).all()), f"{what} {path}: non-finite"
        err, scale = float((g - w).abs().max()), max(1.0, float(w.abs().max()))
        assert err <= tol * scale, f"{what} {path}: {err:.3g} > {tol} x {scale:.3g}"


def _step(cfg, dev, seed: int):
    params = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    pipe = TokenPipeline(cfg.vocab_size, 24, 2, seed=seed, d_model=cfg.d_model, mode=cfg.input_mode,
                         n_prefix=cfg.n_prefix)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(0).items()}
    params = tree_map(lambda t: t.to(dev), params)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10))
    return step(params, adamw_init(params), batch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_on_cuda_equals_cpu(cuda, arch):
    cfg = get_config(arch).reduced()
    tol = 5e-3 if arch in RECURRENT else 1e-4
    seed = ARCH_IDS.index(arch)
    on_cpu, on_card = _step(cfg, torch.device("cpu"), seed), _step(cfg, cuda, seed)
    _close(on_cpu[2], on_card[2], tol, f"{arch} metrics")
    _close(on_cpu[0], on_card[0], tol, f"{arch} params")
    _close(on_cpu[1], on_card[1], tol, f"{arch} state")
    assert float(on_card[2]["grad_norm"]) > 0


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "mixtral_8x7b", "xlstm_1_3b"])
def test_remat_on_cuda_equals_remat_off(cuda, arch):
    cfg = get_config(arch).reduced()
    tol = 5e-3 if arch in RECURRENT else 1e-4
    on = _step(dataclasses.replace(cfg, remat=True), cuda, 1)
    off = _step(dataclasses.replace(cfg, remat=False), cuda, 1)
    _close(off[2], on[2], tol, f"{arch} metrics")
    _close(off[0], on[0], tol, f"{arch} params")
    assert np.isfinite(float(on[2]["loss"]))
