"""The port's architecture registry (``repro_torch.configs``, ``models.config``)
against ``repro``'s: every config and its reduced form field by field, the
analytic parameter counts as integers, the abstract parameter tree (paths,
shapes, dtypes) against ``jax.eval_shape``'s and every input spec against
the reference's ``ShapeDtypeStruct``s, all ten architectures at full size.
Then the port's own initializer: its tree equals JAX's, its draws follow the
reference's distributions, it runs on ``cuda`` unless asked otherwise, and
``TransformerLM`` registers the tree under its paths."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.configs as jconfigs  # noqa: E402
from repro.models import abstract_params as ref_abstract_params  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import TransformerLM, abstract_params, init_params  # noqa: E402
from repro_torch.models.lm import tree_items  # noqa: E402

ARCH_IDS = jconfigs.ARCH_IDS


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _shape_tree(tree) -> dict:
    """{path: (shape, dtype name)} of a JAX shape tree or a port tree."""
    if isinstance(next(iter(dict(tree_items(tree)).values())), torch.Tensor):
        return {p: (tuple(t.shape), _dtype_name(t.dtype)) for p, t in tree_items(tree)}
    return {p: (tuple(s.shape), str(np.dtype(s.dtype))) for p, s in tree_items(tree)}


def test_registry_ids_equal():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.SHAPE_NAMES == jconfigs.SHAPE_NAMES
    assert list(tconfigs.all_configs()) == list(jconfigs.all_configs())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_and_aliases_equal_the_reference(arch):
    want = jconfigs.get_config(arch)
    for name in (arch, arch.replace("_", "-"), want.name):
        got = tconfigs.get_config(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(jconfigs.get_config(name))
    got = tconfigs.get_config(arch)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    for cfg, ref in ((got, want), (got.reduced(), want.reduced())):
        assert cfg.resolved_head_dim == ref.resolved_head_dim
        assert cfg.n_groups == ref.n_groups and cfg.pattern_period == ref.pattern_period
        assert [cfg.block_kind(i) for i in range(cfg.n_layers)] == [ref.block_kind(i) for i in range(ref.n_layers)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_the_reference(arch):
    got, want = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert isinstance(got.param_count(), int)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_eval_shape(arch):
    got = abstract_params(tconfigs.get_config(arch))
    assert all(t.device.type == "meta" for _, t in tree_items(got))
    assert _shape_tree(got) == _shape_tree(ref_abstract_params(jconfigs.get_config(arch)))


@pytest.mark.parametrize("shape", jconfigs.SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch, shape):
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert tconfigs.shape_applicable(tcfg, shape) == jconfigs.shape_applicable(jcfg, shape)
    got, want = tconfigs.input_specs(tcfg, shape), jconfigs.input_specs(jcfg, shape)
    assert got["step"] == want["step"]
    assert _shape_tree(got["batch"]) == _shape_tree(want["batch"])
    assert ("caches" in got) == ("caches" in want)
    if "caches" in want:
        assert _shape_tree(got["caches"]) == _shape_tree(want["caches"])
        assert all(t.device.type == "meta" for _, t in tree_items(got["caches"]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_tree_equals_the_reference(arch):
    tcfg = tconfigs.get_config(arch).reduced()
    got = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert _shape_tree(got) == _shape_tree(ref_abstract_params(jconfigs.get_config(arch).reduced()))
    assert all(t.device.type == "cpu" for _, t in tree_items(got))


def test_init_params_follows_the_reference_distributions():
    cfg = dataclasses.replace(tconfigs.get_config("recurrentgemma_9b").reduced(), d_model=256, d_ff=384,
                              rnn_width=256, block_pattern=("R",), n_layers=1)
    p = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    mixer = p["layers"]["0"]["mixer"]
    w = mixer["w_input_gate"]  # fan-in 256: truncated normal at +-2, times 1/16
    assert float(w.abs().max()) <= 2.0 / 16 + 1e-7
    # a standard normal truncated at +-2 has std 0.8796
    assert abs(float(w.std()) * 16 - 0.8796) < 0.01
    lam = torch.sigmoid(mixer["lam_logit"])
    assert float(lam.min()) >= 0.9 - 1e-6 and float(lam.max()) <= 0.999 + 1e-6
    conv = mixer["conv_w"]
    assert float(conv.abs().max()) <= 0.2 + 1e-7
    emb = p["embed"]
    assert float(emb.abs().max()) <= 0.04 + 1e-7
    xl = init_params(tconfigs.get_config("xlstm_1_3b").reduced(), device="cpu")
    assert torch.equal(xl["layers"]["1"]["mixer"]["b_f"], torch.full_like(xl["layers"]["1"]["mixer"]["b_f"], 3.0))
    # a seeded generator repeats its draws; the default seed is 0
    again = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(p), tree_items(again)))
    d0 = init_params(cfg, device="cpu")
    d1 = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(d0), tree_items(d1)))


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.models import init_caches

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config("stablelm_1_6b").reduced()
    for call in (lambda: init_params(cfg), lambda: init_caches(cfg, 1, 8), lambda: TransformerLM(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert init_caches(cfg, 1, 8, device="cpu")["0"]["k"].device.type == "cpu"


def test_module_registers_the_tree_under_its_paths():
    cfg = tconfigs.get_config("mixtral_8x7b").reduced()
    model = TransformerLM(cfg, device="cpu")
    tree = dict(tree_items(model.params))
    assert sorted(model.state_dict()) == sorted(tree)
    assert "layers.0.ffn.w_gate" in tree and "lm_head" in tree
    assert not any(p.requires_grad for p in model.parameters())
    again = TransformerLM(cfg, params=init_params(cfg, torch.Generator().manual_seed(9), device="cpu"))
    again.load_state_dict(model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)))
    assert torch.equal(again({"tokens": toks})[0], model({"tokens": toks})[0])
