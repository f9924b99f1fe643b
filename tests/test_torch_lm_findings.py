"""Two findings about the reference's serving path, shown in ``repro`` and in
``repro_torch`` alike (the port reproduces them; it does not repair them):

(a) decode after ``prefill`` disagrees with ``forward``: the full-attention
    cache is sized to the prompt, so the next write wraps to position 0
    (``repro/models/attention.py:280-284``, ``:303``); MLA's write clamps to
    the last row (``:371``); a window ring filled by prefill is aligned only
    when the prompt is a multiple of the window. Decode from ``init_caches``
    with room for the sequence agrees with ``forward``.
(b) xLSTM's mLSTM decode disagrees with its own forward: it omits the
    forward's ``1/sqrt(dh)`` (``repro/models/recurrent.py:173`` against
    ``:235``); the sLSTM's decode agrees.

f32 reduced configs; the port's decode logits equal the reference's within
``1e-4`` (``5e-3`` for the recurrent families; ``1e-2`` for xlstm after
prefill, where (b) amplifies the packages' last-bit differences).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.models as jm  # noqa: E402
import repro.serve as js  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.serve as ts  # noqa: E402
from torch_lm_parity import configs, params, to_jax, to_torch, tol  # noqa: E402

FINDING_A = ["stablelm_1_6b", "mixtral_8x7b", "recurrentgemma_9b", "minicpm3_4b", "xlstm_1_3b"]


def _prompt_then_one(cfg, seed, s):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (2, s + 1)).astype(np.int32)


@pytest.mark.parametrize("arch", FINDING_A)
def test_decode_after_prefill_overwrites_as_in_the_reference(arch):
    # one token decoded after a 20-token prompt against forward on all 21
    tol_ = 1e-2 if arch == "xlstm_1_3b" else tol(arch)
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, 0)
    toks = _prompt_then_one(jcfg, 5, 20)
    prompt, nxt = {"tokens": toks[:, :20]}, {"tokens": toks[:, 20:]}
    gaps = []
    for m, s, cfg, p, conv in ((jm, js, jcfg, jp, to_jax), (tm, ts, tcfg, tp, to_torch)):
        full, _ = m.forward(cfg, p, conv({"tokens": toks}))
        # forward over the prompt alone; over all 21 where the prompt's
        # positions do not depend on the 21st (MoE capacity does)
        own = m.forward(cfg, p, conv(prompt))[0] if cfg.ffn_type == "moe" else full
        last, caches = s.prefill(cfg, p, conv(prompt))
        dec, _ = m.decode_step(cfg, p, caches, conv(nxt))
        full, own, last, dec = (np.asarray(x, np.float32) for x in (full, own, last, dec))
        # prefill's own last logits are forward's; the decode after it is not
        np.testing.assert_allclose(last[:, 0], own[:, 19], rtol=tol(arch), atol=tol(arch))
        gaps.append((dec[:, 0], np.abs(dec[:, 0] - full[:, 20]).max()))
    (jdec, jgap), (tdec, tgap) = gaps
    assert jgap > 0.05, jgap  # the reference's gap
    # and the port reproduces it: the same decode logits, the same gap
    np.testing.assert_allclose(tdec, jdec, rtol=tol_, atol=tol_)
    assert abs(tgap - jgap) <= 2 * tol_


def test_decode_from_init_caches_agrees_with_forward_in_both():
    # the path the finding leaves sound: decode from caches with room to spare
    jcfg, tcfg = configs("stablelm_1_6b")
    jp, tp = params(jcfg, 0)
    toks = _prompt_then_one(jcfg, 6, 12)
    for m, cfg, p, conv in ((jm, jcfg, jp, to_jax), (tm, tcfg, tp, to_torch)):
        full, _ = m.forward(cfg, p, conv({"tokens": toks}))
        caches = m.init_caches(cfg, 2, 16) if m is jm else m.init_caches(cfg, 2, 16, device="cpu")
        for t in range(13):
            lg, caches = m.decode_step(cfg, p, caches, conv({"tokens": toks[:, t : t + 1]}))
            np.testing.assert_allclose(np.asarray(lg)[:, 0], np.asarray(full)[:, t], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("pattern", [("M",), ("S",)])
def test_mlstm_decode_differs_from_forward_as_in_the_reference(pattern):
    # a one-kind xLSTM, 12 tokens decoded from empty caches against forward
    jcfg, tcfg = configs("xlstm_1_3b", block_pattern=pattern, n_layers=2)
    jp, tp = params(jcfg, 0)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    outs = []
    for m, cfg, p, conv in ((jm, jcfg, jp, to_jax), (tm, tcfg, tp, to_torch)):
        full, _ = m.forward(cfg, p, conv({"tokens": toks}))
        caches = m.init_caches(cfg, 2, 16) if m is jm else m.init_caches(cfg, 2, 16, device="cpu")
        dec = []
        for t in range(12):
            lg, caches = m.decode_step(cfg, p, caches, conv({"tokens": toks[:, t : t + 1]}))
            dec.append(np.asarray(lg, np.float32)[:, 0])
        dec = np.stack(dec, axis=1)
        outs.append((dec, np.abs(dec - np.asarray(full, np.float32)).max()))
    (jdec, jgap), (tdec, tgap) = outs
    np.testing.assert_allclose(tdec, jdec, rtol=5e-3, atol=5e-3)
    if pattern == ("M",):
        assert jgap > 0.5 and abs(tgap - jgap) <= 1e-2, (jgap, tgap)
    else:  # the sLSTM's decode is its forward
        assert jgap < 1e-4 and tgap < 1e-4, (jgap, tgap)


def test_mlstm_decode_omits_the_forward_scale():
    # the visible cause of (b): scaling q by 1/sqrt(dh) makes decode match forward
    jcfg, tcfg = configs("xlstm_1_3b", block_pattern=("M",), n_layers=2)
    _, tp = params(jcfg, 0)
    dh = tcfg.d_model // tcfg.n_heads
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32))
    full, _ = tm.forward(tcfg, tp, {"tokens": toks})
    scaled = {**tp, "layers": {"0": {**tp["layers"]["0"], "mixer": dict(tp["layers"]["0"]["mixer"])}}}
    scaled["layers"]["0"]["mixer"]["w_q"] = tp["layers"]["0"]["mixer"]["w_q"] / dh**0.5
    caches = tm.init_caches(tcfg, 2, 16, device="cpu")
    dec = []
    for t in range(12):
        lg, caches = tm.decode_step(tcfg, scaled, caches, {"tokens": toks[:, t : t + 1]})
        dec.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full.numpy(), rtol=5e-3, atol=5e-3)
