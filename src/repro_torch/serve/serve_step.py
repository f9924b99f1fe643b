"""Serving steps: prefill (build caches from a prompt) and decode (one token).

A port of ``repro.serve.serve_step``. ``serve_step`` is one new token
against a KV cache; caches are group-stacked to match the parameter layout.
All three run under ``torch.no_grad()``.

A full-attention cache built by :func:`prefill` holds exactly the prompt,
so a decode step after it overwrites position 0 (the reference's finding
(a), reproduced, not repaired); decode from :func:`init_caches` with room
for the whole sequence agrees with ``forward``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models import decode_step, forward
from ..models.lm import _apply_block, _embed_inputs, _group, _head, apply_norm, tree_map  # noqa: F401

__all__ = ["prefill", "make_prefill_step", "make_serve_step"]


@torch.no_grad()
def prefill(cfg, params, batch) -> Tuple[torch.Tensor, Dict]:
    """Forward over the prompt, returning the last position's logits
    (B, 1, V) and decode caches."""
    x, positions = _embed_inputs(cfg, params, batch)
    outs = []
    for g in range(cfg.n_groups):
        gp = _group(params["layers"], g)
        caches = {}
        for pos in range(cfg.pattern_period):
            x, _, caches[str(pos)] = _apply_block(
                cfg, gp[str(pos)], cfg.block_pattern[pos], x, positions, return_cache=True
            )
        outs.append(caches)
    return _head(cfg, params, x[:, -1:]), tree_map(lambda *xs: torch.stack(xs), *outs)


def make_prefill_step(cfg) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = forward(cfg, params, batch)
        return logits[:, -1:]

    return prefill_step


def make_serve_step(cfg) -> Callable:
    @torch.no_grad()
    def serve_step(params, caches, batch):
        return decode_step(cfg, params, caches, batch)

    return serve_step
