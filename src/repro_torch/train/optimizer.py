"""AdamW with warmup+cosine schedule and global-norm clipping.

A port of ``repro.train.optimizer``, on the nested-dict parameter trees of
``repro_torch.models``. The arithmetic is JAX's, in f32 throughout: the
schedule runs on an f32 step, the bias corrections are f32 powers, the
moments are f32 and ``count`` is a 0-dim int32. The update is functional:
it returns new trees and never modifies the tensors it is given.

Over DTensors (a sharded train step) each leaf's update runs in its
moments' layout: the gradient and the parameter are cut to it (a local
slice; with ZeRO-1 the moments are also sharded over "data"), and the new
parameter is gathered back to the parameter's layout. Every element goes
through the same f32 operations as unsharded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..models.lm import tree_items, tree_map
from ..sharding import is_sharded, replicated, sharded_region

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine down to ``min_lr_frac`` of
    it; ``step`` is a tensor (any dtype), the result an f32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: Dict) -> Dict:
    """f32 zero moments shaped like ``params``, on their devices, and a
    0-dim int32 step count."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731  (a DTensor keeps its layout)
    device = next(t for _, t in tree_items(params)).device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _global_norm(tree: Dict) -> torch.Tensor:
    """sqrt of the sum of per-leaf f32 sums of squares, the leaves in JAX's
    order (sorted keys); a DTensor leaf's sum is reduced over the mesh."""
    sums = [replicated(torch.sum(torch.square(x.to(torch.float32)))) for _, x in tree_items(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_update(cfg: AdamWConfig, grads: Dict, params: Dict, state: Dict) -> Tuple[Dict, Dict, Dict]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"})."""
    count = state["count"] + 1
    gn = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    c = count.to(torch.float32)
    bc1 = 1 - cfg.b1**c
    bc2 = 1 - cfg.b2**c
    lr = lr_schedule(cfg, count)

    def upd(p, g, m_, v_):
        # leaf by leaf, so that one leaf's f32 temporaries live at a time
        sharded = is_sharded(p)
        p_in = p
        if sharded:  # the moments' layout: a local slice of p and g
            g = g.redistribute(m_.device_mesh, m_.placements)
            p = p.redistribute(m_.device_mesh, m_.placements)
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m_ + (1 - cfg.b1) * g
        v = cfg.b2 * v_ + (1 - cfg.b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        new = (p.to(torch.float32) - lr * step).to(p.dtype)
        if sharded:
            new = new.redistribute(p_in.device_mesh, p_in.placements)
        return new, m, v

    with sharded_region(is_sharded(next(t for _, t in tree_items(params)))):
        out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, {"grad_norm": gn, "lr": lr}
