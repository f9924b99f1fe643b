"""Train step factory: loss -> grads -> AdamW, with gradient accumulation.

A port of ``repro.train.train_step``. Gradients of ``loss + 0.01 * aux``
come from ``torch.autograd.grad`` over detached leaves of the parameter
tree, so the caller's tensors are neither modified nor marked as requiring
grad. Gradient accumulation walks the microbatches in a loop (the
reference's ``lax.scan``) with f32 accumulators: microbatch ``i`` is rows
``[i*b/k, (i+1)*b/k)`` of every batch entry.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models.lm import loss_fn, tree_items, tree_map, tree_unflatten
from .optimizer import AdamWConfig, adamw_update

__all__ = ["loss_and_grads", "make_train_step"]


def loss_and_grads(cfg, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict, Dict]:
    """``loss_fn``'s total, its parts and the gradient tree of the total
    (zeros for a leaf the loss does not use, as ``jax.grad`` gives), taken
    over detached leaves: ``params`` is left as it is."""
    live = [t.detach().requires_grad_() for _, t in tree_items(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(params, grads)


def make_train_step(cfg, opt_cfg: AdamWConfig, grad_accum: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and
    ``lr`` (0-dim tensors on the parameters' device)."""

    def train_step(params, opt_state, batch) -> Tuple[Dict, Dict, Dict]:
        if grad_accum <= 1:
            loss, metrics, grads = loss_and_grads(cfg, params, batch)
        else:
            rows = {v.shape[0] for v in batch.values()}
            if len(rows) != 1 or rows.pop() % grad_accum:
                raise ValueError(f"grad_accum={grad_accum} does not divide the batch's rows")

            def micro(i):
                return {k: v[i * (v.shape[0] // grad_accum): (i + 1) * (v.shape[0] // grad_accum)]
                        for k, v in batch.items()}

            device = next(t for _, t in tree_items(params)).device
            g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(grad_accum):
                loss, _, grads = loss_and_grads(cfg, params, micro(i))
                g_sum = tree_map(lambda a, g: a + g.to(torch.float32), g_sum, grads)
                loss_sum = loss_sum + loss
                del grads
            grads = tree_map(lambda g: g / grad_accum, g_sum)
            del g_sum
            loss = loss_sum / grad_accum
            metrics = {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=device)}

        new_params, new_state, opt_metrics = adamw_update(opt_cfg, grads, params, opt_state)
        return new_params, new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
