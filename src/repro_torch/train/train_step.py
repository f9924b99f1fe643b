"""Train step factory: loss -> grads -> AdamW, with gradient accumulation.

A port of ``repro.train.train_step``. Gradients of ``loss + 0.01 * aux``
come from ``torch.autograd.grad`` over detached leaves of the parameter
tree, so the caller's tensors are neither modified nor marked as requiring
grad. Gradient accumulation walks the microbatches in a loop (the
reference's ``lax.scan``) with f32 accumulators: microbatch ``i`` is rows
``[i*b/k, (i+1)*b/k)`` of every batch entry.

On a mesh the same step runs over DTensors: :func:`place_train_state` lays
the parameters out by ``repro_torch.sharding.make_param_specs`` and, with
``cfg.zero1``, the AdamW moments by ``zero1_specs``; the loss runs under
``implicit_replication`` (the models build plain position and mask tensors),
its ``Partial`` value is replicated before ``autograd.grad``, and each
gradient is reduced to its parameter's placements. Loss and metrics come
back as plain tensors, equal on every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models.lm import loss_fn, tree_items, tree_map, tree_unflatten
from ..sharding import distribute_tree, is_sharded, make_param_specs, replicated, sharded_region, zero1_specs
from .optimizer import AdamWConfig, adamw_update

__all__ = ["loss_and_grads", "make_train_step", "place_train_state"]


def place_train_state(cfg, params: Dict, opt_state: Dict, mesh) -> Tuple[Dict, Dict]:
    """``params`` and ``opt_state`` (whole tensors on every rank) as DTensors
    on ``mesh``: the parameters by ``make_param_specs``, the moments by
    ``zero1_specs`` when ``cfg.zero1`` (else as their parameters); the step
    count stays a plain tensor."""
    p_specs = make_param_specs(cfg, params, mesh)
    m_specs = zero1_specs(p_specs, params, mesh) if cfg.zero1 else p_specs
    state = {"m": distribute_tree(opt_state["m"], m_specs, mesh),
             "v": distribute_tree(opt_state["v"], m_specs, mesh), "count": opt_state["count"]}
    return distribute_tree(params, p_specs, mesh), state


def loss_and_grads(cfg, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict, Dict]:
    """``loss_fn``'s total, its parts and the gradient tree of the total
    (zeros for a leaf the loss does not use, as ``jax.grad`` gives), taken
    over detached leaves: ``params`` is left as it is."""
    live = [t.detach().requires_grad_() for _, t in tree_items(params)]
    sharded = is_sharded(live[0])
    with torch.enable_grad(), sharded_region(sharded):
        loss, metrics = loss_fn(cfg, tree_unflatten(params, live), batch)
        if sharded:
            from torch.distributed.tensor import Replicate

            loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
    if sharded:  # the data-parallel reduction: each gradient to its parameter's layout
        grads = [g.redistribute(t.device_mesh, t.placements) for t, g in zip(live, grads)]
    metrics = {k: replicated(v.detach()) for k, v in metrics.items()}
    return replicated(loss.detach()), metrics, tree_unflatten(params, grads)


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
            g_sum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
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
