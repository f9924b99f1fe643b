"""Top-k Mixture-of-Experts with a Reflex-style capacity resizer.

A port of ``repro.models.moe``. Dispatch follows the capacity-factor
formulation:

    capacity C = ceil(tokens * top_k / n_experts * cf)

The capacity resizer is the paper's mechanism transplanted: the fully
oblivious buffer is C_full = tokens (no token ever dropped, whatever the
routing skew); Reflex trims it to C = T_est + eta, where T_est =
tokens * top_k / E is the balanced load and eta is slack from a policy
(``const`` like ConstantNoise; ``reflex_tlap`` / ``reflex_beta`` take the
mean of the port's own :mod:`repro_torch.core.noise` distributions at
planning time). A smaller C shrinks the expert buffers linearly. No privacy
claim is attached (plaintext serving); what transfers is controlled
intermediate-buffer trimming.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.noise import BetaNoise, TruncatedLaplace
from ..sharding.placement import einsum
from .layers import apply_mlp, dense_init, mlp_init

__all__ = ["moe_init", "moe_apply", "resolve_capacity"]


@functools.lru_cache(maxsize=4096)
def resolve_capacity(cfg, n_tokens: int) -> int:
    """Reflex-style capacity policy (static: a planning-time decision).
    Cached per (config, token count): the TLap mean integrates a 200,001-point
    grid, and every MoE layer of every step asks."""
    e, k = cfg.n_experts, cfg.top_k
    t_est = n_tokens * k / e  # balanced true load per expert
    if cfg.capacity_policy == "full":  # fully oblivious: no drops possible
        cap = float(n_tokens)
    elif cfg.capacity_policy == "const":
        cap = t_est * cfg.capacity_factor
    elif cfg.capacity_policy == "reflex_tlap":
        noise = TruncatedLaplace(eps=0.5, delta=5e-5, sensitivity=max(t_est / 64, 1))
        cap = t_est + noise.mean(n_tokens, int(t_est))
    elif cfg.capacity_policy == "reflex_beta":
        noise = BetaNoise(2, 6)
        cap = t_est + noise.mean(int(n_tokens * k / e * 2), int(t_est))
    else:
        raise ValueError(cfg.capacity_policy)
    cap = int(min(max(math.ceil(cap), 8), n_tokens))
    return ((cap + 7) // 8) * 8  # pad to a lane-friendly multiple


def moe_init(generator, cfg, device=None) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": dense_init(generator, (d, e), device=device),
        "w_gate": dense_init(generator, (e, d, f), device=device),
        "w_up": dense_init(generator, (e, d, f), device=device),
        "w_down": dense_init(generator, (e, f, d), device=device),
    }
    if cfg.moe_dense_residual:
        p["dense_residual"] = mlp_init(generator, d, cfg.d_ff, "swiglu", device=device)
    return p


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, ties broken toward the lower index
    (a stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route(params, cfg, xt):
    """Router: top-k gates + per-assignment (expert, position) slots."""
    dt = xt.dtype
    n_tok = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = resolve_capacity(cfg, n_tok)
    logits = (xt @ params["router"].to(dt)).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch/Mixtral style)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)
    # position-in-expert per assignment (int32 prefix counts; k waves)
    fill = torch.zeros((e,), dtype=torch.int32, device=xt.device)
    pos_list = []
    for rank in range(k):
        onehot = F.one_hot(gate_idx[:, rank], e).to(torch.int32)  # (T,E)
        pos_in_wave = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
        pos = torch.gather(pos_in_wave + fill[None, :], 1, gate_idx[:, rank : rank + 1])[:, 0]
        fill = fill + onehot.sum(dim=0, dtype=torch.int32)
        pos_list.append(pos)
    pos_tk = torch.stack(pos_list, dim=1)  # (T, k)
    return gate_vals, gate_idx, pos_tk, cap, aux


def _expert_ffn(params, cfg, ein):
    dt = ein.dtype
    g = einsum("ecd,edf->ecf", ein, params["w_gate"].to(dt))
    u = einsum("ecd,edf->ecf", ein, params["w_up"].to(dt))
    h = F.silu(g.float()).to(dt) * u
    return einsum("ecf,efd->ecd", h, params["w_down"].to(dt))


def moe_apply(params: Dict, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). Two dispatch implementations:

    * ``einsum`` — one-hot dispatch/combine matmuls (2*T*E*C*D FLOPs for the
      dispatch alone);
    * ``gather`` — slot bookkeeping with integer prefix sums, then pure
      gather/scatter data movement: expert-FFN FLOPs only. Dropped
      assignments write to and read from a zero spill slot.
    """
    dt = x.dtype
    b, s, d = x.shape
    n_tok = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(n_tok, d)
    gate_vals, gate_idx, pos_tk, cap, aux = _route(params, cfg, xt)

    if cfg.moe_impl == "einsum":
        dispatch = torch.zeros((n_tok, e, cap), dtype=dt, device=x.device)
        combine = torch.zeros((n_tok, e, cap), dtype=torch.float32, device=x.device)
        for rank in range(k):
            keep = pos_tk[:, rank] < cap
            oh_e = F.one_hot(gate_idx[:, rank], e).to(dt)
            oh_c = F.one_hot(torch.where(keep, pos_tk[:, rank], cap).long(), cap + 1).to(dt)[:, :cap]
            d_r = oh_e[:, :, None] * oh_c[:, None, :]
            dispatch = dispatch + d_r
            combine = combine + d_r.float() * gate_vals[:, rank][:, None, None]
        ein = einsum("tec,td->ecd", dispatch, xt)
        eo = _expert_ffn(params, cfg, ein)
        y = einsum("ecd,tec->td", eo, combine.to(dt)).reshape(b, s, d)
    else:  # gather
        slot = gate_idx * cap + torch.clamp(pos_tk, max=cap - 1)  # (T, k)
        keep = pos_tk < cap
        spill = e * cap  # dropped assignments write/read a zero slot
        slot = torch.where(keep, slot, spill)
        # buffer: slot -> token row (scatter), zero row for empty/spilled
        buf_tok = torch.full((e * cap + 1,), n_tok, dtype=torch.int32, device=x.device)
        tok = torch.arange(n_tok, dtype=torch.int32, device=x.device).repeat_interleave(k)
        buf_tok[slot.reshape(-1)] = tok  # kept slots are unique; the spill slot is reset
        buf_tok[spill] = n_tok
        x_pad = torch.cat([xt, torch.zeros((1, d), dtype=dt, device=x.device)], dim=0)
        ein = x_pad[buf_tok[: e * cap].long()].reshape(e, cap, d)
        eo = _expert_ffn(params, cfg, ein)
        eo_flat = torch.cat([eo.reshape(e * cap, d), torch.zeros((1, d), dtype=dt, device=x.device)], dim=0)
        picked = eo_flat[slot]  # (T, k, D)
        y = torch.sum(picked * gate_vals[..., None].to(dt), dim=1).reshape(b, s, d)

    if cfg.moe_dense_residual:
        y = y + apply_mlp(params["dense_residual"], x, "swiglu")
    return y, aux
