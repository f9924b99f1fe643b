"""Shared layers: norms, RoPE, dense FFNs and the initializers.

A port of ``repro.models.layers``. Parameters are plain nested dicts of
tensors with the reference's paths, shapes and dtypes: f32 master weights,
cast to the compute dtype at each call (``x @ W.to(x.dtype)``).

Initializers draw from an explicit ``torch.Generator`` on the generator's
device and hand the tensor to ``device``; with ``device="meta"`` (and no
generator) they only build shapes. They give the reference's distributions,
not its bits: the CPU tests carry JAX's parameters across instead.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = [
    "dense_init",
    "uniform_init",
    "index_scalar",
    "norm_init",
    "apply_norm",
    "rope",
    "mlp_init",
    "apply_mlp",
]


def _empty(generator: Optional[torch.Generator], shape: Sequence[int], device) -> torch.Tensor:
    where = device if generator is None else generator.device
    return torch.empty(tuple(shape), dtype=torch.float32, device=where)


def dense_init(generator, shape, scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Truncated-normal (at +-2) fan-in init, kept in f32 (compute casts)."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    out = _empty(generator, shape, device)
    if out.device.type != "meta":
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
        out.mul_(scale)
    return out.to(device)


def uniform_init(generator, shape, lo: float, hi: float, device=None) -> torch.Tensor:
    out = _empty(generator, shape, device)
    if out.device.type != "meta":
        out.uniform_(lo, hi, generator=generator)
    return out.to(device)


def index_scalar(value: int, device) -> torch.Tensor:
    """A cache's ``idx``: a 0-dim int32 tensor on the cache's device."""
    return torch.tensor(value, dtype=torch.int32, device=device)


def norm_init(d: int, device=None) -> Dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def apply_norm(params: Dict, x: torch.Tensor, kind: str = "rmsnorm") -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6)
    else:  # layernorm (bias-free); the population variance, as jnp.var
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
    return (y * params["scale"]).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the leading ``fraction`` of head dims.

    x: (..., S, H, Dh); positions: broadcastable to (..., S).
    """
    dh = x.shape[-1]
    rot = int(dh * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None, None].float() * freqs  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def mlp_init(generator, d_model: int, d_ff: int, kind: str, device=None) -> Dict:
    if kind == "swiglu":
        return {
            "w_gate": dense_init(generator, (d_model, d_ff), device=device),
            "w_up": dense_init(generator, (d_model, d_ff), device=device),
            "w_down": dense_init(generator, (d_ff, d_model), device=device),
        }
    return {  # gelu
        "w_up": dense_init(generator, (d_model, d_ff), device=device),
        "w_down": dense_init(generator, (d_ff, d_model), device=device),
    }


def apply_mlp(params: Dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    dt = x.dtype
    if kind == "swiglu":
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        h = F.silu(g.float()).to(dt) * u
        return h @ params["w_down"].to(dt)
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu((x @ params["w_up"].to(dt)).float(), approximate="tanh").to(dt)
    return h @ params["w_down"].to(dt)
