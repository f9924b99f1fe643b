"""Recurrent sequence mixers: RG-LRU (RecurrentGemma), mLSTM and sLSTM (xLSTM).

A port of ``repro.models.recurrent``. RG-LRU is a first-order linear
recurrence h_t = a_t * h_{t-1} + b_t, evaluated with the log-depth
associative scan the reference gets from ``jax.lax.associative_scan``
(:func:`associative_scan` below follows its odd/even recursion, so the
products are formed in the same order). The sLSTM's nonlinear recurrence is
a sequential loop over time, as the reference's ``lax.scan``. mLSTM's
forward uses the stabilized quadratic form; its decode uses the O(1)/token
matrix-memory recurrence.

The reference's mLSTM decode scales ``q . k`` without the forward's
``1/sqrt(dh)`` (finding (b)); the port reproduces that, it does not
repair it.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, Iterator, List

import torch
import torch.nn.functional as F

from ..sharding.placement import einsum, reshape_whole, run_local, with_sharding_constraint
from ..sharding.rules import P, data_axes
from .layers import dense_init, index_scalar, uniform_init

__all__ = [
    "associative_scan",
    "rglru_init",
    "rglru_apply",
    "rglru_init_cache",
    "rglru_decode",
    "mlstm_init",
    "mlstm_apply",
    "mlstm_init_cache",
    "mlstm_decode",
    "slstm_init",
    "slstm_apply",
    "slstm_init_cache",
    "slstm_decode",
    "slstm_walk",
]

C_RGLRU = 8.0
_GATES = ("z", "i", "f", "o")


def associative_scan(combine: Callable, elems: List[torch.Tensor]) -> List[torch.Tensor]:
    """Inclusive scan of ``combine`` over dim 1, by the recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the half,
    then fill in the even positions."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = combine([e[:, :-1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([o[:, :-1] for o in odd], [e[:, 2::2] for e in elems])
    else:
        even = combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):
        both = ev.new_empty((ev.shape[0], n) + tuple(ev.shape[2:]))
        both[:, 0::2] = ev
        both[:, 1::2] = od
        out.append(both)
    return out


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# =============================================================================
# RG-LRU recurrent block (RecurrentGemma)
# =============================================================================

def rglru_init(generator, cfg, device=None) -> Dict:
    d = cfg.d_model
    dr = cfg.rnn_width or d
    lam = uniform_init(generator, (dr,), 0.9, 0.999, device=device)
    return {
        "w_gate_branch": dense_init(generator, (d, dr), device=device),
        "w_x_branch": dense_init(generator, (d, dr), device=device),
        "conv_w": dense_init(generator, (cfg.conv_width, dr), scale=0.1, device=device),
        "w_input_gate": dense_init(generator, (dr, dr), device=device),
        "w_rec_gate": dense_init(generator, (dr, dr), device=device),
        # Lambda parametrized so sigmoid(lam_logit) = lam
        "lam_logit": torch.log(lam) - torch.log1p(-lam),
        "w_out": dense_init(generator, (dr, d), device=device),
    }


def _rglru_core(params, z, h0):
    """z: (B, S, Dr) post-conv; returns (h, h_last)."""
    dt = z.dtype
    zf = z.float()
    r = torch.sigmoid(zf @ params["w_rec_gate"])
    i = torch.sigmoid(zf @ params["w_input_gate"])
    log_a = -C_RGLRU * _softplus(params["lam_logit"]) * r  # (B,S,Dr) <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (i * zf)
    if h0 is not None:
        # fold the carried state in as a virtual step 0
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0.float()[:, None], b], dim=1)

    def combine(left, right):
        al, bl = left
        ar, br = right
        return [al * ar, bl * ar + br]

    _, h = associative_scan(combine, [a, b])
    if h0 is not None:
        h = h[:, 1:]
    return h.to(dt), h[:, -1].to(dt)


def _causal_conv(z, w, state=None):
    """Depthwise causal conv, width K. state: (B, K-1, Dr) history or None."""
    k = w.shape[0]
    pad = torch.zeros_like(z[:, : k - 1]) if state is None else state
    zp = torch.cat([pad, z], dim=1)
    out = sum(zp[:, i : i + z.shape[1]] * w[i] for i in range(k))
    return out, zp[:, -(k - 1) :]


def rglru_apply(params, cfg, x, positions, return_cache=False):
    dt = x.dtype
    gate = F.gelu((x @ params["w_gate_branch"].to(dt)).float(), approximate="tanh").to(dt)
    z = x @ params["w_x_branch"].to(dt)
    z, conv_state = _causal_conv(z, params["conv_w"].to(dt))
    h, h_last = _rglru_core(params, z, None)
    y = (gate * h) @ params["w_out"].to(dt)
    cache = None
    if return_cache:
        cache = {"h": h_last, "conv": conv_state, "idx": index_scalar(x.shape[1], x.device)}
    return y, cache


def rglru_init_cache(cfg, batch, max_len, dtype, device=None):
    dr = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((batch, dr), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, dr), dtype=dtype, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def rglru_decode(params, cfg, x, cache):
    dt = x.dtype
    gate = F.gelu((x @ params["w_gate_branch"].to(dt)).float(), approximate="tanh").to(dt)
    z = x @ params["w_x_branch"].to(dt)
    z, conv_state = _causal_conv(z, params["conv_w"].to(dt), cache["conv"])
    h, h_last = _rglru_core(params, z, cache["h"])
    y = (gate * h) @ params["w_out"].to(dt)
    return y, {"h": h_last, "conv": conv_state, "idx": cache["idx"] + 1}


# =============================================================================
# mLSTM (xLSTM): matrix memory, exp gating
# =============================================================================

def mlstm_init(generator, cfg, device=None) -> Dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {
        "w_up": dense_init(generator, (d, 2 * d), device=device),
        "w_q": dense_init(generator, (d, h, dh), device=device),
        "w_k": dense_init(generator, (d, h, dh), device=device),
        "w_v": dense_init(generator, (d, h, dh), device=device),
        "w_i": dense_init(generator, (d, h), scale=0.01, device=device),
        "w_f": dense_init(generator, (d, h), scale=0.01, device=device),
        "b_f": torch.full((h,), 3.0, dtype=torch.float32, device=device),  # forget bias ~ keep
        "w_down": dense_init(generator, (d, d), device=device),
    }


def _mlstm_qkv(params, x):
    dt = x.dtype
    d = x.shape[-1]
    up = x @ params["w_up"].to(dt)
    u, gate = up[..., :d], up[..., d:]
    q = einsum("bsd,dhk->bshk", u, params["w_q"].to(dt))
    k = einsum("bsd,dhk->bshk", u, params["w_k"].to(dt))
    v = einsum("bsd,dhk->bshk", u, params["w_v"].to(dt))
    return u, gate, q, k, v


def mlstm_apply(params, cfg, x, positions, return_cache=False):
    """Stabilized quadratic (training) form."""
    dt = x.dtype
    b, s, d = x.shape
    dh = d // cfg.n_heads
    u, gate, q, k, v = _mlstm_qkv(params, x)
    uf = u.float()
    log_i = uf @ params["w_i"]  # (B,S,H)
    log_f = F.logsigmoid(uf @ params["w_f"] + params["b_f"])
    cf = torch.cumsum(log_f, dim=1)  # F_t
    mixed = run_local(functools.partial(_mlstm_core, math.sqrt(dh)), (q, k, v, log_i, cf),
                      ("bshd", "bthd", "bthe", "bth", "bth"), ("bsh",), _MLSTM_MODES, _mlstm_judge, "de")
    y = (mixed * F.silu(gate.float()).to(dt)) @ params["w_down"].to(dt)
    cache = None
    if return_cache:
        cache = _mlstm_state_from_seq(k, v, log_i, log_f)
    return y, cache


# The quadratic form's core on a mesh runs on local shards (``run_local``):
# b batch, s / t query and key steps, h heads, d the q.k contraction, e the
# value features; a mesh dimension splits the batch, the heads, or the
# contraction (the scores summed across it, the output's features gathered
# before the heads merge). DTensor's own layout of its (B,S,S,H) terms can
# split the batch over more devices than it has rows, and it cannot view a
# head axis back out of features split over more devices than heads.
_MLSTM_MODES = ("b", "h", "de")


def _mlstm_judge(mode, sizes, split, extent):
    if mode == "de":  # an all-reduce of the f32 scores
        return True, sizes["b"] * sizes["s"] * sizes["t"] * sizes["h"] * 4 // (split["b"] * split["h"])
    return True, 0


def _mlstm_core(scale, sh, q, k, v, log_i, cf):
    s = q.shape[1]
    # D[t, s] = F_t - F_s + log_i_s  (s <= t)
    dmat = cf[:, :, None, :] - cf[:, None, :, :] + log_i[:, None, :, :]
    tpos = torch.arange(s, device=q.device)
    causal = tpos[:, None] >= tpos[None, :]
    dmat = torch.where(causal[None, :, :, None], dmat, -math.inf)
    m = torch.amax(dmat, dim=2, keepdim=True)  # (B,S,1,H)
    w = torch.exp(dmat - m)  # (B,S,S,H)
    scores = sh.psum(einsum("bshk,bthk->bsth", q, k).float()) / scale
    ww = w * scores
    num = einsum("bsth,bthk->bshk", ww.to(q.dtype), v)
    den = torch.abs(torch.sum(ww, dim=2))  # (B,S,H)
    den = torch.maximum(den, torch.exp(-m[:, :, 0, :]))
    out = sh.gather(num / den[..., None].to(q.dtype), "e", 3)
    return out.reshape(out.shape[0], s, -1)  # (B,S,D): its features split as the heads are


def _mlstm_state_from_seq(k, v, log_i, log_f):
    """Fold a whole prefix into the recurrent (C, n, m) state (for prefill)."""
    s = k.shape[1]
    cf = torch.cumsum(log_f, dim=1)
    ftot = cf[:, -1]  # (B,H)
    # weight of step t in the final state: exp(F_S - F_t + log_i_t - m)
    logw = ftot[:, None] - cf + log_i  # (B,S,H)
    m = torch.clamp(torch.amax(logw, dim=1), min=0.0)  # (B,H); 0 guards the n floor
    w = torch.exp(logw - m[:, None]).to(k.dtype)
    c = einsum("bsh,bshk,bshl->bhkl", w, k, v)
    n = einsum("bsh,bshk->bhk", w, k)
    return {"c": c, "n": n, "m": m, "idx": index_scalar(s, k.device)}


def mlstm_init_cache(cfg, batch, max_len, dtype, device=None):
    h = cfg.n_heads
    dh = cfg.d_model // h
    return {
        "c": torch.zeros((batch, h, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((batch, h, dh), dtype=dtype, device=device),
        "m": torch.zeros((batch, h), dtype=torch.float32, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def mlstm_decode(params, cfg, x, cache):
    dt = x.dtype
    b, _, d = x.shape  # s == 1
    u, gate, q, k, v = _mlstm_qkv(params, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    uf = u[:, 0].float()
    log_i = uf @ params["w_i"]  # (B,H)
    log_f = F.logsigmoid(uf @ params["w_f"] + params["b_f"])
    m_new = torch.maximum(log_f + cache["m"], log_i)
    fs = torch.exp(log_f + cache["m"] - m_new).to(dt)  # (B,H)
    is_ = torch.exp(log_i - m_new).to(dt)
    c = cache["c"] * fs[..., None, None] + is_[..., None, None] * einsum("bhk,bhl->bhkl", k, v)
    n = cache["n"] * fs[..., None] + is_[..., None] * k
    # no 1/sqrt(dh) here, unlike mlstm_apply: the reference's finding (b)
    num = einsum("bhkl,bhk->bhl", c, q)
    den = torch.abs(einsum("bhk,bhk->bh", n, q))
    den = torch.maximum(den, torch.exp(-m_new).to(dt))
    out = (num / den[..., None]).reshape(b, 1, d)
    y = (out * F.silu(gate.float()).to(dt)) @ params["w_down"].to(dt)
    return y, {"c": c, "n": n, "m": m_new, "idx": cache["idx"] + 1}


# =============================================================================
# sLSTM (xLSTM): scalar memory, strictly sequential
# =============================================================================

# the dry-run's walk length (None: every time step); see slstm_walk
_WALK = None


@contextlib.contextmanager
def slstm_walk(steps: int) -> Iterator[None]:
    """While active, :func:`slstm_apply` walks only the first ``steps`` time
    steps and repeats the last step's output for the rest: a count-only
    mode, for a step over ``meta`` tensors (the dry-run), never for values.

    Every step of the walk issues the same operations on the same shapes
    and layouts, and each repeated output adds one gradient accumulation of
    one fixed size, so a step's counts are linear in ``steps``: counting at
    two walk lengths and extrapolating to the sequence length gives the
    full walk's counts without dispatching thousands of steps through
    DTensor (``repro_torch.launch.dryrun.count_step``)."""
    global _WALK
    before, _WALK = _WALK, steps
    try:
        yield
    finally:
        _WALK = before


def slstm_init(generator, cfg, device=None) -> Dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    p = {}
    for g in _GATES:
        p[f"w_{g}"] = dense_init(generator, (d, h, dh), device=device)
    for g in _GATES:
        p[f"r_{g}"] = dense_init(generator, (h, dh, dh), scale=0.3 / math.sqrt(dh), device=device)
    p["w_out"] = dense_init(generator, (d, d), device=device)
    return p


def _slstm_step(params, carry, xt):
    """xt: the four gates' pre-projected inputs, each (B, H, Dh)."""
    c, n, hprev, m = carry
    wz, wi, wf, wo = xt
    # a bf16 state times f32 recurrent weights: JAX promotes to f32
    hp = hprev.float()
    rz, ri, rf, ro = (einsum("bhk,hkl->bhl", hp, params[f"r_{g}"]) for g in _GATES)
    z = torch.tanh(wz.float() + rz)
    log_i = wi.float() + ri
    log_f = F.logsigmoid(wf.float() + rf)
    o = torch.sigmoid(wo.float() + ro)
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = torch.maximum(f_s * n + i_s, torch.exp(-m_new))
    h_new = o * (c_new / n_new)
    return (c_new, n_new, h_new.to(hprev.dtype), m_new), h_new


def slstm_apply(params, cfg, x, positions, return_cache=False):
    dt = x.dtype
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    # on a mesh: the batch layout in, and the time axis moved out front
    # after the product (a product that writes it first leaves a gradient
    # whose flattened (s, b) axis DTensor cannot view back)
    x = with_sharding_constraint(x, lambda mesh: P(data_axes(mesh), None, None))
    gates = [einsum("bsd,dhk->bshk", x, params[f"w_{g}"].to(dt)).transpose(0, 1) for g in _GATES]
    f32 = torch.float32
    carry = (
        torch.zeros((b, h, dh), dtype=f32, device=x.device),
        torch.ones((b, h, dh), dtype=f32, device=x.device),
        torch.zeros((b, h, dh), dtype=dt, device=x.device),
        torch.zeros((b, h, dh), dtype=f32, device=x.device),
    )
    hs = []
    walk = s if _WALK is None else min(_WALK, s)
    for t in range(walk):
        carry, h_t = _slstm_step(params, carry, tuple(g[t] for g in gates))
        hs.append(h_t)
    hs += [h_t] * (s - walk)  # a cut walk (counting only): the last output stands in for the rest
    hs = reshape_whole(torch.stack(hs, dim=1), b, s, d).to(dt)
    y = hs @ params["w_out"].to(dt)
    cache = None
    if return_cache:
        c, n, hl, m = carry
        cache = {"c": c, "n": n, "h": hl, "m": m, "idx": index_scalar(s, x.device)}
    return y, cache


def slstm_init_cache(cfg, batch, max_len, dtype, device=None):
    h = cfg.n_heads
    dh = cfg.d_model // h
    return {
        "c": torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        "n": torch.ones((batch, h, dh), dtype=torch.float32, device=device),
        "h": torch.zeros((batch, h, dh), dtype=dtype, device=device),
        "m": torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def slstm_decode(params, cfg, x, cache):
    dt = x.dtype
    b, _, d = x.shape
    gates = tuple(einsum("bsd,dhk->bhk", x, params[f"w_{g}"].to(dt)) for g in _GATES)
    carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    (c, n, hl, m), hnew = _slstm_step(params, carry, gates)
    y = hnew.to(dt).reshape(b, 1, d) @ params["w_out"].to(dt)
    return y, {"c": c, "n": n, "h": hl, "m": m, "idx": cache["idx"] + 1}
