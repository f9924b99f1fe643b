"""Attention variants: GQA full / sliding-window / local / MLA (+ KV caches).

A port of ``repro.models.attention``. All variants share one masked-softmax
core; masks are built per mode:

* ``full``   — causal
* ``swa``    — causal within a sliding window (mixtral)
* ``local``  — causal within a local window (recurrentgemma's attn layers)
* ``prefix`` — bidirectional over the first n_prefix positions (paligemma)
* ``mla``    — multi-head latent attention (minicpm3): KV compressed to a
               latent of rank kv_lora_rank + a shared RoPE key; the decode
               cache stores only the latent.

Decode caches are fixed-capacity rings for swa/local and flat buffers for
full/mla; ``attn_decode`` performs one-token attention against the cache.
The cache's ``idx`` stays a 0-dim int32 tensor, so a decode step on the card
never waits for the host: the slot, the validity mask and the MLA write
position are tensor arithmetic. The reference's ``dynamic_update_slice``
clamps its start to ``cap - 1``; the MLA write does the same explicitly.

Scores are masked and normalised exactly as the reference writes them:
``_sdpa`` masks with ``NEG = -1e9`` in f32, ``_sdpa_chunked`` with ``-inf``
behind its safe-max guard; neither goes through
``scaled_dot_product_attention``.

On a mesh the tensors are DTensors: the projections go through
``repro_torch.sharding``'s ``einsum``, which gathers what DTensor cannot
carry through a view, ``attn_sp`` constrains the queries, and the core
(scores, mask, softmax, the weighted sum) runs on each device's local
shards (``run_local``), so DTensor never plans a layout for the einsums'
flattened (batch, heads) axis. On plain tensors each is the plain op.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ..sharding.placement import (
    WHOLE,
    batch_spans_axes,
    einsum,
    is_sharded,
    reshape,
    run_local,
    with_sharding_constraint,
)
from ..sharding.rules import P, data_axes
from .layers import dense_init, index_scalar, rope

__all__ = ["attn_init", "attn_apply", "attn_init_cache", "attn_decode"]

NEG = -1e9


# -----------------------------------------------------------------------------
# init
# -----------------------------------------------------------------------------

def attn_init(generator, cfg, device=None) -> Dict:
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads

    def w(*shape):
        return dense_init(generator, shape, device=device)

    if cfg.attention_type == "mla":
        rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return {
            "w_dq": w(d, rq),
            "w_uq": w(rq, h, dn + dr),
            "w_dkv": w(d, rkv),
            "w_kr": w(d, dr),  # shared rope key
            "w_uk": w(rkv, h, dn),
            "w_uv": w(rkv, h, dv),
            "w_o": w(h, dv, d),
        }
    return {
        "w_q": w(d, h, dh),
        "w_k": w(d, hkv, dh),
        "w_v": w(d, hkv, dh),
        "w_o": w(h, dh, d),
    }


# -----------------------------------------------------------------------------
# masks
# -----------------------------------------------------------------------------

def _mask(cfg, s_q: int, s_k: int, device, q_offset: int = 0) -> torch.Tensor:
    qpos = torch.arange(s_q, device=device)[:, None] + q_offset
    kpos = torch.arange(s_k, device=device)[None, :]
    m = kpos <= qpos  # causal
    if cfg.attention_type in ("swa", "local") and cfg.window:
        m &= kpos > qpos - cfg.window
    if cfg.prefix_lm and cfg.n_prefix:
        m |= (qpos < cfg.n_prefix) & (kpos < cfg.n_prefix)  # bidirectional prefix
    return m


# The attention core (scores, mask, softmax, the weighted sum) on a mesh runs
# on each device's local shards (``run_local``). Its axes: b batch, s query
# rows, t key rows, h query heads, g KV heads, d the q.k contraction, e the
# value features. Each mesh dimension splits the batch, the heads (query and
# KV heads together, or the query heads alone where the KV heads do not
# divide), the query rows, or the contraction (then the scores are summed
# across it), or none; DTensor never sees the einsums' (b, h) batch axis.
_CORE_MODES = ("b", "hg", "h", "s", "de")
_QKV = ("bshd", "btgd", "btge")


def _core(fn, operands, *how):
    """``fn`` on local shards (``run_local(fn, operands, *how)``) where the
    operands are DTensors on a mesh whose batch spans two axes ("pod",
    "data"): there DTensor's propagation of the einsums' flattened
    (batch, heads) axis plans every layout through a strided shard, minutes
    an operation. Elsewhere ``fn`` runs on the operands as they are: on a
    2-D mesh DTensor's own propagation lays the core out, as it always has."""
    mesh = next((t.device_mesh for t in operands if is_sharded(t)), None)
    if mesh is None or not batch_spans_axes(mesh):
        return fn(WHOLE, *operands)
    return run_local(fn, operands, *how)


def _core_judge(mode, sizes, split, extent):
    """Whether ``mode`` fits, and the bytes it adds inside the core."""
    if mode == "hg":
        return split["h"] == split["g"], 0
    if mode == "h":  # each device's query heads read a slice of the KV heads
        if split["g"] > 1 or split["h"] > 1:
            return False, 0
        local, rep = sizes["h"] // extent, sizes["h"] // sizes["g"]
        return local % rep == 0 or rep % local == 0, 0
    if mode == "de":  # an all-reduce of the f32 scores
        shards = split["b"] * split["h"] * split["s"]
        return True, sizes["b"] * sizes["h"] * sizes["s"] * sizes["t"] * 4 // shards
    return True, 0


def _kv_for(sh, h: int, k, v):
    """The KV heads that this device's ``h`` query heads read: all it holds,
    or (the query heads split where the KV heads are whole) their groups'."""
    hs, h_all = sh.span("h", h)
    gs, g_all = sh.span("g", k.shape[2])
    rep = h_all // g_all
    g0, gn = hs // rep, max(1, h // rep)
    if (g0, gn) == (gs, k.shape[2]):
        return k, v
    return k[:, :, g0 - gs : g0 - gs + gn], v[:, :, g0 - gs : g0 - gs + gn]


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q: (B,S,H,Dh), k/v: (B,T,Hkv,Dh[v]) with H % Hkv == 0."""
    return _core(_sdpa_local, (q, k, v, mask), _QKV + ("st",), ("bshe",), _CORE_MODES, _core_judge, "de")


def _sdpa_local(sh, q, k, v, mask):
    b, s, h, dh = q.shape
    k, v = _kv_for(sh, h, k, v)
    hkv = k.shape[2]
    rep = h // hkv
    qg = reshape(q, b, s, hkv, rep, dh)
    scores = sh.psum(einsum("bshrd,bthd->bhrst", qg, k).float())
    scores = scores / math.sqrt(sh.span("d", dh)[1])
    scores = torch.where(mask, scores, NEG)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = einsum("bhrst,bthd->bshrd", p, v)
    return out.reshape(b, s, h, v.shape[-1])


def _mask_chunk(cfg, s_q: int, t0: int, c: int, device) -> torch.Tensor:
    """(s_q, c) mask for key columns [t0, t0+c) — never materializes SxT."""
    qpos = torch.arange(s_q, device=device)[:, None]
    kpos = t0 + torch.arange(c, device=device)[None, :]
    m = kpos <= qpos
    if cfg.attention_type in ("swa", "local") and cfg.window:
        m &= kpos > qpos - cfg.window
    if cfg.prefix_lm and cfg.n_prefix:
        m |= (qpos < cfg.n_prefix) & (kpos < cfg.n_prefix)
    return m


def _sdpa_chunked(cfg, q, kv_fn: Callable, n_t: int) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``cfg.attn_chunk``: only
    (B,H,S,chunk) score tiles are live.

    ``kv_fn(t0, c) -> (k_chunk, v_chunk)`` lets MLA build per-head K/V from
    the latent chunk on the fly (never materializing the full per-head K).
    On a mesh each chunk's step runs on local shards, the running max, sum
    and accumulator passed from one chunk's step to the next.
    """
    b, s, h, dh = q.shape
    chunk = min(cfg.attn_chunk, n_t)
    n_chunks = (n_t + chunk - 1) // chunk
    m = torch.full((b, h, s), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = None
    for ci in range(n_chunks):
        t0 = ci * chunk
        c = min(chunk, n_t - t0)
        k_c, v_c = kv_fn(t0, c)  # (B,c,Hkv,dh), (B,c,Hkv,dv)
        msk = _mask_chunk(cfg, s, t0, c, q.device)
        m, l, acc = _core(_chunk_local, (q, k_c, v_c, msk, m, l, acc), _QKV + ("st", "bhs", "bhs", "bshe"),
                              ("bhs", "bhs", "bshe"), _CORE_MODES, _core_judge, "de")
    den = l.permute(0, 2, 1)[..., None]  # (B,S,H,1)
    return (acc / torch.clamp(den, min=1e-20).to(acc.dtype)).to(q.dtype)


def _chunk_local(sh, q, k_c, v_c, msk, m, l, acc):
    """One KV chunk of :func:`_sdpa_chunked` on local tensors."""
    b, s, h, dh = q.shape
    c = k_c.shape[1]
    k_c, v_c = _kv_for(sh, h, k_c, v_c)
    hkv = k_c.shape[2]
    rep = h // hkv
    qg = reshape(q, b, s, hkv, rep, dh)
    sc = sh.psum(einsum("bshrd,bthd->bhrst", qg, k_c).float())
    sc = sc.reshape(b, h, s, c) / math.sqrt(sh.span("d", dh)[1])
    sc = torch.where(msk, sc, -math.inf)
    m_new = torch.maximum(m, sc.amax(dim=-1))
    # fully-masked-so-far rows (e.g. SWA rows before their window) keep
    # m = -inf; shift against a safe max so exp never sees inf - inf
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    alpha = torch.exp(m - m_safe)
    p = torch.exp(sc - m_safe[..., None])
    l = l * alpha + p.sum(dim=-1)
    pv = einsum(
        "bhrst,bthd->bshrd", p.reshape(b, hkv, rep, s, c).to(q.dtype), v_c
    ).reshape(b, s, h, v_c.shape[-1])
    if acc is None:
        acc = pv * 0.0
    acc = acc * alpha.permute(0, 2, 1)[..., None].to(q.dtype) + pv
    return m_new, l, acc


# -----------------------------------------------------------------------------
# forward (train / prefill)
# -----------------------------------------------------------------------------

def _sp_constrain(cfg, q: torch.Tensor) -> torch.Tensor:
    """Sequence-parallel attention: shard query rows over "model". Rescues
    archs whose head count doesn't divide the model axis (phi3 40H,
    minicpm3 40H, musicgen 24H on a 16-way axis), where the (B,H,S,S) score
    temporaries are otherwise replicated on every device (§Perf). Only a
    DTensor on a mesh is constrained."""
    if not cfg.attn_sp:
        return q
    return with_sharding_constraint(q, lambda mesh: P(data_axes(mesh), "model", None, None))


def attn_apply(
    params: Dict,
    cfg,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    dt = x.dtype
    s = x.shape[1]
    if cfg.attention_type == "mla":
        return _mla_apply(params, cfg, x, positions, return_cache)
    q = einsum("bsd,dhk->bshk", x, params["w_q"].to(dt))
    k = einsum("bsd,dhk->bshk", x, params["w_k"].to(dt))
    v = einsum("bsd,dhk->bshk", x, params["w_v"].to(dt))
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    q = _sp_constrain(cfg, q)
    if cfg.attn_impl == "chunked":
        out = _sdpa_chunked(cfg, q, lambda t0, c: (k[:, t0 : t0 + c], v[:, t0 : t0 + c]), s)
    else:
        out = _sdpa(q, k, v, _mask(cfg, s, s, x.device))
    y = einsum("bshk,hkd->bsd", out, params["w_o"].to(dt))
    cache = _cache_from_prefill(cfg, k, v, s) if return_cache else None
    return y, cache


def _mla_apply(params, cfg, x, positions, return_cache):
    dt = x.dtype
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    h = cfg.n_heads
    cq = x @ params["w_dq"].to(dt)  # (B,S,rq)
    q = einsum("bsr,rhk->bshk", cq, params["w_uq"].to(dt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    ckv = x @ params["w_dkv"].to(dt)  # (B,S,rkv) — the latent
    kr = (x @ params["w_kr"].to(dt))[:, :, None, :]  # (B,S,1,dr) shared key
    kr = rope(kr, positions, cfg.rope_theta)
    qc = _sp_constrain(cfg, torch.cat([q_nope, q_rope], dim=-1))
    if cfg.attn_impl == "chunked":
        # per-head K/V from the latent chunk on the fly: the full
        # (B,S,H,dn+dr) K is never materialized
        def kv_chunk(t0, c):
            ckv_c = ckv[:, t0 : t0 + c]
            k_nope_c = einsum("bsr,rhk->bshk", ckv_c, params["w_uk"].to(dt))
            v_c = einsum("bsr,rhk->bshk", ckv_c, params["w_uv"].to(dt))
            kr_c = kr[:, t0 : t0 + c].expand(b, c, h, dr)
            return torch.cat([k_nope_c, kr_c], dim=-1), v_c

        out = _sdpa_chunked(cfg, qc, kv_chunk, s)
    else:
        k_nope = einsum("bsr,rhk->bshk", ckv, params["w_uk"].to(dt))
        v = einsum("bsr,rhk->bshk", ckv, params["w_uv"].to(dt))
        k = torch.cat([k_nope, kr.expand(b, s, h, dr)], dim=-1)
        out = _sdpa(qc, k, v, _mask(cfg, s, s, x.device))
    y = einsum("bshk,hkd->bsd", out, params["w_o"].to(dt))
    cache = None
    if return_cache:
        cache = {"ckv": ckv, "kr": kr[:, :, 0, :], "idx": index_scalar(s, x.device)}
    return y, cache


# -----------------------------------------------------------------------------
# decode caches
# -----------------------------------------------------------------------------

def attn_init_cache(cfg, batch: int, max_len: int, dtype, device=None) -> Dict:
    """Zero caches (``device="meta"`` builds shapes only)."""
    dh = cfg.resolved_head_dim

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.attention_type == "mla":
        return {
            "ckv": zeros((batch, max_len, cfg.kv_lora_rank), dtype),
            "kr": zeros((batch, max_len, cfg.qk_rope_dim), dtype),
            "idx": zeros((), torch.int32),
        }
    cap = min(max_len, cfg.window) if cfg.attention_type in ("swa", "local") and cfg.window else max_len
    if cfg.kv_quant:
        # int8 symmetric quantization, one scale per (batch, pos, kv-head)
        return {
            "k": zeros((batch, cap, cfg.n_kv_heads, dh), torch.int8),
            "v": zeros((batch, cap, cfg.n_kv_heads, dh), torch.int8),
            "k_scale": zeros((batch, cap, cfg.n_kv_heads), torch.bfloat16),
            "v_scale": zeros((batch, cap, cfg.n_kv_heads), torch.bfloat16),
            "idx": zeros((), torch.int32),
        }
    return {
        "k": zeros((batch, cap, cfg.n_kv_heads, dh), dtype),
        "v": zeros((batch, cap, cfg.n_kv_heads, dh), dtype),
        "idx": zeros((), torch.int32),
    }


def _quantize_kv(x):
    """x: (B,1,H,dh) -> int8 values + bf16 scale per (B,1,H). ``torch.round``
    rounds half to even, as ``jnp.round``."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _cache_from_prefill(cfg, k, v, s):
    if cfg.attention_type in ("swa", "local") and cfg.window and s > cfg.window:
        k, v = k[:, -cfg.window :], v[:, -cfg.window :]
    return {"k": k, "v": v, "idx": index_scalar(s, k.device)}


def _put(buf: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """``dynamic_update_slice(buf, new, (0, start, 0...))`` for a one-row
    ``new``, out of place; ``start`` is a 0-dim tensor already in range."""
    return buf.index_copy(1, start.reshape(1).long(), new)


def attn_decode(params: Dict, cfg, x: torch.Tensor, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: x (B, 1, D) against the cache."""
    dt = x.dtype
    b = x.shape[0]
    idx = cache["idx"]
    pos = idx.reshape(1, 1).expand(b, 1)
    if cfg.attention_type == "mla":
        return _mla_decode(params, cfg, x, cache, pos)
    q = einsum("bsd,dhk->bshk", x, params["w_q"].to(dt))
    k_new = einsum("bsd,dhk->bshk", x, params["w_k"].to(dt))
    v_new = einsum("bsd,dhk->bshk", x, params["w_v"].to(dt))
    q = rope(q, pos, cfg.rope_theta, cfg.rope_fraction)
    k_new = rope(k_new, pos, cfg.rope_theta, cfg.rope_fraction)

    cap = cache["k"].shape[1]
    slot = torch.remainder(idx, cap)  # ring for swa/local; flat when cap == max_len
    if cfg.kv_quant:
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        kc = _put(cache["k"], kq, slot)
        vc = _put(cache["v"], vq, slot)
        ksc = _put(cache["k_scale"], ks, slot)
        vsc = _put(cache["v_scale"], vs, slot)
        k = kc.to(dt) * ksc[..., None].to(dt)
        v = vc.to(dt) * vsc[..., None].to(dt)
        new_cache = {"k": kc, "v": vc, "k_scale": ksc, "v_scale": vsc, "idx": idx + 1}
    else:
        k = _put(cache["k"], k_new, slot)
        v = _put(cache["v"], v_new, slot)
        new_cache = {"k": k, "v": v, "idx": idx + 1}

    kpos_abs = torch.arange(cap, device=x.device)
    n_seen = idx + 1
    if cfg.attention_type in ("swa", "local") and cfg.window and cap == cfg.window:
        valid = kpos_abs < torch.clamp(n_seen, max=cap)  # whole ring once warm
    else:
        valid = kpos_abs < n_seen
    mask = valid[None, :]  # (1, cap) -> broadcast (s_q=1)

    if cfg.decode_score_dtype == "bf16":
        out = _sdpa_decode_bf16(q, k, v, mask)
    else:
        out = _sdpa(q, k, v, mask)
    y = einsum("bshk,hkd->bsd", out, params["w_o"].to(dt))
    return y, new_cache


def _sdpa_decode_bf16(q, k, v, mask):
    """The reference's ``decode_score_dtype="bf16"`` route: an additive mask
    and a hand-written softmax. Its scores are divided by a NumPy float64
    ``sqrt(dh)``, which JAX promotes to f32, so they are f32 here too."""
    return _core(_decode_bf16_local, (q, k, v, mask), _QKV + ("st",), ("bshe",), _CORE_MODES, _core_judge,
                     "de")


def _decode_bf16_local(sh, q, k, v, mask):
    b, s, h, dh = q.shape
    k, v = _kv_for(sh, h, k, v)
    hkv = k.shape[2]
    rep = h // hkv
    qg = reshape(q, b, s, hkv, rep, dh)
    scores = sh.psum(einsum("bshrd,bthd->bhrst", qg, k).float()) / math.sqrt(sh.span("d", dh)[1])
    addmask = torch.where(mask, 0.0, NEG).to(scores.dtype)
    scores = scores + addmask
    m = torch.amax(scores, dim=-1, keepdim=True)
    ex = torch.exp((scores - m).float()).to(scores.dtype)
    den = torch.sum(ex.float(), dim=-1, keepdim=True)
    p = (ex / den.to(ex.dtype)).to(q.dtype)
    out = einsum("bhrst,bthd->bshrd", p, v)
    return out.reshape(b, s, h, v.shape[-1])


def _mla_decode(params, cfg, x, cache, pos):
    dt = x.dtype
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    idx = cache["idx"]
    cq = x @ params["w_dq"].to(dt)
    q = einsum("bsr,rhk->bshk", cq, params["w_uq"].to(dt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, pos, cfg.rope_theta)

    ckv_new = x @ params["w_dkv"].to(dt)  # (B,1,rkv)
    kr_new = rope((x @ params["w_kr"].to(dt))[:, :, None, :], pos, cfg.rope_theta)[:, :, 0, :]
    # dynamic_update_slice clamps the start: at idx >= cap the last row is
    # overwritten (finding (a) of the reference; reproduced, not repaired)
    start = torch.clamp(idx, max=cache["ckv"].shape[1] - 1)
    ckv = _put(cache["ckv"], ckv_new, start)
    kr = _put(cache["kr"], kr_new, start)

    # absorb the up-projections into the query side (the MLA decode trick):
    # score = q_nope . (ckv W_uk) + q_rope . kr  ==  (q_nope W_uk^T) . ckv + ...
    q_lat = einsum("bshk,rhk->bshr", q_nope, params["w_uk"].to(dt))
    valid = torch.arange(ckv.shape[1], device=x.device) < (idx + 1)
    ctx = _core(functools.partial(_mla_core_local, math.sqrt(dn + dr)), (q_lat, q_rope, ckv, kr, valid),
                    ("bshr", "bshk", "btr", "btk", "t"), ("bshr",), _MLA_MODES, _mla_judge, "rk")
    out = einsum("bshr,rhk->bshk", ctx, params["w_uv"].to(dt))
    y = einsum("bshk,hkd->bsd", out, params["w_o"].to(dt))
    return y, {"ckv": ckv, "kr": kr, "idx": idx + 1}


# MLA decode's latent-space core: b batch, s the query, t cache rows, h heads,
# r the latent rank, k the shared RoPE key; a mesh dimension splits the
# batch, the heads, or both contractions (the scores summed across it)
_MLA_MODES = ("b", "h", "rk")


def _mla_judge(mode, sizes, split, extent):
    if mode == "rk":
        return True, sizes["b"] * sizes["h"] * sizes["s"] * sizes["t"] * 4 // (split["b"] * split["h"])
    return True, 0


def _mla_core_local(scale, sh, q_lat, q_rope, ckv, kr, valid):
    s_lat = einsum("bshr,btr->bhst", q_lat, ckv)
    s_rope = einsum("bshk,btk->bhst", q_rope, kr)
    scores = sh.psum((s_lat + s_rope).float()) / scale
    scores = torch.where(valid, scores, NEG)
    p = torch.softmax(scores, dim=-1).to(q_lat.dtype)
    return einsum("bhst,btr->bshr", p, ckv)  # context in latent space
