"""TransformerLM: the ten architectures from one skeleton.

A port of ``repro.models.lm``. Pre-norm residual blocks; the per-layer
sequence mixer is selected by ``cfg.block_pattern`` ("A" attention, "R"
RG-LRU, "M" mLSTM, "S" sLSTM); attention and RG-LRU blocks are followed by
an FFN (swiglu / gelu / MoE), xLSTM blocks carry their projections inside
the mixer.

Parameters are the reference's tree: layers grouped by pattern position and
stacked along a leading group axis, f32 master weights cast to the compute
dtype at each call. The port walks the groups in a Python loop (the
reference's ``scan_layers=False`` path), each group under activation
checkpointing when ``cfg.remat``. :class:`TransformerLM` registers
the same tree in an ``nn.Module``; the functional entry points stay the
reference's.

On a mesh (DTensor parameters and batches) the same code runs sharded:
the vocab-sharded embedding's partial sum is reduced where it is made, and
``constrain_acts`` pins the residual stream to the batch layout.

Modality frontends (paligemma's SigLIP, musicgen's EnCodec) are stubs, as in
the reference: ``batch["embeds"]`` carries precomputed patch/frame
embeddings.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import resolve_device
from ..sharding.placement import einsum, on_merged_batch, reduce_partial, with_sharding_constraint
from ..sharding.rules import P, data_axes
from . import attention as attn
from . import recurrent as rec
from .layers import apply_mlp, apply_norm, dense_init, mlp_init, norm_init
from .moe import moe_apply, moe_init

__all__ = [
    "TransformerLM",
    "init_params",
    "abstract_params",
    "forward",
    "loss_fn",
    "init_caches",
    "decode_step",
    "count_params_analytic",
    "tree_items",
    "tree_map",
    "tree_unflatten",
]


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _device(device) -> torch.device:
    """``resolve_device``, plus ``"meta"`` for shape-only trees."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _has_ffn(cfg, kind: str) -> bool:
    return kind in ("A", "R") and cfg.ffn_type != "none" and cfg.d_ff > 0


def tree_items(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict, paths joined by ``.``, keys in
    sorted order (the order JAX flattens a dict in)."""
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from tree_items(value, path + ".")
        else:
            yield path, value


def tree_unflatten(like: Dict, leaves) -> Dict:
    """A nested dict shaped like ``like`` whose leaves, in :func:`tree_items`
    order, are ``leaves``."""
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) for k in sorted(node)} if isinstance(node, dict) else next(it)

    return build(like)


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


# =============================================================================
# init
# =============================================================================

def _block_init(generator, cfg, kind: str, device) -> Dict:
    p: Dict = {"norm1": norm_init(cfg.d_model, device)}
    if kind == "A":
        p["mixer"] = attn.attn_init(generator, cfg, device)
    elif kind == "R":
        p["mixer"] = rec.rglru_init(generator, cfg, device)
    elif kind == "M":
        p["mixer"] = rec.mlstm_init(generator, cfg, device)
    elif kind == "S":
        p["mixer"] = rec.slstm_init(generator, cfg, device)
    else:
        raise ValueError(kind)
    if _has_ffn(cfg, kind):
        p["norm2"] = norm_init(cfg.d_model, device)
        if cfg.ffn_type == "moe":
            p["ffn"] = moe_init(generator, cfg, device)
        else:
            p["ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.ffn_type, device)
    return p


def _build_params(cfg, generator: Optional[torch.Generator], device: torch.device) -> Dict:
    period, groups = cfg.pattern_period, cfg.n_groups
    layers: Dict[str, Dict] = {}
    for pos in range(period):
        kind = cfg.block_pattern[pos]
        per_group = [_block_init(generator, cfg, kind, device) for _ in range(groups)]
        layers[str(pos)] = tree_map(lambda *xs: torch.stack(xs), *per_group)
        del per_group
    params = {
        "layers": layers,
        "final_norm": norm_init(cfg.d_model, device),
        "embed": dense_init(generator, (cfg.vocab_size, cfg.d_model), scale=0.02, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size), device=device)
    return params


def init_params(cfg, generator: Optional[torch.Generator] = None, device=None) -> Dict:
    """Random parameters on ``device`` (``"cuda"`` unless asked otherwise;
    raises without a card). Draws come from ``generator`` (default: a fresh
    one on ``device`` seeded with 0), on the generator's device."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _build_params(cfg, generator, dev)


def abstract_params(cfg) -> Dict:
    """The parameter tree on the ``meta`` device: shapes and dtypes only."""
    return _build_params(cfg, None, torch.device("meta"))


class _Tree(nn.Module):
    """A nested dict of tensors registered as parameters, one submodule per
    inner dict, so ``state_dict`` keys are the tree's paths joined by ``.``."""

    def __init__(self, tree: Dict):
        super().__init__()
        self._keys = list(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, _Tree(value))
            else:
                self.register_parameter(key, nn.Parameter(value, requires_grad=False))

    def as_dict(self) -> Dict:
        return {
            key: self._modules[key].as_dict() if key in self._modules else self._parameters[key]
            for key in self._keys
        }


class TransformerLM(_Tree):
    """The parameter tree as an ``nn.Module``: ``state_dict`` keys are the
    tree's paths (``layers.0.mixer.w_q``), ``.to(device)`` moves it, and
    :attr:`params` gives the tree back for the functional entry points.
    Parameters do not require grad: ``repro_torch.train`` takes gradients
    of the functional entry points over the tree (:attr:`params`)."""

    def __init__(self, cfg, params: Optional[Dict] = None, generator=None, device=None):
        super().__init__(init_params(cfg, generator, device) if params is None else params)
        self.cfg = cfg

    @property
    def params(self) -> Dict:
        return self.as_dict()

    def forward(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        return forward(self.cfg, self.params, batch)


# =============================================================================
# forward
# =============================================================================

def _constrain(cfg, x):
    """Optional residual-stream sharding constraint: batch over DP axes,
    features replicated — pins the residual stream so attention-internal
    shardings don't leak into it (a §Perf lever). Only a DTensor on a mesh
    is constrained."""
    if not cfg.constrain_acts:
        return x
    return with_sharding_constraint(x, lambda mesh: P(data_axes(mesh), None, None))


def _apply_block(cfg, p, kind, x, positions, return_cache=False):
    x = _constrain(cfg, x)
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    if kind == "A":
        mixed, cache = attn.attn_apply(p["mixer"], cfg, h, positions, return_cache)
    elif kind == "R":
        mixed, cache = rec.rglru_apply(p["mixer"], cfg, h, positions, return_cache)
    else:  # xLSTM: on a multi-pod mesh, its head views and time loop plan on a 2-D mesh
        mixer = rec.mlstm_apply if kind == "M" else rec.slstm_apply
        mixed, cache = on_merged_batch(mixer, p["mixer"], cfg, h, positions, return_cache)
    x = x + mixed
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _has_ffn(cfg, kind):
        h2 = apply_norm(p["norm2"], x, cfg.norm_type)
        if cfg.ffn_type == "moe":
            y, aux = on_merged_batch(moe_apply, p["ffn"], cfg, h2)
        else:
            y = apply_mlp(p["ffn"], h2, cfg.ffn_type)
        x = x + y
    return x, aux, cache


def _embed_inputs(cfg, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = _dtype(cfg)
    parts = []
    if batch.get("embeds") is not None:
        parts.append(batch["embeds"].to(dt))
    if batch.get("tokens") is not None:
        parts.append(reduce_partial(F.embedding(batch["tokens"].long(), params["embed"])).to(dt))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return x, positions


def _group(tree: Dict, g: int) -> Dict:
    return tree_map(lambda t: t[g], tree)


def _head(cfg, params, x) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head.to(x.dtype)).float()


def _group_body(cfg, gp, x, aux, positions):
    for pos in range(cfg.pattern_period):
        x, a, _ = _apply_block(cfg, gp[str(pos)], cfg.block_pattern[pos], x, positions)
        aux = aux + a
    return x, aux


def forward(cfg, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits, aux_loss).

    With ``cfg.remat`` and grad mode on, each layer group's activations are
    recomputed in backward instead of kept (the reference's
    ``jax.checkpoint`` of the group body): memory changes, values do not."""
    x, positions = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    # one view per group of each stacked leaf; in backward the groups'
    # gradients are stacked once (indexing each group would add a zero-padded
    # full-size gradient per group and leaf)
    groups = tree_map(lambda t: t.unbind(0), params["layers"])
    for g in range(cfg.n_groups):
        gp = tree_map(lambda views: views[g], groups)
        if remat:
            x, aux = checkpoint(_group_body, cfg, gp, x, aux, positions, use_reentrant=False)
        else:
            x, aux = _group_body(cfg, gp, x, aux, positions)
    return _head(cfg, params, x), aux


def loss_fn(cfg, params, batch) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy; labels < 0 are masked (e.g. image prefix)."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    # logits may cover prefix positions that have no labels: align to the tail
    s_lab = labels.shape[1]
    logits = logits[:, -s_lab:]
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0).long()
    if cfg.ce_impl == "einsum":
        # contract the vocab axis with a one-hot (logsumexp partial reductions)
        lse = torch.logsumexp(logits, dim=-1)
        onehot = F.one_hot(safe, logits.shape[-1]).to(logits.dtype)
        target = einsum("bsv,bsv->bs", logits, onehot)
        nll = lse - target
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = loss + 0.01 * aux
    return total, {"ce": loss, "aux": aux}


# =============================================================================
# decode
# =============================================================================

def _mixer_cache_init(cfg, kind, batch, max_len, dtype, device):
    if kind == "A":
        return attn.attn_init_cache(cfg, batch, max_len, dtype, device)
    if kind == "R":
        return rec.rglru_init_cache(cfg, batch, max_len, dtype, device)
    if kind == "M":
        return rec.mlstm_init_cache(cfg, batch, max_len, dtype, device)
    return rec.slstm_init_cache(cfg, batch, max_len, dtype, device)


def init_caches(cfg, batch: int, max_len: int, device=None) -> Dict:
    """Stacked (per pattern position, leading group axis) zero decode caches
    on ``device`` (``"cuda"`` unless asked otherwise; ``"meta"`` for shapes)."""
    dev = _device(device)
    caches: Dict[str, Dict] = {}
    for pos in range(cfg.pattern_period):
        one = _mixer_cache_init(cfg, cfg.block_pattern[pos], batch, max_len, _dtype(cfg), dev)
        caches[str(pos)] = tree_map(lambda t: t.expand((cfg.n_groups,) + tuple(t.shape)).clone(), one)
    return caches


def _decode_block(cfg, p, kind, x, cache):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    if kind == "A":
        mixed, new = attn.attn_decode(p["mixer"], cfg, h, cache)
    elif kind == "R":
        mixed, new = rec.rglru_decode(p["mixer"], cfg, h, cache)
    elif kind == "M":
        mixed, new = rec.mlstm_decode(p["mixer"], cfg, h, cache)
    else:
        mixed, new = rec.slstm_decode(p["mixer"], cfg, h, cache)
    x = x + mixed
    if _has_ffn(cfg, kind):
        h2 = apply_norm(p["norm2"], x, cfg.norm_type)
        if cfg.ffn_type == "moe":
            y, _ = on_merged_batch(moe_apply, p["ffn"], cfg, h2)
        else:
            y = apply_mlp(p["ffn"], h2, cfg.ffn_type)
        x = x + y
    return x, new


def decode_step(cfg, params, caches, batch) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. batch: {"tokens": (B, 1)} or {"embeds": (B, 1, D)}.

    Returns (logits (B, 1, V), new caches); the caches passed in are not
    modified.
    """
    x, _ = _embed_inputs(cfg, params, batch)
    outs = []
    for g in range(cfg.n_groups):
        gp, gc = _group(params["layers"], g), _group(caches, g)
        new_caches = {}
        for pos in range(cfg.pattern_period):
            x, new_caches[str(pos)] = _decode_block(cfg, gp[str(pos)], cfg.block_pattern[pos], x, gc[str(pos)])
        outs.append(new_caches)
    return _head(cfg, params, x), tree_map(lambda *xs: torch.stack(xs), *outs)


# =============================================================================
# accounting
# =============================================================================

def count_params_analytic(cfg, active_only: bool = False) -> int:
    total = 0
    for path, leaf in tree_items(abstract_params(cfg)):
        n = leaf.numel()
        if active_only and cfg.ffn_type == "moe" and (
            "w_gate" in path or "w_up" in path or "w_down" in path
        ) and "dense_residual" not in path and "ffn" in path:
            n = n * cfg.top_k // max(cfg.n_experts, 1)
        total += n
    return total
