"""The assigned input shapes, as ``meta`` tensors.

A port of ``repro.configs.shapes``: where the reference returns
``jax.ShapeDtypeStruct`` stand-ins, :func:`input_specs` returns tensors on
the ``meta`` device (shape and dtype, no storage). Four shapes per
architecture:

  train_4k    seq 4096,   global_batch 256  -> train step
  prefill_32k seq 32768,  global_batch 32   -> prefill step (forward)
  decode_32k  cache 32768, global_batch 128 -> serve step (1 new token)
  long_500k   cache 524288, global_batch 1  -> serve step; requires
              sub-quadratic decode state => only for archs with
              cfg.subquadratic (mixtral SWA / xlstm / recurrentgemma).

Modality stubs: paligemma gets 256 precomputed patch embeddings
(B, 256, d_model) + text tokens; musicgen gets precomputed EnCodec frame
embeddings (B, S, d_model) + codebook labels.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models import init_caches
from ..models.config import ArchConfig

SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

SHAPE_DEFS = {
    "train_4k": {"seq": 4096, "batch": 256, "step": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "step": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "step": "decode"},
    "long_500k": {"seq": 524288, "batch": 1, "step": "decode"},
}


def shape_applicable(cfg: ArchConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "pure full attention: 500k dense KV decode excluded (DESIGN.md §4)"
    return True, ""


def _bdt(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _token_batch(cfg: ArchConfig, batch: int, seq: int, with_labels: bool) -> Dict:
    """Token / embedding stand-ins for one forward pass of length ``seq``."""
    out: Dict = {}
    if cfg.input_mode == "embeddings":
        if cfg.prefix_lm and cfg.n_prefix:
            # image prefix + text tokens (paligemma)
            s_text = seq - cfg.n_prefix
            out["embeds"] = _spec((batch, cfg.n_prefix, cfg.d_model), _bdt(cfg))
            out["tokens"] = _spec((batch, s_text), torch.int32)
            if with_labels:
                out["labels"] = _spec((batch, s_text), torch.int32)
        else:
            # frame embeddings only (musicgen)
            out["embeds"] = _spec((batch, seq, cfg.d_model), _bdt(cfg))
            if with_labels:
                out["labels"] = _spec((batch, seq), torch.int32)
    else:
        out["tokens"] = _spec((batch, seq), torch.int32)
        if with_labels:
            out["labels"] = _spec((batch, seq), torch.int32)
    return out


def input_specs(cfg: ArchConfig, shape_name: str) -> Dict:
    """Returns {"step": train|prefill|decode, "batch": {...},
    "caches": ... (decode only)} — all ``meta`` tensors, no allocation."""
    d = SHAPE_DEFS[shape_name]
    step, seq, batch = d["step"], d["seq"], d["batch"]
    if step == "train":
        return {"step": "train", "batch": _token_batch(cfg, batch, seq, True)}
    if step == "prefill":
        return {"step": "prefill", "batch": _token_batch(cfg, batch, seq, False)}
    # decode: one new token against a cache of length `seq`
    caches = init_caches(cfg, batch, seq, device="meta")
    if cfg.input_mode == "embeddings" and not (cfg.prefix_lm and cfg.n_prefix):
        tok = {"embeds": _spec((batch, 1, cfg.d_model), _bdt(cfg))}
    else:
        tok = {"tokens": _spec((batch, 1), torch.int32)}
    return {"step": "decode", "batch": tok, "caches": caches}
