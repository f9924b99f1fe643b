"""Architecture configuration for the model zoo.

A port of ``repro.models.config``: one frozen dataclass drives every
architecture, field for field with the reference and with its defaults, so
the two packages' configs compare equal (``dataclasses.asdict``). A
repeating ``block_pattern`` selects the sequence mixer per layer ("A"
attention / "R" RG-LRU / "M" mLSTM / "S" sLSTM); attention and FFN variants
are switched by fields. ``reduced()`` derives the small same-family
configuration the CPU tests use.

``remat`` is live: with grad mode on, ``forward`` recomputes each layer
group in backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of the group body). The sharding knobs are live on a
mesh: ``mla_shard`` picks ``repro_torch.sharding``'s MLA rules, ``zero1``
shards the AdamW moments over "data" (``repro_torch.train``), and
``constrain_acts`` / ``attn_sp`` redistribute the residual stream / the
attention queries when they are DTensors; on plain tensors they change
nothing. ``scan_layers`` is kept so the configs compare equal and is a
no-op: the port always walks the layer groups in a Python loop (the
reference's ``scan_layers=False`` path).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // n_heads

    # sequence mixer layout: cycled over layers
    block_pattern: Tuple[str, ...] = ("A",)
    attention_type: str = "full"  # full | swa | local | mla
    window: Optional[int] = None  # swa / local window size

    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # FFN
    ffn_type: str = "swiglu"  # swiglu | gelu | moe | none
    n_experts: int = 0
    top_k: int = 2
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    capacity_policy: str = "const"  # const | full | reflex_tlap | reflex_beta

    # recurrent blocks
    rnn_width: Optional[int] = None  # RG-LRU recurrence width (default d_model)
    conv_width: int = 4
    mlstm_chunk: int = 256

    # embeddings / frontend
    input_mode: str = "tokens"  # tokens | embeddings (vlm / audio stub)
    prefix_lm: bool = False  # paligemma: bidirectional prefix attention
    n_prefix: int = 0  # number of prefix positions (image patches)
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # stablelm-2: partial rotary (25%)
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False

    # runtime
    dtype: str = "bfloat16"
    remat: bool = True  # activation checkpointing of each layer group
    scan_layers: bool = True  # no-op here: the groups are walked in a loop
    ce_impl: str = "gather"  # gather | einsum (one-hot contraction CE)
    zero1: bool = True  # AdamW moments also sharded over "data" on a mesh
    moe_impl: str = "einsum"  # einsum | gather (dispatch implementation)
    mla_shard: str = "feature"  # feature | rank (MLA up-projection sharding)
    constrain_acts: bool = False  # pin the residual stream to (dp, None, None)
    decode_score_dtype: str = "f32"  # f32 | bf16 decode attention scores
    kv_quant: bool = False  # int8 KV cache (per-position/head scales)
    attn_impl: str = "dense"  # dense | chunked (online-softmax over KV chunks)
    attn_chunk: int = 2048  # KV chunk for attn_impl="chunked"
    attn_sp: bool = False  # attention queries' sequence axis on "model"
    # whether the arch supports the long_500k shape (sub-quadratic decode)
    subquadratic: bool = False

    # ---------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % self.pattern_period]

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.pattern_period:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {self.pattern_period}"
            )
        return self.n_layers // self.pattern_period

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        from .lm import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from .lm import count_params_analytic

        return count_params_analytic(self, active_only=True)

    # ---------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests."""
        period = self.pattern_period
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        d_model = 64
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=period * 2,
            d_model=d_model,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=0 if self.d_ff == 0 else 96,
            vocab_size=min(self.vocab_size, 256),
            window=min(self.window, 16) if self.window else None,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            rnn_width=64 if self.rnn_width else None,
            mlstm_chunk=16,
            n_prefix=4 if self.n_prefix else 0,
            dtype="float32",
            remat=False,
            scan_layers=False,
        )
