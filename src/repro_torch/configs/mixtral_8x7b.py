"""Mixtral 8x7B [arXiv:2401.04088; hf]: 32L, d=4096, 32H (GQA kv=8),
d_ff=14336, vocab=32000, MoE 8 experts top-2, sliding-window attention 4096.
SWA bounds the decode KV cache => long_500k-capable."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    attention_type="swa",
    window=4096,
    ffn_type="moe",
    n_experts=8,
    top_k=2,
    rope_theta=1e6,
    subquadratic=True,
)
