"""Phi-3-medium-14B [arXiv:2404.14219; unverified]: 40L, d=5120, 40H (GQA
kv=10), d_ff=17920, vocab=100352, RoPE, SwiGLU, RMSNorm."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    attention_type="full",
    ffn_type="swiglu",
    subquadratic=False,
)
