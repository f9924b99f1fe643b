"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b; unverified]: 24L, d=2048,
32H MHA (kv=32), d_ff=5632, vocab=100352, partial rotary (25%), LayerNorm."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    attention_type="full",
    ffn_type="swiglu",
    rope_fraction=0.25,
    norm_type="layernorm",
    subquadratic=False,
)
