"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B; hf]: 62L, d=2560, 40H, d_ff=6400,
vocab=73448, Multi-head Latent Attention (q_lora 768, kv_lora 256,
qk_nope 64 + qk_rope 32, v 64). The latent KV cache is tiny (288/token) but
attention is still full => long_500k skipped."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    ffn_type="swiglu",
    subquadratic=False,
)
