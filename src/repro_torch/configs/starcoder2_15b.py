"""StarCoder2-15B [arXiv:2402.19173; hf]: 40L, d=6144, 48H (GQA kv=4),
d_ff=24576, vocab=49152, RoPE, GeLU MLP, LayerNorm."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    attention_type="full",
    ffn_type="gelu",
    norm_type="layernorm",
    subquadratic=False,
)
