"""PaliGemma-3B [arXiv:2407.07726; hf]: SigLIP vision frontend (STUB —
input_specs provides 256 precomputed patch embeddings) + an 18L Gemma-style
decoder, d=2048, 8H MQA (kv=1), d_ff=16384, vocab=257216, prefix-LM masking
over the image prefix, tied embeddings."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    attention_type="full",
    ffn_type="swiglu",  # Gemma's GeGLU ~ gated MLP (documented approximation)
    input_mode="embeddings",
    prefix_lm=True,
    n_prefix=256,
    tie_embeddings=True,
    subquadratic=False,
)
