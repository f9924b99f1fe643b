"""MusicGen-medium [arXiv:2306.05284; hf]: 48L decoder over EnCodec tokens,
d=1536, 24H MHA (kv=24), d_ff=6144, vocab=2048 (per-codebook). The EnCodec
audio frontend is a STUB per the assignment: input_specs provides precomputed
frame embeddings; the LM backbone predicts codebook tokens."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    attention_type="full",
    ffn_type="gelu",
    norm_type="layernorm",
    input_mode="embeddings",
    subquadratic=False,
)
