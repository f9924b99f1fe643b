"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified]: 38 blocks,
d=4096, 16H MQA (kv=1) on the attention layers, d_ff=12288, vocab=256000,
RG-LRU recurrent blocks : local attention (window 2048) in a 2:1 pattern.
38 % 3 != 0, so the pattern is expressed as a period-19 cycle
(R,R,A)x6 + R — same 2:1 ratio, 2 scan groups (documented deviation).
Recurrent state + windowed attention => long_500k-capable."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("R", "R", "A") * 6 + ("R",),
    attention_type="local",
    window=2048,
    ffn_type="swiglu",
    rnn_width=4096,
    subquadratic=True,
)
