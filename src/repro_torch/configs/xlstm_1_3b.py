"""xLSTM 1.3B [arXiv:2405.04517; unverified]: 48 blocks, d=2048, 4 heads,
sLSTM + mLSTM mix (1 sLSTM per 8 blocks ~= the paper's 7:1 mLSTM:sLSTM).
d_ff=0: xLSTM blocks carry their own up/down projections. Pure recurrent
state decode => long_500k-capable."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("S", "M", "M", "M", "M", "M", "M", "M"),
    ffn_type="none",
    subquadratic=True,
)
