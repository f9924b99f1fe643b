"""Snowflake Arctic (480B total) [hf:Snowflake/snowflake-arctic-base; hf]:
35L, d=7168, 56H (GQA kv=8), MoE d_ff=4864 with 128 experts top-2 PLUS a
dense residual FFN in parallel (Arctic's dense-MoE hybrid). Full attention
=> long_500k skipped (DESIGN.md)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    attention_type="full",
    ffn_type="moe",
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    subquadratic=False,
)
