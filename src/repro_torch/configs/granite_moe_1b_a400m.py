"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] —
MoE 32 experts, top-8, expert d_ff=512, every layer MoE."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,               # per-expert hidden
    vocab=49155,
    moe_experts=32,
    moe_top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
)
