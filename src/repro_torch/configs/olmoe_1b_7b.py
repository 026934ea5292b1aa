"""OLMoE-1B-7B [arXiv:2409.02060] — MoE 64 experts, top-8, expert d_ff=1024."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,              # per-expert hidden
    vocab=50304,
    moe_experts=64,
    moe_top_k=8,
    moe_d_ff=1024,
)
