"""Jamba-v0.1-52B [arXiv:2403.19887] — hybrid Mamba+attention 1:7, MoE 16e top-2.

Pattern period 8: attention at layer index 4 of each period (attn_offset=4),
Mamba elsewhere; MoE every other layer (odd indices).  Mamba sub-config per
the Jamba paper: d_state 16, expand 2, conv 4 (SSD-form heads at head_dim 64
— TPU adaptation noted in DESIGN.md).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    moe_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
)
