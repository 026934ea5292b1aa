"""Mamba2-130M [arXiv:2405.21060] — attention-free SSD (state-space duality).

d_inner = 2·768 = 1536, head_dim 64 → 24 SSD heads, d_state 128, chunk 256.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,              # attention-free
    d_ff=0,                 # no FFN blocks in mamba2
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
