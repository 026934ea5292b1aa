"""SeamlessM4T-medium [arXiv:2308.11596] — audio enc-dec backbone.

Modality frontend is a STUB: ``input_specs()`` supplies precomputed frame
embeddings [B, T_enc, d] (T_enc = seq_len/4, DESIGN.md §4); 12 encoder +
12 decoder layers at the paper's listed geometry (12L d=1024 16H kv=16
d_ff=4096 vocab=256206).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder depth
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    frontend="frame_embed",
)
