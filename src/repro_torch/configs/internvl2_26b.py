"""InternVL2-26B [arXiv:2404.16821] — VLM: InternViT frontend (STUB) +
InternLM2-20B language backbone (48L d=6144 48H kv=8 d_ff=16384 vocab=92553).

The ViT frontend is a STUB per the brief: ``input_specs()`` supplies 1024
precomputed patch embeddings [B, 1024, d] concatenated ahead of the text
tokens (DESIGN.md §4).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    frontend="patch_embed",
    frontend_tokens=1024,
)
