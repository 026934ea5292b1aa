"""Granite-8B-code [arXiv:2405.04324] — llama-arch dense, GQA kv=8."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
)
