"""Granite-3.0-8B [hf:ibm-granite/granite-3.0 family] — dense, GQA kv=8."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    tie_embeddings=True,    # granite-3 ties embeddings
)
