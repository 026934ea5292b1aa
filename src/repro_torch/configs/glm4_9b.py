"""GLM4-9B [hf:THUDM/glm-4-9b] — dense, RoPE, extreme GQA (kv=2)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    qkv_bias=True,          # GLM uses qkv bias
)
