"""GLM4-9B [hf:THUDM/glm-4-9b]: 40L d=4096 32H (GQA kv=2) d_ff=13696,
vocab 151552, RoPE."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552, qkv_bias=True, rope_theta=10000.0,
    source="hf:THUDM/glm-4-9b",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                       d_ff=512, vocab_size=512)
