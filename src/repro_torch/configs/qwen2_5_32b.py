"""Qwen2.5-32B [hf:Qwen/Qwen2.5-0.5B family card]: 64L d=5120 40H (GQA kv=8)
d_ff=27648, vocab 152064, QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                       d_ff=512, vocab_size=512)
