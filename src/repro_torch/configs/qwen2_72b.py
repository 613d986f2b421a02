"""Qwen2-72B [arXiv:2407.10671]: 80L d=8192 64H (GQA kv=8) d_ff=29568,
vocab 152064, QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                       d_ff=512, vocab_size=512)
